"""Build and load the port's CUDA kernels.

The sources in mobilequant_tpu_torch/csrc/ are compiled at first use with
nvcc for sm_90a, one nvcc process per source, all started together, then
linked into build/mqt_kernels/libmqt_kernels.so at the repository root and
loaded with ctypes. Nothing is built when this module is imported, and the
library is only rebuilt when a source is newer than it.

The kernels have a plain C interface: every device pointer, host pointer and
the stream is passed as a c_void_p, and every entry returns the
cudaGetLastError() code of its launch, which `check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "mqt_kernels"
LIB_PATH = BUILD_DIR / "libmqt_kernels.so"
SOURCES = ("w4a8_matmul.cu", "w8a8_matmul.cu", "qkv_rope.cu", "prefill_attention.cu",
           "w13_gate.cu", "fused_layer.cu", "fused_layer_hd256.cu", "fused_rows.cu",
           "fused_rows_w8.cu", "fused_rows_hd256.cu", "fused_rows_hd256_w8.cu",
           "fused_otail_w8.cu", "fused_mlp_tiles.cu", "fused_rows_ln.cu", "staged_append.cu",
           "kv4_attention.cu", "decode_attention.cu", "wonly_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
LL = ctypes.c_longlong

# entry name -> argtypes (restype int for all, the cudaError_t of the launch)
SIGNATURES = {
    "mqt_w4a8_matmul": [P, P, P, P, P, P, P, P, I, I, I, I, F, F, I, I, P],
    "mqt_w8a8_matmul": [P, P, P, P, P, P, P, I, I, I, I, F, F, I, I, P],
    "mqt_qkv_rope": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, I, I, I, I, I, P],
    "mqt_w13_gate": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    "mqt_prefill_attention": [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    "mqt_fused_decode": [P, P],       # (const MqtFusedArgs*, stream)
    "mqt_fused_mlp_block": [P, P],
    "mqt_fused_mlp_tiles": [P, I, P],   # (args, mode, stream)
    "mqt_fused_otail": [P, P],
    "mqt_fused_chunk": [P, P],
    "mqt_staged_append": [P, P, P, P, I, I, I, I, LL, I, P],
    "mqt_kv4_decode_attention": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                 I, I, I, I, P],
    "mqt_decode_attention": [P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    "mqt_wonly_matmul": [P, I, P, I, P, P, I, I, I, I, P, P, I, I, I, I, I, I, P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(p.stat().st_mtime > built
               for p in list(SRC_DIR.glob("*.cu")) + list(SRC_DIR.glob("*.cuh")))


def build(verbose: bool = False) -> Path:
    """Compile every source in parallel and link the shared library (verbose:
    print each source's ptxas lines and its compile seconds)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    done = {}

    def compile_one(src, obj):
        t0 = time.perf_counter()
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(SRC_DIR / src), "-o", str(obj)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        done[src] = (proc, time.perf_counter() - t0)

    jobs = [(src, BUILD_DIR / (Path(src).stem + ".o")) for src in SOURCES]
    threads = [threading.Thread(target=compile_one, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    objs, errors = [], []
    for src, obj in jobs:
        proc, secs = done[src]
        if verbose:
            print(f"[nvcc {src}] {secs:.1f} s\n{proc.stdout}")
        if proc.returncode != 0:
            errors.append(f"{src}:\n{proc.stdout}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = LIB_PATH.with_suffix(f".so.{os.getpid()}")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            handle = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SMS = {}


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (read once a device)."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return sms


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of the tensors; raises on any other device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA device, "
                             f"got {t.device} and {dev}")
    return dev


def aligned(t: torch.Tensor, nbytes: int = 16) -> torch.Tensor:
    """t contiguous with its first byte aligned for vector loads (copied only
    when it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % nbytes else t


def host_floats(vals) -> ctypes.Array:
    return (ctypes.c_float * len(vals))(*[float(v) for v in vals])


def host_int64s(vals) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*[int(v) for v in vals])


def addr(arr: ctypes.Array) -> int:
    return ctypes.addressof(arr)


class Workspace:
    """A per-device int32 split-K workspace shared by the W4A8 matmul kernels.

    The kernels leave it all zero after every launch (the last block of a
    tile clears what it read), so it is zeroed once, when (re)allocated, and
    reused by every later launch on the same stream."""

    def __init__(self):
        self._bufs = {}

    def get(self, device: torch.device, n_ints: int) -> torch.Tensor:
        buf = self._bufs.get(device)
        if buf is None or buf.numel() < n_ints:
            buf = torch.zeros(max(n_ints, 1 << 16), dtype=torch.int32, device=device)
            self._bufs[device] = buf
        return buf


WORKSPACE = Workspace()
