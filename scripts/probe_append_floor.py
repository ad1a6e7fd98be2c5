"""Measure the floor under row 9's launch (csrc/staged_append.cu, the staged
K/V append: one launch a step on the staged and chunk routes):

    python3 scripts/probe_append_floor.py

It compiles csrc/staged_append.cu beside two rewrites of its kernel and an
empty kernel into build/probe_append_floor/ with nvcc, and times at
chip_smoke.py's shape (TinyLlama-1.1B: 22 layers, B = 32, 4 kv heads of 64,
32 staged columns, column 7) with chip_smoke.py's timer (the least of five
CUDA-graph means of 50 launches, in two rounds): the kernel; the rewrites
(32-bit index arithmetic; one thread moving both the K and the V piece of an
index), each first checked against the plain version; the empty kernel on
the kernel's grid and on one block; a 16-byte Tensor.zero_ and a 16-byte
Tensor.copy_. The card's name and power limit come first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = r'''
namespace {

// 32-bit index arithmetic (fewer than 2^31 pieces)
__global__ void append_i32(int8_t* __restrict__ sk, int8_t* __restrict__ sv,
                           const int8_t* __restrict__ pk, const int8_t* __restrict__ pv,
                           int groups, int hkv, int cs, int hd, long long gstride, int m) {
  const int per_row = hd >> 4, n = groups * hkv * per_row;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const int j = is_v ? i - n : i;
  const int piece = j % per_row, row = j / per_row, h = row % hkv, g = row / hkv;
  const int8_t* src = (is_v ? pv : pk) + g * gstride + (long long)h * hd + 16 * piece;
  int8_t* dst = (is_v ? sv : sk) + ((long long)row * cs + m) * hd + 16 * piece;
  *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(src));
}

// one thread moves the K and the V piece of an index (half the threads)
__global__ void append_kv(int8_t* __restrict__ sk, int8_t* __restrict__ sv,
                          const int8_t* __restrict__ pk, const int8_t* __restrict__ pv,
                          int groups, int hkv, int cs, int hd, long long gstride, int m) {
  const int per_row = hd >> 4, n = groups * hkv * per_row;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int piece = j % per_row, row = j / per_row, h = row % hkv, g = row / hkv;
  const long long s = g * gstride + (long long)h * hd + 16 * piece;
  const long long d = ((long long)row * cs + m) * hd + 16 * piece;
  const int4 a = __ldg(reinterpret_cast<const int4*>(pk + s));
  const int4 b = __ldg(reinterpret_cast<const int4*>(pv + s));
  *reinterpret_cast<int4*>(sk + d) = a;
  *reinterpret_cast<int4*>(sv + d) = b;
}

__global__ void empty_kernel(int x) {
  if (x == -1) asm volatile("trap;");
}

}  // namespace

// which: 1 append_i32, 2 append_kv, 3 the empty kernel on staged_append's
// grid (256 threads a block), 4 the empty kernel on one block
MQT_EXPORT int probe_append(int which, void* sk, void* sv, const void* pk, const void* pv,
                            int groups, int hkv, int cs, int hd, long long gstride, int m,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = 2LL * groups * hkv * (hd >> 4);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  int8_t *a = (int8_t*)sk, *b = (int8_t*)sv;
  const int8_t *c = (const int8_t*)pk, *d = (const int8_t*)pv;
  if (which == 1) append_i32<<<blocks, 256, 0, st>>>(a, b, c, d, groups, hkv, cs, hd, gstride, m);
  else if (which == 2)
    append_kv<<<(blocks + 1) / 2, 256, 0, st>>>(a, b, c, d, groups, hkv, cs, hd, gstride, m);
  else if (which == 3) empty_kernel<<<blocks, 256, 0, st>>>(m);
  else empty_kernel<<<1, 32, 0, st>>>(m);
  return (int)cudaGetLastError();
}
'''


def main() -> None:
    import torch

    import chip_smoke as CS
    from mobilequant_tpu_torch.ops.staged_append import staged_append_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    out = ROOT / "build" / "probe_append_floor"
    out.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "mobilequant_tpu_torch" / "csrc"
    (out / "probe.cu").write_text((csrc / "staged_append.cu").read_text() + VARIANTS)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-I", str(csrc), "-shared", "-Xcompiler", "-fPIC",
                    str(out / "probe.cu"), "-o", str(out / "libprobe.so")], check=True)
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mqt_staged_append.argtypes = [P, P, P, P, I, I, I, I, LL, I, P]
    lib.probe_append.argtypes = [I, P, P, P, P, I, I, I, I, LL, I, P]

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    L, B, Hkv, cs, hd, m = 22, 32, 4, 32, 64, 7
    sk = torch.randint(-128, 128, (L, B, Hkv, cs, hd), generator=g, device=dev, dtype=torch.int8)
    sv = torch.randint(-128, 128, sk.shape, generator=g, device=dev, dtype=torch.int8)
    kvp = torch.randint(-128, 128, (L, B, 2 * Hkv, hd), generator=g, device=dev,
                        dtype=torch.int8)
    pk, pv = kvp[:, :, :Hkv, None], kvp[:, :, Hkv:, None]    # chip_smoke's views

    def launch(which, a, b):
        args = (a.data_ptr(), b.data_ptr(), pk.data_ptr(), pv.data_ptr(), L * B, Hkv, cs, hd,
                2 * Hkv * hd, m, torch.cuda.current_stream().cuda_stream)
        code = lib.mqt_staged_append(*args) if which == 0 else lib.probe_append(which, *args)
        if code != 0:
            raise RuntimeError(f"launch {which}: cudaError {code}")

    rk, rv = staged_append_plain(sk.clone(), sv.clone(), pk, pv, m)
    for which in (0, 1, 2):
        a, b = sk.clone(), sv.clone()
        launch(which, a, b)
        torch.cuda.synchronize()
        if not (torch.equal(a, rk) and torch.equal(b, rv)):
            sys.exit(f"variant {which} differs from the plain version")
    z16, y16 = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    timed = (("staged_append (csrc/staged_append.cu)", lambda i: launch(0, sk, sv)),
             ("rewrite: 32-bit index arithmetic", lambda i: launch(1, sk, sv)),
             ("rewrite: K and V piece a thread", lambda i: launch(2, sk, sv)),
             ("empty kernel, staged_append's grid", lambda i: launch(3, sk, sv)),
             ("empty kernel, one block", lambda i: launch(4, sk, sv)),
             ("Tensor.zero_, 16 bytes", lambda i: z16.zero_()),
             ("Tensor.copy_, 16 bytes", lambda i: z16.copy_(y16)))
    res = {name: [] for name, _ in timed}
    for _ in range(2):
        for name, fn in timed:
            res[name].append(min(CS.time_ms(fn, n=50) for _ in range(5)))
    for name, v in res.items():
        print(f"{name:38s} " + " / ".join(f"{x * 1e3:.3f}" for x in v) + " us", flush=True)


if __name__ == "__main__":
    main()
