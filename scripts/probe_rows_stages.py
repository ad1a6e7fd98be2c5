"""Split the chunk step's matvec stages (csrc/fused_rows.cuh rows_matvec) into
their parts on the card, with %globaltimer stamps in patched copies of the
package (the checkout's own sources stay as they are):

    python3 scripts/probe_rows_stages.py [--variants base,...] [B ...]   (B: 32 128)

For each variant it copies mobilequant_tpu_torch/ into build/probe_rows/<variant>/,
adds stamps there (block 0, thread 0: at a stage's start, when block 0's tiles
are done, after a split stage's grid barrier and after its epilogue walk; ten
grid barriers with nothing between them at the kernel's start; every block's
SM id) and the variant's change, and builds fused_rows.cu alone (the W4
editions; the other row-kernel entries are stubs), the variants side by side.
Variants: base (the sources as they are); sleep (the barrier's waiters poll
every 1 µs instead of 64 ns); flags (the last block in releases every block
through a flag of its own, on its own 128-byte line, instead of one word that
every block polls); spread (stage item i runs on block 2i, or 2(i - G/2) + 1
past half the grid G); stages6 (a six-stage ring instead of four); noskip
(a warp runs the products of its 16-row blocks past the tile's valid rows
too); min4 (K splits of at least 4 chunks instead of 2). Each then runs the
W4 chunk kernel on TinyLlama-1.1B's full width (seeded synthetic W4A8/h4
pack, pos0 192, 16 of 32 staged columns, relaxed policy) at each B, in a
process of its own, and prints per matvec stage, mean over the layers
(µs): block 0's tiles ("tiles": block 0 always holds the stage's first item),
the wait for the other blocks with the barrier ("wait"), the epilogue walk
("epi") and the stage's closing barrier ("close": to the next stage's start);
each stage's K splits and items; the barrier alone; the SMs of blocks 0-3
and G/2 .. G/2 + 3; the trace's stages and the kernel's time (CUDA events,
mean of 5). The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_rows"

PROBE = r'''
__device__ unsigned long long g_pbuf[8192];
__device__ int g_pi;
__device__ int g_psm[1024];
__device__ __forceinline__ void pst() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (g_pi < 8192) g_pbuf[g_pi++] = t;
  }
}
'''

STUBS = r'''
#include "fused_common.cuh"
#define STUB(f) int f(const MqtFusedArgs&, cudaStream_t) { return (int)cudaErrorNotSupported; }
STUB(mqt_rows_w8_mlp) STUB(mqt_rows_mlp_ln) STUB(mqt_rows_w8_chunk) STUB(mqt_rows_chunk_hd256)
STUB(mqt_rows_w8_chunk_hd256) STUB(mqt_rows_w8_otail)
int mqt_rows_mlp_raw_w2(const MqtFusedArgs&, int, cudaStream_t) {
  return (int)cudaErrorNotSupported;
}
'''

READ = r'''
MQT_EXPORT int mqt_probe_read(void* dst, void* n, void* sm) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_pbuf, sizeof(g_pbuf));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(sm, g_psm, sizeof(g_psm));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(n, g_pi, sizeof(int));
}
'''

FLAGS_BARRIER = r'''__device__ void grid_barrier(unsigned* bar) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned g = *(volatile unsigned*)(bar + 1);
    __threadfence();
    last = atomicAdd(bar, 1u) == gridDim.x - 1;
    if (last) {
      atomicExch(bar, 0u);
      atomicAdd(bar + 1, 1u);
      __threadfence();
    } else {
      volatile unsigned* mine = bar + 64 + 32 * blockIdx.x;
      while (*mine != g + 1) __nanosleep(64);
      __threadfence();
    }
  }
  __syncthreads();
  if (last) {
    const unsigned g = *(volatile unsigned*)(bar + 1);
    for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x)
      *(volatile unsigned*)(bar + 64 + 32 * b) = g;
    __syncthreads();
  }
}
'''


def patch(src: str, old: str, new: str) -> str:
    if old not in src:
        sys.exit(f"probe: the source changed, cannot find {old!r}")
    return src.replace(old, new, 1)


def edit(path: Path, *pairs) -> None:
    s = path.read_text()
    for old, new in pairs:
        s = patch(s, old, new)
    path.write_text(s)


def make_copy(variant: str) -> Path:
    dst = OUT / variant
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "mobilequant_tpu_torch", dst / "mobilequant_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = dst / "mobilequant_tpu_torch" / "csrc"
    edit(csrc / "fused_rows.cuh",
         ("constexpr int MAXR = 128;", PROBE + "constexpr int MAXR = 128;"),
         ("  const RowPlan p(M, kin, gate ? F / HALF : (N + TC_BN - 1) / TC_BN);\n",
          "  const RowPlan p(M, kin, gate ? F / HALF : (N + TC_BN - 1) / TC_BN);\n  pst();\n"),
         ("  if (p.ks == 1) return;\n  grid_barrier(bar);\n",
          "  pst();\n  if (p.ks == 1) return;\n  grid_barrier(bar);\n  pst();\n"),
         ("    epi(r, cc, a0, a1, rs);\n  }\n}\n", "    epi(r, cc, a0, a1, rs);\n  }\n  pst();\n}\n"),
         ("  const int K = a.K, M = a.M, Nq = a.qkv.n;\n  stamp(a, 0);\n",
          "  const int K = a.K, M = a.M, Nq = a.qkv.n;\n"
          "  if (threadIdx.x == 0) {\n    unsigned sm;\n"
          '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
          "    if (blockIdx.x < 1024) g_psm[blockIdx.x] = (int)sm;\n  }\n"
          "  if (blockIdx.x == 0 && threadIdx.x == 0) g_pi = 0;\n"
          "  pst();\n  for (int i = 0; i < 10; ++i) grid_barrier(a.bar);\n  pst();\n"
          "  stamp(a, 0);\n"))
    if variant == "sleep":
        edit(csrc / "fused_common.cuh",
             ("      while (*gen == g) __nanosleep(64);", "      while (*gen == g) __nanosleep(1000);"))
    elif variant == "flags":
        s = (csrc / "fused_common.cuh").read_text()
        a = s.index("__device__ void grid_barrier(unsigned* bar) {")
        b = s.index("// Column map of a matvec tile")
        (csrc / "fused_common.cuh").write_text(s[:a] + FLAGS_BARRIER + "\n" + s[b:])
    elif variant == "spread":
        edit(csrc / "fused_rows.cuh",
             ("  for (int it = blockIdx.x; it < p.rt * p.ct * p.ks; it += gridDim.x) {",
              "  const int vb = (int)(blockIdx.x & 1) * ((int)gridDim.x / 2) + (int)(blockIdx.x >> 1);\n"
              "  for (int it = vb; it < p.rt * p.ct * p.ks; it += gridDim.x) {"))
    elif variant == "stages6":
        edit(csrc / "tc_tile.cuh", ("constexpr int TC_STAGES = 4;", "constexpr int TC_STAGES = 6;"))
    elif variant == "noskip":
        edit(csrc / "fused_rows.cuh", ("    tc_tile<WB, true, true>(", "    tc_tile<WB, true, false>("))
    elif variant == "min4":
        edit(csrc / "fused_rows.cuh",
             ("      const int cap = nch / 2 > 1 ? nch / 2 : 1;",
              "      const int cap = nch / 4 > 1 ? nch / 4 : 1;"))
        edit(dst / "mobilequant_tpu_torch" / "ops" / "mlp_block.py",
             ("TILE_ROWS, TILE_COLS, CHUNK_ROWS, MIN_SPLIT_CHUNKS = 64, 128, 64, 2",
              "TILE_ROWS, TILE_COLS, CHUNK_ROWS, MIN_SPLIT_CHUNKS = 64, 128, 64, 4"))
    elif variant != "base":
        sys.exit(f"probe: no variant {variant!r}")
    (csrc / "probe_stubs.cu").write_text(STUBS)
    (csrc / "fused_rows.cu").write_text((csrc / "fused_rows.cu").read_text() + READ)
    edit(dst / "mobilequant_tpu_torch" / "ops" / "_build.py",
         ("SOURCES = (", 'SOURCES = ("fused_rows.cu", "probe_stubs.cu")\n_ALL_SOURCES = ('))
    return dst


CHILD = r'''
import ctypes, sys
copy, root, bs = sys.argv[1], sys.argv[2], [int(b) for b in sys.argv[3].split(",")]
sys.path[:0] = [copy, root]
import torch
from mobilequant_tpu_torch.convert import build_synthetic_packed
from mobilequant_tpu_torch.models import model as MM
from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk
from mobilequant_tpu_torch.ops.mlp_block import rows_plan
from mobilequant_tpu_torch.quant.policy import relax_16bit
from mobilequant_tpu_torch.runtime import engine as E
assert _build.__file__.startswith(copy), _build.__file__
_build.SIGNATURES = {"mqt_fused_chunk": [ctypes.c_void_p] * 2,
                     "mqt_probe_read": [ctypes.c_void_p] * 3}
lib = _build.lib()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
packed, cfg, spol, _ = build_synthetic_packed("tinyllama-1.1b", w_bits=4, head_bits=4, device=dev)
pol = relax_16bit(spol)
ly, L, D, F = packed["layers"], cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
hd, Hq, Hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
Nq, Vp = ly["qkv_proj"]["wq"].shape[2], packed["head_q"]["wq"].shape[1]
kp = E._kernel_prep(packed, pol, cfg)
fkw = dict(num_q_heads=Hq, num_kv_heads=Hkv, head_dim=hd, rotary_dim=cfg.rotary_dim,
           act_kind=cfg.hidden_act)
grid = 2 * _build.sm_count(dev)
names = ("qkv", "o", "gate", "w2")
shapes = {"qkv": (D, Nq, False), "o": (Hq * hd, D, False), "gate": (D, 2 * F, True),
          "w2": (F, D, False)}
for B in bs:
    kc = torch.randint(-128, 128, (L, B, Hkv, 1024, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
    sk = torch.randint(-128, 128, (L, B, Hkv, 32, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    sv = torch.randint(-128, 128, sk.shape, generator=gen, device=dev, dtype=torch.int8)
    pos0 = torch.full((B,), 192, dtype=torch.int32, device=dev)
    cos, sin = MM.rope_cos_sin((pos0 + 16)[:, None], cfg)
    cs = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(B, 2, hd)
    x = torch.randn((B, D), generator=gen, device=dev)
    cargs = (x, pos0, cs, kp["ofq"], ly["attn_norm"], ly["qkv_proj"], ly["o_proj"],
             ly["mlp_norm"], ly["w13_proj"], ly["w2"], kc, vc, E.kv_colsums(kc), sk, sv, 16,
             kp["meta"], packed["head_q"], packed["norm"])
    tr = torch.zeros(3 + 5 * L, dtype=torch.int64, device=dev)
    for _ in range(3):
        fused_model_w4_chunk(*cargs, trace=tr, **fkw)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(5):
        fused_model_w4_chunk(*cargs, **fkw)
    ev[1].record()
    torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1]) / 5
    fused_model_w4_chunk(*cargs, trace=tr, **fkw)
    torch.cuda.synchronize()
    buf, sm, n = (ctypes.c_ulonglong * 8192)(), (ctypes.c_int * 1024)(), ctypes.c_int(0)
    _build.check(lib.mqt_probe_read(ctypes.addressof(buf), ctypes.addressof(n),
                                    ctypes.addressof(sm)), "probe")
    t = [buf[i] for i in range(n.value)]
    ts = tr.cpu().tolist()
    split = {k: rows_plan(B, *shapes[k], grid)[3] > 1 for k in names}
    per = {k: [] for k in names}
    i = 2                                    # after the ten barriers
    for layer in range(L):
        for k in names:
            m = 4 if split[k] else 2
            per[k].append(t[i:i + m])
            i += m

    def nxt(k, layer):
        # a stage closes at the next one's start: the trace's qkv and o
        # stamps, w2's first stamp (the gate), the trace's MLP-block stamp
        if k == "gate":
            return per["w2"][layer][0]
        return ts[5 * layer + {"qkv": 2, "o": 4, "w2": 5}[k]]

    h = grid // 2
    print(f"B={B}: kernel {step_ms:.4f} ms; ten grid barriers {(t[1] - t[0]) / 1e4:.2f} us "
          f"each; grid {grid}; SMs of blocks 0-3 {list(sm[0:4])}, {h}-{h + 3} "
          f"{list(sm[h:h + 4])}", flush=True)
    for k in names:
        rt, ct, _, ks, _ = rows_plan(B, *shapes[k], grid)
        row = f"  {k}: ks {ks}, items {rt * ct * ks}; tiles " \
              f"{sum(s[1] - s[0] for s in per[k]) / L / 1e3:.2f}"
        if split[k]:
            row += f", wait {sum(s[2] - s[1] for s in per[k]) / L / 1e3:.2f}, " \
                   f"epi {sum(s[3] - s[2] for s in per[k]) / L / 1e3:.2f}"
        close = sum(nxt(k, layer) - per[k][layer][-1] for layer in range(L)) / L / 1e3
        print(row + f", close {close:.2f}", flush=True)
    dt = [(ts[j + 1] - ts[j]) / 1e3 for j in range(len(ts) - 1)]
    print("  trace stages (mean per layer): " + ", ".join(
        f"{k} {sum(dt[5 * layer + j] for layer in range(L)) / L:.2f}"
        for j, k in enumerate(("norm1", "qkv", "attention", "o_proj", "mlp_block")))
        + f"; head {dt[5 * L + 1]:.2f}", flush=True)
    del kc, vc, sk, sv, cargs
'''


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="base")
    ap.add_argument("bs", nargs="*", type=int, default=[32, 128])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    copies = {v: make_copy(v) for v in args.variants.split(",")}
    errors = {}

    def build(v, copy):
        run = subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                              "from mobilequant_tpu_torch.ops import _build; _build.build()",
                              str(copy)], capture_output=True, text=True)
        if run.returncode:
            errors[v] = run.stderr[-3000:]

    threads = [threading.Thread(target=build, args=item) for item in copies.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v, copy in copies.items():
        print(f"variant {v}:", flush=True)
        if v in errors:
            print(f"  build failed:\n{errors[v]}", flush=True)
            continue
        run = subprocess.run([sys.executable, "-c", CHILD, str(copy), str(ROOT),
                              ",".join(map(str, args.bs))], capture_output=True, text=True)
        print(run.stdout.rstrip() if run.returncode == 0 else run.stderr[-3000:], flush=True)


if __name__ == "__main__":
    main()
