"""Time the port's fused row kernels of one checkout on the card, for an A/B of
two checkouts in one call (run it on each, parent first and last):

    python3 scripts/torch_ab_fused_rows.py TREE [TREE ...]

For each TREE (a checkout of the repository) it builds that checkout's CUDA
kernels in a fresh process (a tree named twice reuses its first build), then
times on TinyLlama-1.1B's full width (seeded
synthetic W4A8/h4 and W8A8/h8 packs, relaxed policy) the RMSNorm editions of
the whole-model kernel (B = 1, 8, with the head), the whole-layer kernel,
the MLP block (M = 1, 8, 32, 128), the chunk kernel (B = 32, 128, pos0 192,
16 staged columns, with the head) and the o-tail (M = 32, 128): the least of
three means over calls replayed from one CUDA graph (chip_smoke.time_ms). It
prints one JSON line a tree, and the card's name and power limit first; the
build's ptxas lines (registers, spills) go to chiprun_out/ab_build_<n>.txt,
n the tree's place in the list.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

CHILD = r'''
import contextlib, io, json, sys, time
tree, log_path = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import torch
import chip_smoke as CS
from mobilequant_tpu_torch.convert import build_synthetic_packed
from mobilequant_tpu_torch.models import model as MM
from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk
from mobilequant_tpu_torch.ops.fused_layer import fused_layer_w4, fused_model_w4
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4
from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
from mobilequant_tpu_torch.quant.policy import relax_16bit
from mobilequant_tpu_torch.runtime import engine as E
assert _build.__file__.startswith(tree), _build.__file__
dev = torch.device("cuda", 0)
t0 = time.perf_counter()
log = io.StringIO()
if _build._stale():            # a tree's second run reuses its first run's build
    with contextlib.redirect_stdout(log):
        _build.build(verbose=True)
else:
    log.write(f"reused {_build.LIB_PATH}\n")
_build.lib()
open(log_path, "w").write(log.getvalue())
out = {"tree": tree, "build_s": time.perf_counter() - t0}
gen = torch.Generator(device=dev).manual_seed(0)


def tm(fn, n=20):
    return min(CS.time_ms(fn, n=n) for _ in range(3))


for wb in (4, 8):
    packed, cfg, pol, _ = build_synthetic_packed("tinyllama-1.1b", w_bits=wb, head_bits=wb,
                                                 device=dev)
    pol = relax_16bit(pol)
    ly, L, D = packed["layers"], cfg.num_layers, cfg.hidden_size
    hd, Hq, Hkv = cfg.head_dim_, cfg.num_heads, cfg.num_kv_heads
    kp = E._kernel_prep(packed, pol, cfg)
    fkw = dict(num_q_heads=Hq, num_kv_heads=Hkv, head_dim=hd, rotary_dim=cfg.rotary_dim,
               act_kind=cfg.hidden_act)
    lr1 = E.layer_ranges(packed["ranges"], 1)
    meta, so = E._mlp_block_meta(lr1, pol, cfg), E._mlp_block_site_on(pol)
    mn, w13, w2, op = ly["mlp_norm"], ly["w13_proj"], ly["w2"], ly["o_proj"]
    for Mr in (1, 8, 32, 128):
        x = torch.randn((Mr, D), generator=gen, device=dev)
        out[f"w{wb} row8 M={Mr}"] = tm(lambda i: fused_mlp_block_w4(
            x, mn["w"], mn["b"], w13, w2, meta, i % L, cfg.hidden_act, so))
    omet, oso = meta + E._otail_meta_ext(lr1, pol), E._otail_site_on(pol)
    for Mr in (32, 128):
        x = torch.randn((Mr, D), generator=gen, device=dev)
        a8 = torch.randint(-128, 128, (Mr, Hq * hd), generator=gen, device=dev,
                           dtype=torch.int8)
        out[f"w{wb} row18 M={Mr}"] = tm(lambda i: fused_otail_block_w4(
            a8, x, op, mn["w"], mn["b"], w13, w2, omet, i % L, cfg.hidden_act, so, oso))
    head = (packed["head_q"], packed["norm"])
    for Bm in (1, 8):
        kc = torch.randint(-128, 128, (L, Bm, Hkv, 1024, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
        pos = torch.tensor([192 - 3 * b for b in range(Bm)], dtype=torch.int32, device=dev)
        cos, sin = MM.rope_cos_sin(pos[:, None], cfg)
        cs = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(Bm, 2, hd)
        x = torch.randn((Bm, D), generator=gen, device=dev)
        fargs = (x, pos, cs, kp["ofq"], ly["attn_norm"], ly["qkv_proj"], op, mn, w13, w2,
                 kc, vc, kp["meta"])
        out[f"w{wb} row6 B={Bm}"] = tm(lambda i: fused_model_w4(*fargs, *head, **fkw), n=10)
        if Bm == 1:
            out[f"w{wb} row7 B=1"] = tm(lambda i: fused_layer_w4(*fargs, i % L, **fkw))
        del kc, vc
    for Bc in (32, 128):
        kc = torch.randint(-128, 128, (L, Bc, Hkv, 1024, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
        sk = torch.randint(-128, 128, (L, Bc, Hkv, 32, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        sv = torch.randint(-128, 128, sk.shape, generator=gen, device=dev, dtype=torch.int8)
        pos0 = torch.full((Bc,), 192, dtype=torch.int32, device=dev)
        cos, sin = MM.rope_cos_sin((pos0 + 16)[:, None], cfg)
        cs = E._rope_cs_rows(cos, sin, hd, cfg.rotary_dim).reshape(Bc, 2, hd)
        x = torch.randn((Bc, D), generator=gen, device=dev)
        cargs = (x, pos0, cs, kp["ofq"], ly["attn_norm"], ly["qkv_proj"], op, mn, w13, w2,
                 kc, vc, E.kv_colsums(kc), sk, sv, 16, kp["meta"], *head)
        out[f"w{wb} row11 B={Bc}"] = tm(lambda i: fused_model_w4_chunk(*cargs, **fkw), n=5)
        del kc, vc, sk, sv, cargs
    del packed
    torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
'''


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    out_dir = Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for n, tree in enumerate(sys.argv[1:]):
        run = subprocess.run([sys.executable, "-c", CHILD, str(Path(tree).resolve()),
                              str(out_dir / f"ab_build_{n}.txt")], capture_output=True,
                             text=True)
        if run.returncode != 0:
            sys.exit(f"{tree}: {run.stderr[-2000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
