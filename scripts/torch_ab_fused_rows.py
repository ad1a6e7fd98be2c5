"""Time kernels of one checkout on the card, for an A/B of two checkouts in one
call (run it on each, parent first and last):

    python3 scripts/torch_ab_fused_rows.py [--rows fused,w13,proj,w8,attn,wonly,dattn] TREE [TREE ...]

For each TREE (a checkout of the repository) it builds that checkout's CUDA
kernels in a fresh process (a tree named twice reuses its first build), then
times on TinyLlama-1.1B's full width the row groups named by --rows (fused,
attn and wonly by default):
  fused  the RMSNorm editions of the whole-model kernel (B = 1, 8, with the
         head), the whole-layer kernel, the MLP block (M = 1, 8, 32, 128,
         1024), the other kinds of its tiles kernel (w13_gate_w2 at M = 128,
         1024; W8: fused_mlp and fused_mlp_block at M = 128), the chunk
         kernel (B = 32, 64, 128, pos0 192, 16 staged columns, with the head;
         at B = 32 and 128 also its %globaltimer stage trace) and the o-tail
         (M = 32, 128), on seeded synthetic W4A8/h4 and W8A8/h8 packs,
         relaxed policy (rows 6, 7, 8, 11, 16-19);
  w13    the w13-gate kernel (row 5), W4 and W8, silu and gelu_tanh, at
         M = 128 and 1024 on TinyLlama's (2048 -> 2 x 5632) and Gemma-2B's
         (2048 -> 2 x 16384) widths, the seeded random packs rotated over
         copies past the 50 MB L2 as chip_smoke.py does (cold_count);
  proj   the prefill projection tiles: the W4A8 matmul (rows 1 / 2) at
         TinyLlama's o, w2 and qkv widths (M = 32, 128; o at 1024 too), the
         TinyLlama head (Vp 32768) at M = 1 and 32, Gemma-2B's w2 (16384 ->
         2048) at M = 128 and head (Vp 258048) at M = 32, each head beside
         torch._int_mm on the unpacked weights; the qkv epilogue kernel
         (row 3) at M = 128: TinyLlama W4 and W8, StableLM W4 (rotary 16 of
         64, q/k/v bias), Gemma W4 (head dim 256); seeded random packs
         rotated over copies past the 50 MB L2; in a tree whose wrappers
         take a plan (`tile_plan`), TinyLlama's M = 128 rows also at 1, 2,
         4 and 8 forced K splits;
  w8     the W8A8 matmul (row 14) at M = 1, 2, 4, 8, 32 on TinyLlama's W8
         qkv, o, w13 and w2 (seeded random stacked packs rotated over copies
         past the 50 MB L2), each M beside torch._int_mm on the same weights
         (rows padded to 32 below 32); in a tree whose wrapper takes a plan
         (`tile_plan`), M = 1, 8, 32 also at 1, 2, 4 and 8 forced K splits;
         then the device time of a B=1 decode step on the attn_all() route
         of a W8A8/h8 pack (128-token prompt, torch.profiler over 4 steps)
         and row 14's part of it;
  attn   the prefill attention (row 4): T=128 into S=1024 and T=S=1024
         relaxed and strict (G=8), StableLM's T=128 into S=1024 (G=1),
         Llama-3-8B's (hd 128, 8 kv heads, G=4) T=128 into S=1024 relaxed
         and strict;
  wonly  the weight-only matmul (rows 12 / 13): wonly_matmul_stacked at
         M = 1, 8 on the W4 g128 projections and the W8 per-channel w1 / k
         (bf16 rows), w4a16_matmul at M = 1, 8, 128 (fp32 rows), the weights
         rotated over copies past the 50 MB L2 as chip_smoke.py does;
  dattn  the two decode attention kernels at chip_smoke.py's shapes (22
         layers rotated, S = 1024): the int8 one (row 15) at B = 1, 32 with
         193 valid rows, relaxed, and B = 32 strict; the int4 one (row 10) at
         B = 1, 32, 128 from pos0 192 and at B = 32 from 480 + 3b (the high
         plane), 16 of 32 staged columns, relaxed (and strict at 480 + 3b);
         each beside SDPA on bf16 over the same valid rows (kv heads
         expanded), the library yardstick of chip_smoke.py; row 15 also at
         G = 1 (32 kv heads of 64) and G = 4 (8 kv heads of 128) at B = 1,
         32 relaxed, and row 10 at G = 4, hd 128 at B = 1, 32 relaxed; in a
         tree whose
         wrappers pick a cluster size, the B = 1 shapes also at clusters of
         4 and 8 blocks a (sequence, kv head); then the device time of
         a B=1 decode step on the int4-cache route and on the attn() route
         (128-token prompt, torch.profiler over 4 steps) and the attention
         kernel's part of it.
Each number is the least of three means over calls replayed from one CUDA
graph (chip_smoke.time_ms). The attn and dattn rows also print a digest of
their output bytes ("<row> digest": the inputs come from one seeded
generator in the same order in every tree), so that two trees' outputs can
be held equal byte for byte. It prints one JSON line a tree, and the card's
name and power limit first; the build's ptxas lines (registers, spills) go
to chiprun_out/ab_build_<n>.txt, n the tree's place in the list.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import contextlib, hashlib, io, json, sys, time
tree, log_path, groups = sys.argv[1], sys.argv[2], sys.argv[3].split(",")
sys.path.insert(0, tree)
import torch
import chip_smoke as CS
from mobilequant_tpu_torch.convert import build_synthetic_packed
from mobilequant_tpu_torch.models import model as MM
from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk
from mobilequant_tpu_torch.ops.fused_layer import fused_layer_w4, fused_model_w4
from mobilequant_tpu_torch.ops.fused_mlp import fused_mlp
from mobilequant_tpu_torch.ops.fused_mlp_block import fused_mlp_block
from mobilequant_tpu_torch.ops.mlp_block import MLP_BLOCK, fused_mlp_block_w4, mlp_tiles
from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
from mobilequant_tpu_torch.ops.w13_gate_w2 import w13_gate_w2
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack
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


def digest(t):
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                          .tobytes()).hexdigest()[:16]


for wb in ((4, 8) if "fused" in groups else ()):
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
    for Mr in (1, 8, 32, 128, 1024):
        x = torch.randn((Mr, D), generator=gen, device=dev)
        if Mr > 128:                # past the wrapper's rows: the row kernel's entry
            out[f"w{wb} row8 M={Mr}"] = tm(lambda i: mlp_tiles(
                MLP_BLOCK, x, w13, w2, meta, i % L, cfg.hidden_act, mn["w"], mn["b"]))
            continue
        out[f"w{wb} row8 M={Mr}"] = tm(lambda i: fused_mlp_block_w4(
            x, mn["w"], mn["b"], w13, w2, meta, i % L, cfg.hidden_act, so))
    # the other kinds of row 8's tiles kernel: row 19 (W4 and W8), rows 16
    # and 17 (W8 only, as the JAX package's)
    for Mr in (128, 1024):
        h8 = torch.randint(-128, 128, (Mr, D), generator=gen, device=dev, dtype=torch.int8)
        out[f"w{wb} row19 M={Mr}"] = tm(lambda i: w13_gate_w2(
            h8, w13, w2, meta, i % L, cfg.hidden_act, so[1:5]))
        if wb == 8 and Mr == 128:
            out[f"w8 row16 M={Mr}"] = tm(lambda i: fused_mlp(
                h8, layer_pack(w13, i % L), layer_pack(w2, i % L), meta[:16], cfg.hidden_act))
            x = torch.randn((Mr, D), generator=gen, device=dev)
            out[f"w8 row17 M={Mr}"] = tm(lambda i: fused_mlp_block(
                x, mn["w"][i % L], mn["b"][i % L], layer_pack(w13, i % L),
                layer_pack(w2, i % L), meta, cfg.hidden_act))
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
    for Bc in (32, 64, 128):
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
        if Bc != 64:
            tr = torch.zeros(3 + 5 * L, dtype=torch.int64, device=dev)
            for _ in range(2):
                fused_model_w4_chunk(*cargs, trace=tr, **fkw)
            torch.cuda.synchronize()
            dt = (tr[1:] - tr[:-1]).double().cpu() / 1e3
            per = dt[:5 * L].reshape(L, 5).mean(0).tolist() + [float(dt[5 * L]),
                                                                float(dt[5 * L + 1])]
            out[f"w{wb} row11 B={Bc} stage us"] = dict(zip(
                ("norm1", "qkv", "attention", "o_proj", "mlp_block", "head_norm", "head"),
                [round(v, 2) for v in per]))
        del kc, vc, sk, sv, cargs
    del packed
    torch.cuda.empty_cache()

if "w13" in groups:
    from mobilequant_tpu_torch.ops.w13_gate import w13_gate
    packed, cfg, pol, _ = build_synthetic_packed("tinyllama-1.1b", w_bits=4, head_bits=4,
                                                 device=dev)
    pol = relax_16bit(pol)
    meta = E._mlp_block_meta(E.layer_ranges(packed["ranges"], 1), pol, cfg)
    so = E._mlp_block_site_on(pol)[1:5]
    del packed
    for model, K, F in (("TinyLlama", 2048, 5632), ("Gemma", 2048, 16384)):
        for wb in (4, 8):
            rows = K // 2 if wb == 4 else K
            n = CS.cold_count(rows * 2 * F, 64)
            lo, hi = (0, 16) if wb == 4 else (-128, 128)
            st = {"wq": torch.randint(-128, 128, (n, rows, 2 * F), generator=gen, device=dev,
                                      dtype=torch.int8),
                  "scale": torch.rand((n, 1, 2 * F), generator=gen, device=dev) * 1e-3 + 1e-4,
                  "offset": torch.randint(lo, hi, (n, 1, 2 * F), generator=gen,
                                          device=dev).float(),
                  "colsum": torch.randn((n, 2 * F), generator=gen, device=dev) * 100.0}
            for act in ("silu", "gelu_tanh"):
                for Mr in (128, 1024):
                    x = torch.randint(-128, 128, (Mr, K), generator=gen, device=dev,
                                      dtype=torch.int8)
                    out[f"row5 {model} W{wb} {act} M={Mr}"] = tm(
                        lambda i: w13_gate(x, st, meta, i % n, act, so), n=max(20, n))
            del st
    torch.cuda.empty_cache()

if "proj" in groups:
    from mobilequant_tpu_torch.ops import qkv_rope as Q, qops, w4a8_matmul as W

    def w4_stack(rows, N, n, bias=False):
        """n seeded random W4 (or W8: rows = K) layers of width N"""
        st = {"wq": torch.randint(-128, 128, (n, rows, N), generator=gen, device=dev,
                                  dtype=torch.int8),
              "scale": torch.rand((n, 1, N), generator=gen, device=dev) * 1e-3 + 1e-4,
              "offset": torch.randint(0, 16, (n, 1, N), generator=gen, device=dev).float(),
              "colsum": torch.randn((n, N), generator=gen, device=dev) * 100.0}
        if bias:
            st["bias"] = torch.randn((n, N), generator=gen, device=dev)
        return st

    def forced(mod, tag, fn, nch):
        """fn timed again at forced K splits, in a tree whose wrapper takes a plan"""
        if not hasattr(mod, "tile_plan"):
            return
        plan = mod.tile_plan
        for want in (1, 2, 4, 8):
            cps = -(-nch // want)
            mod.tile_plan = lambda *a, cps=cps: plan(*a)[:2] + (-(-nch // cps), cps)
            out[f"{tag} ks={-(-nch // cps)}"] = tm(fn)
        mod.tile_plan = plan

    # rows 1 / 2 (w4a8_matmul / _stacked): (tag, K, N, M, head?)
    for tag, K, N, Mr, head in (("TinyLlama o", 2048, 2048, 128, False),
                                ("TinyLlama w2", 5632, 2048, 128, False),
                                ("TinyLlama qkv", 2048, 2560, 128, False),
                                ("TinyLlama o", 2048, 2048, 32, False),
                                ("TinyLlama qkv", 2048, 2560, 32, False),
                                ("TinyLlama o", 2048, 2048, 1024, False),
                                ("TinyLlama head", 2048, 32768, 1, True),
                                ("TinyLlama head", 2048, 32768, 32, True),
                                ("Gemma w2", 16384, 2048, 128, False),
                                ("Gemma head", 2048, 258048, 32, True)):
        n = CS.cold_count(K // 2 * N, 22)
        st = w4_stack(K // 2, N, n, bias=not head)
        x = torch.randint(-128, 128, (Mr, K), generator=gen, device=dev, dtype=torch.int8)
        name = f"row{1 if head else 2} {tag} M={Mr}"
        if head:
            hs = [{k: v[j] for k, v in st.items()} for j in range(n)]
            fn = lambda i: W.w4a8_matmul(x, hs[i % n], 1.0, 128.0)           # noqa: E731
        else:
            fn = lambda i: W.w4a8_matmul_stacked(x, st, 0.02, 121.0, i % n)   # noqa: E731
        out[name] = tm(fn, n=max(20, n))
        if head and Mr > 16:
            wus = [qops.unpack_nibbles(st["wq"][j]).contiguous() for j in range(n)]
            out[name + " _int_mm"] = tm(lambda i: torch._int_mm(x, wus[i % n]), n=max(20, n))
            del wus
        if Mr == 128 and tag.startswith("TinyLlama"):
            forced(W, name, fn, -(-K // 2 // 64))
        del st
    # row 3 (qkv_rope): (tag, Nq, head_dim, rotary_dim, bits, bias)
    for tag, Nq, hd, rot, wb, bias in (("TinyLlama W4", 2560, 64, 64, 4, False),
                                       ("TinyLlama W8", 2560, 64, 64, 8, False),
                                       ("StableLM W4", 6144, 64, 16, 4, True),
                                       ("Gemma W4 hd256", 2560, 256, 256, 4, False)):
        K, Mr = 2048, 128
        rows = K // 2 if wb == 4 else K
        n = CS.cold_count(rows * Nq, 22)
        st = w4_stack(rows, Nq, n, bias)
        full = [torch.full((Nq,), v, device=dev) for v in (0.05, 128.0, 255.0, 1.0)]
        ofq = torch.stack(full)
        outq = torch.stack(full[:2] + [(torch.arange(Nq, device=dev) < Nq * 2 // 3).float()])
        cs = torch.rand((Mr, 2 * hd), generator=gen, device=dev)
        x = torch.randint(-128, 128, (Mr, K), generator=gen, device=dev, dtype=torch.int8)
        name = f"row3 {tag} M={Mr}"

        def fn(i):
            return Q.qkv_rope(x, st, ofq, outq, cs, 0.02, 121.0, i % n, hd, rot)
        out[name] = tm(fn, n=max(20, n))
        if tag == "TinyLlama W4":
            forced(Q, name, fn, K // 2 // 64)
        del st
    torch.cuda.empty_cache()

if "w8" in groups:
    from mobilequant_tpu_torch.ops import w8a8_matmul as W8M
    for tag, K, N in (("qkv", 2048, 2560), ("o", 2048, 2048), ("w13", 2048, 11264),
                      ("w2", 5632, 2048)):
        n = CS.cold_count(K * N, 22)
        st = {"wq": torch.randint(-128, 128, (n, K, N), generator=gen, device=dev,
                                  dtype=torch.int8),
              "scale": torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4,
              "offset": torch.randint(-8, 8, (n,), generator=gen, device=dev).float(),
              "colsum": torch.randn((n, N), generator=gen, device=dev) * 100.0,
              "bias": torch.randn((n, N), generator=gen, device=dev)}
        for Mr in (1, 2, 4, 8, 32):
            x = torch.randint(-128, 128, (Mr, K), generator=gen, device=dev, dtype=torch.int8)
            name = f"row14 {tag} M={Mr}"

            def fn(i, x=x):
                return W8M.w8a8_matmul(x, st, 0.02, 121.0, i % n)
            out[name] = tm(fn, n=max(20, n))
            xp = torch.cat([x, torch.zeros((32 - Mr, K), dtype=torch.int8, device=dev)])
            out[name + " _int_mm"] = tm(lambda i, xp=xp: torch._int_mm(xp, st["wq"][i % n]),
                                        n=max(20, n))
            if Mr in (1, 8, 32) and hasattr(W8M, "tile_plan"):
                plan, nch = W8M.tile_plan, K // 2 // 64
                for want in (1, 2, 4, 8):
                    cps = -(-nch // want)
                    W8M.tile_plan = lambda *a, cps=cps: plan(*a)[:2] + (-(-nch // cps), cps)
                    out[f"{name} ks={-(-nch // cps)}"] = tm(fn, n=max(20, n))
                W8M.tile_plan = plan
        del st
    torch.cuda.empty_cache()
    # the route row 14 serves, attn_all() on a W8A8/h8 pack, B=1 after a
    # 128-token prompt: device ms of a decode step and row 14's share
    # (torch.profiler over 4 steps, as the dattn group reads its routes)
    import dataclasses
    from mobilequant_tpu_torch.runtime.generate import Generator
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
    packed, cfg, pol, ecfg = build_synthetic_packed("tinyllama-1.1b", w_bits=8, head_bits=8,
                                                    max_seq_len=1024, device=dev)
    g = Generator(packed, cfg, relax_16bit(pol),
                  dataclasses.replace(ecfg, use_pallas=KernelConfig.attn_all()), device=dev)
    pr = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device=dev)
    last, cache = g.prefill(pr, g.init_cache(1))
    tok = torch.argmax(last, -1)[:, None]
    start = torch.full((1,), 128, dtype=torch.int32, device=dev)
    g.decode(tok, cache, start, 4)
    d_ms, top, n_launch = CS.device_profile(lambda: g.decode(tok, cache, start, 4), top=200)
    out["attn_all() W8 B=1 step device ms"] = d_ms / 4
    out["attn_all() W8 B=1 step row14 ms"] = sum(
        ms for k, ms, _ in top if "w8a8" in k or "tc_matmul" in k) / 4
    out["attn_all() W8 B=1 step launches"] = n_launch / 4
    del g, packed, cache
    torch.cuda.empty_cache()

if "attn" in groups:
    from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention
    packed, cfg, pol, _ = build_synthetic_packed("tinyllama-1.1b", w_bits=4, head_bits=4,
                                                 device=dev)
    ameta = E._attn_meta(E.layer_ranges(packed["ranges"], 0), relax_16bit(pol), cfg)
    del packed
    for tag, Hkv, G, T, S, strict, hd in (
            ("T=128 S=1024 relaxed", 4, 8, 128, 1024, False, 64),
            ("T=S=1024 relaxed", 4, 8, 1024, 1024, False, 64),
            ("T=S=1024 strict", 4, 8, 1024, 1024, True, 64),
            ("StableLM G=1 T=128 S=1024 relaxed", 32, 1, 128, 1024, False, 64),
            ("Llama-3 hd 128 G=4 T=128 S=1024 relaxed", 8, 4, 128, 1024, False, 128),
            ("Llama-3 hd 128 G=4 T=128 S=1024 strict", 8, 4, 128, 1024, True, 128)):
        meta = list(ameta)
        if strict:
            meta[6:12] = [80.0 / 65535, 32768.0, 65535.0, 1.0 / 65535, 0.0, 65535.0]
        q8 = torch.randint(-128, 128, (1, Hkv, G, T, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        k8 = torch.randint(-128, 128, (1, Hkv, S, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        v8 = torch.randint(-128, 128, k8.shape, generator=gen, device=dev, dtype=torch.int8)
        posi = torch.arange(T, device=dev, dtype=torch.int32)[None]
        valid = torch.full((1,), T, device=dev, dtype=torch.int32)
        out[f"row4 {tag}"] = tm(lambda i: prefill_attention(q8, k8, v8, meta, posi, valid,
                                                            strict, strict))
        out[f"row4 {tag} digest"] = digest(prefill_attention(q8, k8, v8, meta, posi, valid,
                                                             strict, strict))
    torch.cuda.empty_cache()

if "wonly" in groups:
    from mobilequant_tpu_torch.convert import build_synthetic_wonly
    from mobilequant_tpu_torch.ops import qops
    from mobilequant_tpu_torch.ops.wonly_matmul import w4a16_matmul, wonly_matmul_stacked
    from mobilequant_tpu_torch.quant.quantizer import QuantConfig
    pk_w, cfg, _, _ = build_synthetic_wonly("tinyllama-1.1b", w_bits=4, group_size=128,
                                            head_bits=16, device=dev)
    D, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim_, cfg.num_kv_heads * cfg.head_dim_

    def pc_stack(bits, K, N, n):
        ps = [qops.pack_weight(torch.randn((K, N), generator=gen, device=dev) * 0.02,
                               QuantConfig(bitwidth=bits, is_per_channel=True))
              for _ in range(n)]
        st = {k: torch.stack([p[k] for p in ps]) for k in ("wq", "scale", "offset")}
        st["bias"] = torch.zeros((n, N), device=dev)
        return st

    cases = [("W4 g128", tag, pk_w["packs"][key], K)
             for tag, key, K in (("q", "q_proj", D), ("k/v", "k_proj", D), ("o", "o_proj", qd),
                                 ("w1/w3", "w1", D), ("w2", "w2", F))]
    cases += [("W8 pc", tag, pc_stack(8, K, N, L), K)
              for tag, K, N in (("w1/w3", D, F), ("k/v", D, kvd))]
    for tag_c, tag, pk, K in cases:
        args = (pk["wq"], pk["scale"], pk["offset"], pk["bias"])
        Lc = args[0].shape[0]
        lb = args[0][0].numel() + 2 * args[1][0].numel() * 4
        stacks = [args] + [tuple(t.clone() for t in args)
                           for _ in range(CS.cold_count(lb * Lc, 64) - 1)]
        for Mr in (1, 8):
            x = torch.randn((Mr, K), generator=gen, device=dev).to(torch.bfloat16)
            n = max(20, CS.cold_count(lb, Lc * len(stacks)))
            out[f"row12 {tag_c} M={Mr} {tag}"] = tm(lambda i: wonly_matmul_stacked(
                x, *stacks[(i // Lc) % len(stacks)], i % Lc), n=n)
        del stacks
    pk13 = pc_stack(4, D, qd, CS.cold_count(D // 2 * qd, 64))
    w13s = [(pk13["wq"][j], pk13["scale"][j], pk13["offset"][j], pk13["bias"][j])
            for j in range(pk13["wq"].shape[0])]
    for Mr in (1, 8, 128):
        x = torch.randn((Mr, D), generator=gen, device=dev)
        out[f"row13 M={Mr} q"] = tm(lambda i: w4a16_matmul(x, *w13s[i % len(w13s)]),
                                    n=len(w13s))
if "dattn" in groups:
    from mobilequant_tpu_torch.ops import qops
    from mobilequant_tpu_torch.ops.decode_attention import decode_attention
    from mobilequant_tpu_torch.ops.kv4_attention import kv4_decode_attention
    metas = {}
    for kvb in (8, 4):
        packed, cfg, pol, _ = build_synthetic_packed("tinyllama-1.1b", w_bits=4, head_bits=4,
                                                     max_seq_len=1024, device=dev, kv_bits=kvb)
        lr0 = E.layer_ranges(packed["ranges"], 0)
        metas[kvb] = {False: E._attn_meta(lr0, relax_16bit(pol), cfg),
                      True: E._attn_meta(lr0, pol, cfg)}
        del packed
    L, Hkv, G, hd, S, cst = cfg.num_layers, cfg.num_kv_heads, 8, 64, 1024, 32

    def sdpa(Bq, valid, Hkv=Hkv, G=G, hd=hd):
        qd = torch.randn((Bq, Hkv * G, 1, hd), generator=gen, device=dev).to(torch.bfloat16)
        kd = torch.randn((Bq, Hkv, 1, valid, hd), generator=gen, device=dev).to(torch.bfloat16)
        kd = kd.expand(Bq, Hkv, G, valid, hd).reshape(Bq, Hkv * G, valid, hd)
        vd = kd.clone()
        return tm(lambda i: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd))

    from mobilequant_tpu_torch.ops import decode_attention as DA, kv4_attention as KV
    sizes = (4, 8) if hasattr(DA, "cluster_size") else ()

    def forced(tag, fn, B):
        """fn at B = 1 timed at each forced cluster size too"""
        if B != 1 or not sizes:
            return
        pick = DA.cluster_size, KV.kv4_cluster_size
        for n in sizes:
            DA.cluster_size = KV.kv4_cluster_size = lambda *a, n=n, **k: n
            out[f"{tag} ncl={n}"] = tm(fn)
        DA.cluster_size, KV.kv4_cluster_size = pick

    for Bd, strict in ((1, False), (32, False), (32, True)):
        kc = torch.randint(-128, 128, (L, Bd, Hkv, S, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
        q8 = torch.randint(-128, 128, (Bd, Hkv, G, hd), generator=gen, device=dev,
                           dtype=torch.int8)
        vl = torch.full((Bd,), 193, dtype=torch.int32, device=dev)
        meta = metas[8][strict]
        tag = f"row15 B={Bd} valid=193 {'strict' if strict else 'relaxed'}"

        def call(i):
            return decode_attention(q8, kc[i % L], vc[i % L], meta, vl)
        out[tag] = tm(call)
        out[tag + " digest"] = digest(call(1))
        out[tag + " SDPA"] = sdpa(Bd, 193)
        forced(tag, call, Bd)
        del kc, vc
    # row 15 at the other group sizes of the parent's editions (G = 1 at hd
    # 64, G = 4 at hd 128), 8 layers rotated
    for Gx, Hkx, hdx in ((1, 32, 64), (4, 8, 128)):
        for Bd in (1, 32):
            kc = torch.randint(-128, 128, (8, Bd, Hkx, S, hdx), generator=gen, device=dev,
                               dtype=torch.int8)
            vc = torch.randint(-128, 128, kc.shape, generator=gen, device=dev, dtype=torch.int8)
            q8 = torch.randint(-128, 128, (Bd, Hkx, Gx, hdx), generator=gen, device=dev,
                               dtype=torch.int8)
            vl = torch.full((Bd,), 193, dtype=torch.int32, device=dev)
            tag = f"row15 G={Gx} hd={hdx} B={Bd} valid=193 relaxed"

            def call(i, kc=kc, vc=vc, q8=q8, vl=vl):
                return decode_attention(q8, kc[i % 8], vc[i % 8], metas[8][False], vl)
            out[tag] = tm(call)
            out[tag + " digest"] = digest(call(1))
            out[tag + " SDPA"] = sdpa(Bd, 193, Hkx, Gx, hdx)
            del kc, vc
    for Bk, stag, strict in ((1, False, False), (32, False, False), (128, False, False),
                             (32, True, False), (32, True, True)):
        BH = Bk * Hkv
        kp = torch.randint(-128, 128, (L, BH, hd, S // 2), generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-128, 128, kp.shape, generator=gen, device=dev, dtype=torch.int8)
        kcs = qops.kv_colsums_packed(kp)
        sk, sv = (torch.randint(-128, -112, (L, BH, cst, hd), generator=gen, device=dev,
                                dtype=torch.int8) for _ in "kv")
        kn, vn = (torch.randint(-128, -112, (BH, hd), generator=gen, device=dev,
                                dtype=torch.int8) for _ in "kv")
        q8 = torch.randint(-128, 128, (BH, G, hd), generator=gen, device=dev, dtype=torch.int8)
        pos = torch.tensor([480 + 3 * b if stag else 192 for b in range(Bk)],
                           dtype=torch.int32, device=dev)
        meta = metas[4][strict]
        tag = (f"row10 B={Bk} pos0={'480+3b' if stag else 192} m=16 "
               f"{'strict' if strict else 'relaxed'}")
        def call(i):
            return kv4_decode_attention(q8, kp, vp, kcs, sk, sv, kn, vn, meta, pos, 16, i % L,
                                        qk_fq_on=strict, pv_fq_on=strict)
        out[tag] = tm(call)
        out[tag + " digest"] = digest(call(1))
        out[tag + " SDPA"] = sdpa(Bk, int(pos.max()) + 17)
        forced(tag, call, Bk)
        del kp, vp, kcs, sk, sv
    # row 10 at G = 4, hd 128 (8 kv heads), 8 layers rotated
    Hkx, Gx, hdx = 8, 4, 128
    for Bk in (1, 32):
        BH = Bk * Hkx
        kp = torch.randint(-128, 128, (8, BH, hdx, S // 2), generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-128, 128, kp.shape, generator=gen, device=dev, dtype=torch.int8)
        kcs = qops.kv_colsums_packed(kp)
        sk, sv = (torch.randint(-128, -112, (8, BH, cst, hdx), generator=gen, device=dev,
                                dtype=torch.int8) for _ in "kv")
        kn, vn = (torch.randint(-128, -112, (BH, hdx), generator=gen, device=dev,
                                dtype=torch.int8) for _ in "kv")
        q8 = torch.randint(-128, 128, (BH, Gx, hdx), generator=gen, device=dev,
                           dtype=torch.int8)
        pos = torch.full((Bk,), 192, dtype=torch.int32, device=dev)
        tag = f"row10 G={Gx} hd={hdx} B={Bk} pos0=192 m=16 relaxed"

        def call(i, kp=kp, vp=vp, kcs=kcs, sk=sk, sv=sv, kn=kn, vn=vn, q8=q8, pos=pos):
            return kv4_decode_attention(q8, kp, vp, kcs, sk, sv, kn, vn, metas[4][False], pos,
                                        16, i % 8)
        out[tag] = tm(call)
        out[tag + " digest"] = digest(call(1))
        out[tag + " SDPA"] = sdpa(Bk, 209, Hkx, Gx, hdx)
        del kp, vp, kcs, sk, sv
    torch.cuda.empty_cache()
    # the routes these kernels serve, B=1 after a 128-token prompt: device ms
    # of a decode step and the attention kernel's share (torch.profiler over
    # 4 steps, chip_smoke.loop_numbers' way)
    import dataclasses
    from mobilequant_tpu_torch.runtime.generate import Generator
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
    for kvb, route, key in ((4, "int4-cache route", "kv4_attn"),
                            (8, "attn() route", "decode_attn")):
        packed, cfg, pol, ecfg = build_synthetic_packed("tinyllama-1.1b", w_bits=4, head_bits=4,
                                                        max_seq_len=1024, device=dev, kv_bits=kvb)
        if kvb == 8:
            ecfg = dataclasses.replace(ecfg, use_pallas=KernelConfig.attn())
        g = Generator(packed, cfg, relax_16bit(pol), ecfg, device=dev)
        pr = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen, device=dev)
        last, cache = g.prefill(pr, g.init_cache(1))
        tok = torch.argmax(last, -1)[:, None]
        start = torch.full((1,), 128, dtype=torch.int32, device=dev)
        g.decode(tok, cache, start, 4)
        d_ms, top, _ = CS.device_profile(lambda: g.decode(tok, cache, start, 4), top=200)
        out[f"{route} B=1 step device ms"] = d_ms / 4
        out[f"{route} B=1 step attention kernel ms"] = sum(ms for k, ms, _ in top if key in k) / 4
        del g, packed, cache
        torch.cuda.empty_cache()
print(json.dumps(out), flush=True)
'''


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="fused,attn,wonly",
                    help="comma-separated row groups: fused, w13, proj, w8, attn, wonly, dattn")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    out_dir = Path(__file__).resolve().parents[1] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for n, tree in enumerate(args.trees):
        run = subprocess.run([sys.executable, "-c", CHILD, str(Path(tree).resolve()),
                              str(out_dir / f"ab_build_{n}.txt"), args.rows],
                             capture_output=True, text=True)
        if run.returncode != 0:
            sys.exit(f"{tree}: {run.stderr[-2000:]}")
        print(run.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
