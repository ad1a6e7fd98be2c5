"""Where the Gemma-2B W8A8/h8 chunk route's logits leave the plain path's, on
the card, over chip_smoke.py's phase-3g chain and fresh draws of its shapes.

    python3 chip_smoke.py                      # writes chiprun_out/gemma_w8_chain_inputs.pt
    python3 scripts/probe_gemma_w8_chain.py [--draws 2] [--cpu-steps 12]

It builds the seeded Gemma-2B W8A8/h8 pack of chip_smoke.py (seed 0, relaxed
policy, S 1024) and, for phase 3g's own inputs (the B=32 prompt and the 32
fed tokens chip_smoke.py saved) and for --draws fresh draws of the same
shapes, prefills on the entry config and runs one 32-step B=32 staged chunk
(chip_smoke.run_staged_chunk) seven ways:
  chunk             the entry config's chunk route (one chunk-kernel launch a step)
  chunk_again       the same a second time (the kernel is deterministic)
  chunk_plain_fn    the route with the chunk kernel's plain version
  engine_attention  that plain version with the plain engine's attention
  engine_norms      that plain version with the plain engine's fp32 norms
  engine_numerics   both: the plain engine's numerics on the route's wiring
  plain             the plain engine path (KernelConfig.none())
and prints each against the plain path: the logits rel of every step, the
sequence and step of the largest gap, and the first step and layer at which
that sequence's flushed K / V bytes part from the plain path's. Then, on the
host's CPU (every wrapper there runs its plain version), it replays the worst
sequence of phase 3g's chain (16 copies: the chunk gate's least batch) from
the card's prefilled cache up to its worst step (at most --cpu-steps) on the
chunk route and on the plain path, and holds each against the card's run of
the same path. Writes chiprun_out/probe_gemma_w8_chain.json."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as CS                                           # noqa: E402


def rel_steps(a, b):
    """Logits rel of every step (B, n, V): max |a - b| / max |b|."""
    return [CS.float_err(a[:, i], b[:, i])[1] for i in range(a.shape[1])]


def parting(ca, cb, b, window):
    """(step, layer, max int8 diff) where sequence b's flushed K / V bytes
    first differ between two caches, or None."""
    for i in range(window.stop - window.start):
        col = window.start + i
        for layer in range(ca.k.shape[0]):
            d = max(int((x[layer, b, :, col].int() - y[layer, b, :, col].int()).abs().max())
                    for x, y in ((ca.k, cb.k), (ca.v, cb.v)))
            if d:
                return i, layer, d
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", default=str(ROOT / "chiprun_out" / "gemma_w8_chain_inputs.pt"))
    ap.add_argument("--draws", type=int, default=2)
    ap.add_argument("--cpu-steps", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_gemma_w8_chain: needs a CUDA device")
    from mobilequant_tpu_torch.convert import build_synthetic_packed
    from mobilequant_tpu_torch.ops import _build, qops
    from mobilequant_tpu_torch.ops.chunk_model import fused_model_w4_chunk_plain
    from mobilequant_tpu_torch.quant.policy import relax_16bit
    from mobilequant_tpu_torch.runtime import engine as E
    from mobilequant_tpu_torch.runtime.generate import Generator
    from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    if _build._stale():
        _build.build()
    _build.lib()
    pk, cfg, strict, ecfg = build_synthetic_packed("gemma-2b", w_bits=8, head_bits=8,
                                                   max_seq_len=CS.MAX_SEQ, seed=CS.SEED,
                                                   device=dev)
    pol = relax_16bit(strict)
    gs = Generator(pk, cfg, pol, ecfg, device=dev)            # the entry config
    kc = KernelConfig.serving(cfg, pk, CS.SERVE_B)
    B, T, n = CS.SERVE_B, CS.PROMPT_LEN, CS.CHUNK_COLS
    window = slice(T, T + n)
    plain_fn = {(E, "fused_model_w4_chunk"): fused_model_w4_chunk_plain}
    ways = {"chunk": (kc, {}), "chunk_again": (kc, {}), "chunk_plain_fn": (kc, plain_fn),
            "engine_attention": (kc, {**plain_fn,
                                      **CS.engine_numerics(E, cfg, pol, norms=False)}),
            "engine_norms": (kc, {**plain_fn,
                                  **CS.engine_numerics(E, cfg, pol, attention=False)}),
            "engine_numerics": (kc, {**plain_fn, **CS.engine_numerics(E, cfg, pol)}),
            "plain": (KernelConfig.none(), {})}
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 113)
    saved = torch.load(args.inputs)
    inputs = [("phase_3g", saved["prompt"].numpy(), saved["tokens"].to(dev))]
    for d in range(args.draws):
        inputs.append((f"draw_{d}",
                       torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                     device=dev).cpu().numpy(),
                       torch.randint(0, cfg.vocab_size, (B, n), generator=gen, device=dev)))
    pos0 = torch.full((B,), T, dtype=torch.int32, device=dev)
    report, keep = {}, {}
    for tag, prompt, toks in inputs:
        c0 = E.init_kv_cache(ecfg, B, device=dev)
        _, c0 = gs.prefill(torch.as_tensor(prompt, device=dev), c0)
        res = {}
        for way, (kc_w, stand) in ways.items():
            cc = E.EngineKVCache(c0.k.clone(), c0.v.clone())
            with CS.patched(stand):
                res[way] = CS.run_staged_chunk(E, qops, gs.packed, cfg, pol, kc_w, cc, toks,
                                               pos0)
        plain_lg = res["plain"][0]
        gap = (res["chunk"][0] - plain_lg).abs().amax(-1)              # (B, n)
        scale = plain_lg.abs().amax()
        b_w, s_w = divmod(int(gap.argmax()), n)
        again = res["chunk_again"]
        rec = {"repeat_bit_equal": all(torch.equal(x, y) for x, y in (
                   (res["chunk"][0], again[0]), (res["chunk"][1].k, again[1].k),
                   (res["chunk"][1].v, again[1].v))),
               "worst": {"sequence": b_w, "step": s_w,
                         "logits_rel": float(gap[b_w, s_w] / scale),
                         "steps_over_0.1_rel": int((gap / scale > 0.1).sum())}}
        for way in ways:
            if way == "plain":
                continue
            lg, cache = res[way]
            rec[way] = {"logits_rel_per_step": rel_steps(lg, plain_lg),
                        "k_rows": CS.int8_err(cache.k[:, :, :, window],
                                              res["plain"][1].k[:, :, :, window]),
                        "v_rows": CS.int8_err(cache.v[:, :, :, window],
                                              res["plain"][1].v[:, :, :, window]),
                        "worst_sequence_parts_at": parting(cache, res["plain"][1], b_w, window)}
            steps = rec[way]["logits_rel_per_step"]
            print(f"{tag} {way} vs plain: max logits rel {max(steps):.3g} at step "
                  f"{steps.index(max(steps))}; flushed K {rec[way]['k_rows']}, V "
                  f"{rec[way]['v_rows']}; sequence {b_w} parts at (step, layer, max step) "
                  f"{rec[way]['worst_sequence_parts_at']}", flush=True)
        print(f"{tag}: worst gap sequence {b_w} step {s_w} rel "
              f"{rec['worst']['logits_rel']:.3g}; {rec['worst']['steps_over_0.1_rel']} "
              f"(sequence, step) pairs over 0.1; the chunk route repeats bit for bit: "
              f"{rec['repeat_bit_equal']}", flush=True)
        report[tag] = rec
        if tag == "phase_3g":
            keep = {"c0": E.EngineKVCache(c0.k[:, b_w:b_w + 1].cpu(), c0.v[:, b_w:b_w + 1].cpu()),
                    "toks": toks[b_w:b_w + 1].cpu(), "b": b_w, "s": s_w,
                    "chunk": res["chunk"][0][b_w].cpu(), "plain": plain_lg[b_w].cpu(),
                    "chunk_plain_fn": res["chunk_plain_fn"][0][b_w].cpu()}
        del res, c0

    # the CPU replay of phase 3g's worst sequence
    ns = min(keep["s"] + 1, args.cpu_steps)
    t0 = time.perf_counter()
    pk_cpu = E.packed_to({k: v for k, v in gs.packed.items() if k != "kernel_prep"},
                         torch.device("cpu"))
    del gs, pk
    torch.cuda.empty_cache()
    R = 16
    toks_c = keep["toks"][:, :ns].repeat(R, 1)
    pos_c = torch.full((R,), T, dtype=torch.int32)
    cpu = {}
    for way, kc_w in (("chunk", kc), ("plain", KernelConfig.none())):
        cc = E.EngineKVCache(keep["c0"].k.repeat(1, R, 1, 1, 1).contiguous(),
                             keep["c0"].v.repeat(1, R, 1, 1, 1).contiguous())
        cpu[way] = CS.run_staged_chunk(E, qops, pk_cpu, cfg, pol, kc_w, cc, toks_c, pos_c)[0][0]
    card = {w: keep[w][:ns] for w in ("chunk", "plain", "chunk_plain_fn")}

    def rel(a, b):
        return [CS.float_err(a[i], b[i])[1] for i in range(ns)]
    replay = {"sequence": keep["b"], "steps": ns, "worst_step": keep["s"],
              "seconds": time.perf_counter() - t0,
              "cpu_chunk_vs_card_chunk": rel(cpu["chunk"], card["chunk"]),
              "cpu_chunk_vs_card_chunk_plain_fn": rel(cpu["chunk"], card["chunk_plain_fn"]),
              "cpu_plain_vs_card_plain": rel(cpu["plain"], card["plain"]),
              "cpu_chunk_vs_cpu_plain": rel(cpu["chunk"], cpu["plain"]),
              "card_chunk_vs_card_plain": rel(card["chunk"], card["plain"])}
    for k, v in replay.items():
        print(f"cpu replay {k}: {v if not isinstance(v, list) else [f'{x:.3g}' for x in v]}",
              flush=True)
    report["cpu_replay"] = replay
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out" / "probe_gemma_w8_chain.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"probe_gemma_w8_chain: {report['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    main()
