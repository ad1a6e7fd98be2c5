"""Prefill w1|w3 projection with the gated-activation epilogue in one kernel:
W4A8 or W8A8 matmul over [w1 | w3] -> output fake-quant -> SiLU (sigmoid
fake-quant) or gelu_tanh -> fake-quant -> gate multiply -> w2-input int8.

Kernel: csrc/w13_gate.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_mlp.py w13_gate_stacked (_w13_gate_kernel), in
both of its editions (the weight bits from the pack's shape: W4 (K/2, 2F),
W8 (K, 2F)). Bound: integer operations of the 2F-wide matmul at prefill M.
Design: the int8 tensor-core tile core (csrc/tc_tile.cuh: mma.sync m16n8k32
over a four-stage cp.async ring, templated on the weight bits) with a split
column map, so one block computes both the w1 and the w3 column of its gate
outputs and the (M, 2F) fp32 intermediate stays in shared memory.

meta is the JAX engine's _mlp_block_meta vector (entries 0..15 are read:
MLP-input encoding, w1 output fq, sigmoid fq, act output fq, w3 output fq,
w2-input encoding); site_on gives the static enables of the w1-output,
sigmoid, act-output and w3-output sites. The sigmoid is 1 / (1 + exp(−x)) as
the kernel writes it (the JAX XLA path uses jax.nn.sigmoid: the two differ in
the last ulp, which the tests' tolerance states).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.w4a8_matmul import (
    affine_args, check_w48, layer_pack, w4a8_matmul_plain)
from mobilequant_tpu_torch.quant.quantizer import true_div


def w13_gate_supported(K: int, F: int, wbits: int = 4) -> bool:
    """Shapes the kernel takes, W4 or W8 (the tile core reads both as 64-k
    chunks of row pairs k, k + K/2)."""
    return wbits in (4, 8) and K % 64 == 0 and F % 64 == 0


TILE_ROWS, TILE_GATES, CHUNK_ROWS = 64, 64, 64   # csrc/tc_tile.cuh TC_BM, TC_BN / 2, TC_KP


def w13_gate_plan(M: int, K: int, F: int, sms: int):
    """(gate tiles, row tiles, K splits, chunks a split) of the kernel's
    launch (csrc/w13_gate.cu with tc_tile.cuh's tc_pick_split): 64 gate
    outputs by 64 rows a tile, chunks of 64 packed rows (128 k), split over K
    only when the tiles leave SMs idle (about two blocks an SM then, at least
    two chunks a split)."""
    tn, tm = F // TILE_GATES, -(-M // TILE_ROWS)
    nch = -(-(K // 2) // CHUNK_ROWS)
    ks = 1
    if tn * tm < sms:
        ks = min(-(-2 * sms // (tn * tm)), max(nch // 2, 1))
    cps = -(-nch // ks)
    return tn, tm, -(-nch // cps), cps


def _fq(x: torch.Tensor, s: float, o: float, qmax: float) -> torch.Tensor:
    q = torch.clamp(torch.round(true_div(x, s)) + o, 0.0, qmax)
    return (q - o) * s if qmax > 0.5 else x


def w13_gate_plain(h8: torch.Tensor, pack: dict, meta: Sequence[float],
                   act_kind: str = "silu",
                   site_on: tuple = (True,) * 4) -> torch.Tensor:
    """The kernel's function in PyTorch operators (one layer's pack)."""
    m = [float(v) for v in meta]
    s_w1, s_sig, s_act, s_w3 = site_on
    y = w4a8_matmul_plain(h8, pack["wq"], pack["scale"], pack["offset"],
                          pack["colsum"], pack.get("bias"), m[0], m[1])
    F = y.shape[-1] // 2
    g1, g3 = y[:, :F], y[:, F:]
    if s_w1:
        g1 = _fq(g1, m[2], m[3], m[4])
    if act_kind == "silu":
        sig = 1.0 / (1.0 + torch.exp(-g1))
        if s_sig:
            sig = _fq(sig, m[5], m[6], m[7])
        act = g1 * sig
    elif act_kind == "gelu_tanh":
        t = 0.7978845608028654 * (g1 + 0.044715 * g1 * g1 * g1)
        act = 0.5 * g1 * (1.0 + torch.tanh(t))
    else:
        raise NotImplementedError(f"w13_gate: act {act_kind!r}")
    if s_act:
        act = _fq(act, m[8], m[9], m[10])
    if s_w3:
        g3 = _fq(g3, m[11], m[12], m[13])
    q = torch.clamp(torch.round(true_div(act * g3, m[14])) + m[15], 0.0, 255.0) - 128.0
    return q.to(torch.int8)


def w13_gate(h8: torch.Tensor, pack: dict, meta: Sequence[float],
             layer: Optional[int], act_kind: str = "silu",
             site_on: tuple = (True,) * 4) -> torch.Tensor:
    """h8 (M, K) shifted int8 -> g8 (M, F) shifted int8 (the w2 input), over
    layer `layer` of the stacked W4 or W8 w13 pack (w1 columns [0, F), w3
    [F, 2F))."""
    p = layer_pack(pack, layer)
    M, K, N2, bits = check_w48(h8, p["wq"])
    F = N2 // 2
    if not w13_gate_supported(K, F, bits):
        raise NotImplementedError(f"w13_gate: K={K}, F={F}")
    if act_kind not in ("silu", "gelu_tanh"):
        raise NotImplementedError(f"w13_gate: act {act_kind!r}")
    if h8.device.type == "cpu":
        w13_gate.plain_calls += 1
        return w13_gate_plain(h8, p, meta, act_kind, site_on)
    dev = _build.require_cuda(h8, p["wq"])
    lib = _build.lib()
    x = _build.aligned(h8)
    w = _build.aligned(p["wq"], 4)
    sc, of, cs, b, ss = affine_args(p, N2)
    meta_h = _build.host_floats(list(meta)[:16])
    out = torch.empty((M, F), dtype=torch.int8, device=dev)
    tn, tm, ks, _ = w13_gate_plan(M, K, F, _build.sm_count(dev))
    ws = _build.WORKSPACE.get(dev, 65 * tn * tm + M * N2 + 64 if ks > 1 else 1)
    s_w1, s_sig, s_act, s_w3 = (int(bool(s)) for s in site_on)
    code = lib.mqt_w13_gate(
        x.data_ptr(), w.data_ptr(), sc.data_ptr(), of.data_ptr(), cs.data_ptr(),
        None if b is None else b.data_ptr(), _build.addr(meta_h), out.data_ptr(),
        ws.data_ptr(), M, K, F, ss, s_w1, s_sig, s_act, s_w3,
        int(act_kind == "gelu_tanh"), bits, _build.stream_ptr(dev))
    _build.check(code, "w13_gate")
    w13_gate.launches += 1
    return out


w13_gate.launches = 0
w13_gate.plain_calls = 0
