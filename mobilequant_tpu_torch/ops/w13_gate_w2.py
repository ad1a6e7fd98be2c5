"""The whole prefill MLP of one layer in one kernel, w2 folded into the
w13+gate kernel:

  h8 (M, K) shifted int8 -> W4 or W8 w1|w3 -> output fq -> SiLU (sigmoid fq)
  or gelu_tanh -> fq -> · g3 -> w2-input int8 -> W4 or W8 w2 -> affine
  epilogue -> (M, K) fp32 (before the w2 output fq, which the engine applies)

Kernel: csrc/fused_rows.cuh (fused_mlp_tiles_kernel, mode MLP_W2; entry
mqt_fused_mlp_tiles, instantiated in fused_mlp_tiles.cu), which replaces the
JAX package's mobilequant_tpu/ops/pallas_mlp.py w13_gate_w2_stacked (_w13_gate_w2_kernel),
W4 and W8 (the bits from the packs' shapes). Bound: int8 operations at
prefill M (1024 rows of a W8 TinyLlama-1.1B layer: 71 G, 36 us at 1,979
TOP/s), the weight bytes at small M. Design: one cooperative launch that walks
M in 128-row steps: per step the w13 + gate stage (the row kernels' matvec on
the int8 tensor-core tile core of csrc/tc_tile.cuh; the act8 rows go to a
128-row global scratch that stays in the L2), a grid barrier, the w2 stage
with its affine epilogue. The split path it is measured
against is two launches: ops/w13_gate then the w2 matmul. The W4 w2 pack
pairs F rows r and F/2 + r in one byte, as the w4a8 matmul reads it.

w13_gate_w2_supported is the JAX predicate: at a shape it refuses, the engine
takes the split gate path, as the JAX engine does.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.mlp_block import MLP_W2, check_mlp_packs, mlp_tiles
from mobilequant_tpu_torch.ops.w13_gate import w13_gate_plain
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, w4a8_matmul_plain


def _pick_block_tf(K: int, F: int, wbits: int) -> int:
    """The JAX w13+gate kernel's column-block width (pallas_mlp._pick_block_tf)."""
    per_tf = 2 * K if wbits == 4 else 4 * K
    cap = max(128, min(1024, (4 * 1024 * 1024) // per_tf))
    for t in (1024, 512, 256, 128):
        if t <= cap and F % t == 0:
            return t
    return 0


def w13_gate_w2_supported(M: int, K: int, F: int, wbits: int) -> bool:
    """pallas_mlp.w13_gate_w2_supported: the w13+gate kernel's gate
    (w13_gate_supported), act8 and the int32 sums within 24 MiB, F/2 a
    multiple of a 128-aligned w2 row block."""
    half = F // 2
    return (K % 256 == 0 and M * K <= 4 * 1024 * 1024 and _pick_block_tf(K, F, wbits) != 0
            and F % 4 == 0 and M * (F + 4 * K) <= 24 * 1024 * 1024
            and any(half % t == 0 for t in (1408, 1024, 512, 256, 128)))


def w13_gate_w2_plain(h8: torch.Tensor, w13: dict, w2: dict, meta: Sequence[float],
                      act_kind: str = "silu", site_on: tuple = (True,) * 4) -> torch.Tensor:
    """The kernel's function in PyTorch operators (one layer's packs)."""
    m = [float(v) for v in meta]
    g8 = w13_gate_plain(h8, w13, m[:16], act_kind, site_on)
    return w4a8_matmul_plain(g8, w2["wq"], w2["scale"], w2["offset"], w2["colsum"],
                             w2.get("bias"), m[14], m[15])


def w13_gate_w2(h8: torch.Tensor, w13: dict, w2: dict, meta: Sequence[float], layer: int,
                act_kind: str = "silu", site_on: tuple = (True,) * 4) -> torch.Tensor:
    """h8 (M, K) int8 -> the w2 output (M, K) fp32 of layer `layer` of the
    stacked W4 (w13 (L, K/2, 2F), w2 (L, F/2, K)) or W8 ((L, K, 2F), (L, F, K))
    packs. meta: the engine's _mlp_block_meta (0..15 read); site_on: the
    static enables of the w1-output, sigmoid, act-output and w3-output sites
    (a site that is off gets qmax 0 in the kernel's meta)."""
    M, K = h8.shape
    check_mlp_packs(1, K, w13, w2, act_kind, "w13_gate_w2")
    if h8.dtype != torch.int8:
        raise ValueError("w13_gate_w2 takes int8 rows")
    if h8.device.type == "cpu":
        w13_gate_w2.plain_calls += 1
        return w13_gate_w2_plain(h8, layer_pack(w13, layer), layer_pack(w2, layer), meta,
                                 act_kind, site_on)
    _build.require_cuda(h8, w13["wq"], w2["wq"])
    m = [float(v) for v in meta][:16]
    for on, q in zip(site_on, (4, 7, 10, 13)):
        if not on:
            m[q] = 0.0
    code, out, _ = mlp_tiles(MLP_W2, h8, w13, w2, m, layer, act_kind)
    _build.check(code, "w13_gate_w2")
    w13_gate_w2.launches += 1
    return out


w13_gate_w2.launches = 0
w13_gate_w2.plain_calls = 0
