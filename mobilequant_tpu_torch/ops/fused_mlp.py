"""W8 w1|w3, the gate chain and the raw w2 sums of one layer in one kernel:

  h8 (M, K) shifted int8 -> W8 w1|w3 -> affine -> w1 output fq -> SiLU (its
  sigmoid fq) or gelu_tanh -> act fq -> · w3 (output fq) -> w2-input int8 g8
  -> acc (M, N) = Σ g8·w2 (int32, rounded to the nearest fp32) and
  rsum (M, 1) = Σ g8 (fp32)

The caller applies w2's affine epilogue (runtime/engine.py, plain PyTorch in
the JAX engine's fp32 order: it is XLA in the JAX package too).

Kernel: csrc/fused_rows.cuh (fused_mlp_tiles_kernel, mode MLP_RAW; entry
mqt_fused_mlp_tiles in fused_rows.cu, instantiated in fused_mlp_tiles.cu), which
replaces the JAX package's mobilequant_tpu/ops/pallas_mlp.py fused_mlp
(_mlp_kernel). Bound: the bytes of one layer's W8 w1|w3 and w2 (34.6 MB at
TinyLlama-1.1B's widths, 10.3 us at 3.35 TB/s) at decode M; int8 operations
at prefill M. Design: the row kernels' w13 + gate stage and w2 stage (the
int8 tensor-core tile core of csrc/tc_tile.cuh, K split where the tiles leave
blocks idle), a grid barrier between them, in one cooperative launch that
walks M in 128-row steps (the JAX kernel has no row limit); the (M, F) int8 g8 stays in a 128-row scratch, and the w2 tiles'
epilogue writes the raw sums and, from the first column tile, the g8 row sums.

meta: 16 floats, the JAX engine's (engine.py mlp_mode): [0..1] the h8
encoding, [2..13] the w1 output / sigmoid / act output / w3 output fq sites
(scale, offset, qmax; qmax 0: off), [14..15] the w2-input encoding.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.mlp_block import MLP_RAW, layer_stack, mlp_tiles, tiles_supported
from mobilequant_tpu_torch.ops.qops import int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import w13_gate_plain

META_LEN = 16


def fused_mlp_plain(h8: torch.Tensor, w13: dict, w2: dict, meta: Sequence[float],
                    act_kind: str = "silu"):
    """The kernel's function in PyTorch operators (one layer's W8 packs):
    every site switched by its runtime qmax, as the JAX kernel."""
    g8 = w13_gate_plain(h8, w13, meta, act_kind)
    return int_dot(g8, w2["wq"]), rowsum_i8(g8)


def check_w8_mlp(K: int, w13: dict, w2: dict, act_kind: str, name: str) -> int:
    """F of one layer's W8 w13 (K, 2F) and w2 (F, N) packs; raises on what the
    kernel does not take."""
    K2, F2 = w13["wq"].shape
    F = F2 // 2
    if K2 != K or w2["wq"].shape[0] != F or w13["wq"].dtype != torch.int8:
        raise ValueError(f"{name}: expected W8 packs w13 ({K}, 2F) and w2 (F, N), got "
                         f"{tuple(w13['wq'].shape)} and {tuple(w2['wq'].shape)}")
    if act_kind not in ("silu", "gelu_tanh"):
        raise NotImplementedError(f"{name}: act {act_kind!r}")
    if not tiles_supported(K, F):
        raise NotImplementedError(f"{name} kernel: K={K}, F={F} (K % 64, F % 64)")
    return F


def fused_mlp(h8: torch.Tensor, w13: dict, w2: dict, meta: Sequence[float],
              act_kind: str = "silu"):
    """h8 (M, K) int8 × one layer's W8 w13 pack {wq (K, 2F), scale, offset,
    colsum, bias} and w2 pack {wq (F, N), ...} -> (acc (M, N) fp32, rsum (M, 1)
    fp32). Any M."""
    M, K = h8.shape
    check_w8_mlp(K, w13, w2, act_kind, "fused_mlp")
    if w2["wq"].shape[1] != K:
        raise NotImplementedError("fused_mlp kernel: w2 maps F back to K")
    if len(meta) != META_LEN:
        raise ValueError(f"fused_mlp meta of {len(meta)} entries, expected {META_LEN}")
    if h8.device.type == "cpu":
        fused_mlp.plain_calls += 1
        return fused_mlp_plain(h8, w13, w2, meta, act_kind)
    _build.require_cuda(h8, w13["wq"], w2["wq"])
    code, acc, rsum = mlp_tiles(MLP_RAW, h8, layer_stack(w13), layer_stack(w2), meta, 0,
                                act_kind)
    _build.check(code, "fused_mlp")
    fused_mlp.launches += 1
    return acc, rsum[:, None]


fused_mlp.launches = 0
fused_mlp.plain_calls = 0
