"""The whole W8 MLP block of one layer's packs in one kernel, any M:

  x (M, K) fp32 -> [fq16] -> RMSNorm or LayerNorm -> quantize -> W8 w1|w3 ->
  output fq -> gate chain (SiLU with its sigmoid fq, or gelu_tanh) -> fq ->
  ·g3 -> w2-input int8 -> W8 w2 -> requant -> output fq -> resid_add_2
  (three fq sites) -> (M, K) fp32

Kernel: csrc/fused_rows.cuh (fused_mlp_tiles_kernel, mode MLP_BLOCK, its
LayerNorm instantiation when the arguments' ln is set; entry
mqt_fused_mlp_tiles), which replaces the JAX
package's mobilequant_tpu/ops/pallas_mlp.py fused_mlp_block
(_mlp_block_kernel) in both of its formulations: mm_kind "mxu" and "vpu" (the
TPU's broadcast-multiply-reduce matvec at M = 1, bit-identical to "mxu") run
the same kernel. Bound: the bytes of one layer's W8 w1|w3 and w2 at decode M
(34.6 MB at TinyLlama-1.1B's widths, 10.3 us at 3.35 TB/s); int8 operations at
prefill M. Design: the stacked MLP-block row kernel (ops/mlp_block, the
norm, w13 + gate and w2 stages on the int8 tensor-core tile core) walking M in
128-row steps inside one cooperative launch (the JAX kernel has no row limit), on the
layer's packs seen as a one-layer stack; its norm stage takes the
mean-centred LayerNorm too (fp64 sums, as the plain version).

meta: the JAX engine's 32-float _mlp_block_meta ([19] = norm eps); every site
is switched by its runtime qmax (0: off), as in the JAX kernel, which has no
static site enables.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.fused_mlp import check_w8_mlp
from mobilequant_tpu_torch.ops.mlp_block import (
    MLP_BLOCK, check_norm_kind, fused_mlp_block_w4_plain, layer_stack, mlp_tiles)

META_LEN = 32


def fused_mlp_block_plain(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor,
                          w13: dict, w2: dict, meta: Sequence[float],
                          act_kind: str = "silu", norm_kind: str = "rmsnorm") -> torch.Tensor:
    """The kernel's function in PyTorch operators: the stacked MLP block's
    plain version with every site on (each then switched by its qmax)."""
    return fused_mlp_block_w4_plain(x, norm_w, norm_b, w13, w2, meta, act_kind,
                                    (True,) * 9, norm_kind)


def fused_mlp_block(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor,
                    w13: dict, w2: dict, meta: Sequence[float], act_kind: str = "silu",
                    norm_kind: str = "rmsnorm", mm_kind: str = "mxu") -> torch.Tensor:
    """Residual x (M, K) fp32 -> x + MLP(norm(x)) over one layer's W8 packs
    (w13 wq (K, 2F), w2 wq (F, K)) and norm vectors (K,). Any M; mm_kind
    "vpu" needs M = 1, as in the JAX kernel."""
    M, K = x.shape
    check_w8_mlp(K, w13, w2, act_kind, "fused_mlp_block")
    if w2["wq"].shape[1] != K:
        raise ValueError("fused_mlp_block: w2 maps F back to K")
    check_norm_kind(norm_kind, "fused_mlp_block")
    if mm_kind not in ("mxu", "vpu") or (mm_kind == "vpu" and M != 1):
        raise ValueError(f"fused_mlp_block: mm_kind {mm_kind!r} at M={M}")
    if len(meta) != META_LEN:
        raise ValueError(f"fused_mlp_block meta of {len(meta)} entries, expected {META_LEN}")
    if x.device.type == "cpu":
        fused_mlp_block.plain_calls += 1
        return fused_mlp_block_plain(x, norm_w, norm_b, w13, w2, meta, act_kind, norm_kind)
    _build.require_cuda(x, norm_w, norm_b, w13["wq"], w2["wq"])
    code, out, _ = mlp_tiles(MLP_BLOCK, x, layer_stack(w13), layer_stack(w2), meta, 0,
                             act_kind, norm_w.reshape(1, K), norm_b.reshape(1, K), norm_kind)
    _build.check(code, "fused_mlp_block")
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0
fused_mlp_block.plain_calls = 0
