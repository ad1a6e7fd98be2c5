"""The attention tail of one layer in one kernel:

  a8 (M, Ko) int8 -> W4 or W8 o-proj -> output fq -> resid_add_1 with x
  (M, K) -> the whole MLP block (ops/mlp_block; RMSNorm, or with norm_kind
  "layernorm" the LayerNorm of StableLM) -> (M, K) fp32

Kernel: csrc/fused_rows.cuh (fused_otail_kernel; entry mqt_fused_otail in
fused_rows.cu, the W4 edition there, the W8 edition in fused_otail_w8.cu),
which replaces the JAX package's mobilequant_tpu/ops/pallas_mlp.py
fused_otail_block_stacked (_otail_block_kernel) in both of its editions (W4:
o (L, Ko/2, K), w13 (L, K/2, 2F), w2 (L, F/2, K); W8: (L, Ko, K), (L, K, 2F),
(L, F, K)) and both norms. Bound: the bytes of the o, w1|w3 and w2 matrices
at decode-sized M (<= 128 rows; 38.8 MB a W8 TinyLlama-1.1B layer, 11.6 us
at 3.35 TB/s). Design: the row kernels of the MLP block with a prologue
stage: the o-proj matvec on the int8 tensor-core tile core (csrc/tc_tile.cuh;
each weight byte once from device memory), whose epilogue runs the affine
bracket, the four optional fake-quant sites and the residual add into a
(M, K) buffer; a grid barrier, then the MLP block's norm, w13 and w2 stages.

meta (46 floats) = the JAX engine's _mlp_block_meta (32) then _otail_meta_ext
(14): [32..33] the a8 encoding (pv_bmm output), [34..36] the o output fq,
[37..45] resid_add_1 input / input2 / output fq (a site is off when its qmax
entry is 0); site_on: the MLP block's nine static enables, osite_on the four
of (o output, resid_add_1 input, input2, output).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.mlp_block import (
    MLP_META_LEN, check_mlp_packs, check_norm_kind, fused_mlp_block_w4_plain, mlp_args,
    mlp_pack_bits, rows_workspace, stacked_w4)
from mobilequant_tpu_torch.ops.w13_gate import _fq
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, w4a8_matmul_plain


def fused_otail_block_w4_plain(a8: torch.Tensor, x: torch.Tensor, o: dict,
                               norm_w: torch.Tensor, norm_b: torch.Tensor, w13: dict,
                               w2: dict, meta: Sequence[float], act_kind: str = "silu",
                               site_on: tuple = (True,) * 9,
                               osite_on: tuple = (True,) * 4,
                               norm_kind: str = "rmsnorm") -> torch.Tensor:
    """The kernel's function in PyTorch operators, over one layer's packs and
    norm vectors (the JAX kernel's fp32 operation order)."""
    m = [float(v) for v in meta]
    s_oo, s_r1, s_r2, s_ro = osite_on

    def fq(v, i, on):
        return _fq(v, m[i], m[i + 1], m[i + 2]) if on else v

    y = w4a8_matmul_plain(a8, o["wq"], o["scale"], o["offset"], o["colsum"],
                          o.get("bias"), m[32], m[33])
    y = fq(y, 34, s_oo)
    xr = fq(x.to(torch.float32), 37, s_r1)
    y = fq(y, 40, s_r2)
    resid = fq(xr + y, 43, s_ro)
    return fused_mlp_block_w4_plain(resid, norm_w, norm_b, w13, w2, m[:32], act_kind,
                                    site_on, norm_kind)


def fused_otail_block_w4(a8: torch.Tensor, x: torch.Tensor, o: dict,
                         norm_w: torch.Tensor, norm_b: torch.Tensor, w13: dict,
                         w2: dict, meta: Sequence[float], layer: int,
                         act_kind: str = "silu", site_on: tuple = (True,) * 9,
                         osite_on: tuple = (True,) * 4,
                         norm_kind: str = "rmsnorm") -> torch.Tensor:
    """a8 (M, Ko) int8 attention output + x (M, K) fp32 layer input ->
    the layer's output (M, K), for layer `layer` of the stacked W4 packs
    (o wq (L, Ko/2, K), w13, w2) or W8 packs (o wq (L, Ko, K), ...) and norm
    vectors (L, K); norm_kind "rmsnorm" or "layernorm". M <= 128."""
    M, K = x.shape
    Ko = a8.shape[1]
    check_mlp_packs(M, K, w13, w2, act_kind, "o-tail")
    check_norm_kind(norm_kind, "o-tail")
    bits = mlp_pack_bits(K, w13, w2)
    o_rows = Ko // 2 if bits == 4 else Ko
    if a8.shape[0] != M or a8.dtype != torch.int8 or o["wq"].shape[1] != o_rows \
            or o["wq"].shape[2] != K or Ko % 64:
        raise NotImplementedError(f"o-tail kernel: a8 {tuple(a8.shape)}, o "
                                  f"{tuple(o['wq'].shape)} (W{bits}, Ko % 64 == 0)")
    if len(meta) != MLP_META_LEN:
        raise ValueError(f"o-tail meta of {len(meta)} entries, expected {MLP_META_LEN}")
    if x.device.type == "cpu":
        fused_otail_block_w4.plain_calls += 1
        return fused_otail_block_w4_plain(a8, x, layer_pack(o, layer), norm_w[layer],
                                          norm_b[layer], layer_pack(w13, layer),
                                          layer_pack(w2, layer), meta, act_kind, site_on,
                                          osite_on, norm_kind)
    dev = _build.require_cuda(a8, x, o["wq"], norm_w, w13["wq"], w2["wq"])
    lib = _build.lib()
    keep = []
    a, out = mlp_args(x, norm_w, norm_b, w13, w2, meta, layer, act_kind, keep, norm_kind)
    a8c = _build.aligned(a8)
    keep.append(a8c)
    a.a8 = a8c.data_ptr()
    a.o = stacked_w4(o, keep, Ko)
    F = w13["wq"].shape[2] // 2
    a.ws = rows_workspace(dev, (M,), ((Ko, K, False), (K, 2 * F, True),
                                      (F, K, False))).data_ptr()
    code = lib.mqt_fused_otail(ctypes.addressof(a), _build.stream_ptr(dev))
    _build.check(code, "fused_otail_block_w4")
    fused_otail_block_w4.launches += 1
    return out


fused_otail_block_w4.launches = 0
fused_otail_block_w4.plain_calls = 0
