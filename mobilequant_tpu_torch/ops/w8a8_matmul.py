"""W8A8 matmul: shifted-int8 activations × W8 -> fp32.

  out = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum_x + K·o'_x·o_w] + bias

Kernel: csrc/w8a8_matmul.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_matmul.py w8a8_matmul (_w8a8_kernel) and, as it,
takes any M. The JAX engine sends W8 projections of at most 32 rows there
under its "all" kernel set (KernelConfig.attn_all() here, flag w8_matmul;
the gate is runtime/engine.W8_MATMUL_ROWS). Bound: device-memory bandwidth
at decode rows (the K·N weight bytes dominate at M <= 32), integer
operations at prefill M. Design: at every row count the int8 tensor-core
tile core (csrc/tc_tile.cuh's tc_matmul_kernel: mma.sync on 64 x 128 tiles
over a cp.async ring, the products of rows past M skipped) runs the launch
`tile_plan` gives, split over K where the tiles leave SMs idle, the splits
of a tile one thread-block cluster that meets in shared memory (no
workspace, no atomics). A width N that is not a multiple of 16 takes the
tile's 4-byte-copy edition, counted apart in `edge_launches`. A layer of a
stacked pack is a view at its offset: no copy.

The wrapper launches the kernel for CUDA tensors and runs w8a8_matmul_plain
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w4a8_matmul import (
    affine_args, check_w48, layer_pack, tile_plan)

# The launch is rows 1 / 2's `tile_plan` (about one block an SM, at least 4
# chunks a split, at most 8) at every row count: no decode fork. Measured on
# an H100 80GB HBM3 at 700 W against the dp4a gemv that served M <= 8 before
# (scripts/torch_ab_fused_rows.py --rows w8, the two trees in one call;
# PERF.md §6): at M = 1, 2, 4, 8 the tile took 34-80% less time on
# every TinyLlama projection (qkv 0.0135 / 0.0275 -> 0.0081 / 0.0084 ms at
# M = 1 / 8, w13 0.0335 / 0.0723 -> 0.0144 / 0.0148), and forced splits of
# 1, 2, 4, 8 at M = 1, 8, 32 ran fastest at the plan's own split.


def w8a8_matmul_plain(x_q: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor, colsum: torch.Tensor,
                      bias: Optional[torch.Tensor], x_scale: float,
                      x_offset: float) -> torch.Tensor:
    """The kernel's function in PyTorch operators: x_q (M, K) int8, wq (K, N)
    int8, scale/offset per tensor or (1, N) / (N,), colsum/bias (N,)."""
    K = x_q.shape[-1]
    acc = int_dot(x_q, wq)
    ox = f32(np.float32(x_offset) - np.float32(128.0))
    ow = offset.reshape(-1)
    sw = scale.reshape(-1)
    acc = (acc - ox * colsum.reshape(-1) - ow * rowsum_i8(x_q)
           + f32(K * np.float32(ox)) * ow)
    out = acc * (x_scale * sw)
    if bias is not None:
        out = out + bias.reshape(-1)
    return out


def w8a8_matmul(x_q: torch.Tensor, pack: dict, x_scale: float, x_offset: float,
                layer: Optional[int] = None) -> torch.Tensor:
    """x_q (M, K) int8 × a W8 pack {wq (K, N), scale, offset, colsum[,
    bias]} -> fp32 (M, N); with `layer`, layer `layer` of a stacked pack
    {wq (L, K, N), ...} (the decoder's projections)."""
    p = layer_pack(pack, layer)
    wq = p["wq"]
    M, K, N, bits = check_w48(x_q, wq)
    if bits != 8:
        raise ValueError(f"w8a8_matmul takes a W8 (K, N) wq, got rows {wq.shape[0]} for K={K}")
    if x_q.device.type == "cpu":
        w8a8_matmul.plain_calls += 1
        return w8a8_matmul_plain(x_q, wq, p["scale"], p["offset"], p["colsum"],
                                 p.get("bias"), x_scale, x_offset)
    dev = _build.require_cuda(x_q, wq)
    lib = _build.lib()
    edge = N % 16 != 0
    x = _build.aligned(x_q)
    w = _build.aligned(wq, 4 if edge else 16)
    sc, of, cs, b, ss = affine_args(p, N)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    _, _, ks, cps = tile_plan(M, K, N, _build.sm_count(dev))
    code = lib.mqt_w8a8_matmul(
        x.data_ptr(), w.data_ptr(), sc.data_ptr(), of.data_ptr(), cs.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), M, K, N, ss,
        float(x_scale), float(x_offset), ks, cps, _build.stream_ptr(dev))
    _build.check(code, "w8a8_matmul")
    w8a8_matmul.launches += 1
    w8a8_matmul.edge_launches += edge
    return out


w8a8_matmul.launches = 0
w8a8_matmul.plain_calls = 0
w8a8_matmul.edge_launches = 0
