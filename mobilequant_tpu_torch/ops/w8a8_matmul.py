"""W8A8 matmul for decode-sized rows: shifted-int8 activations × W8 -> fp32.

  out = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum_x + K·o'_x·o_w] + bias

Kernel: csrc/w8a8_matmul.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_matmul.py w8a8_matmul (_w8a8_kernel): the JAX
engine sends W8 projections of at most 32 rows there under its "all" kernel
set (KernelConfig.attn_all() here, flag w8_matmul). Bound: device-memory
bandwidth (the K·N weight bytes dominate at M <= 32). Design: at M <= 8 a
split-K gemv that streams each weight byte once, coalesced along N, with
4x4 byte transposes into dp4a operands; at 8 < M <= 32 the W8 edition of the
shared 64 x 128 dp4a tile core. A layer of a stacked pack is a view at its
offset: no copy.

The wrapper launches the kernel for CUDA tensors and runs w8a8_matmul_plain
for CPU tensors; it never falls back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w4a8_matmul import affine_args, check_w48, layer_pack

MAX_ROWS = 32


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
    """x_q (M <= 32, K) int8 × a W8 pack {wq (K, N), scale, offset, colsum[,
    bias]} -> fp32 (M, N); with `layer`, layer `layer` of a stacked pack
    {wq (L, K, N), ...} (the decoder's projections)."""
    p = layer_pack(pack, layer)
    wq = p["wq"]
    M, K, N, bits = check_w48(x_q, wq)
    if bits != 8:
        raise ValueError(f"w8a8_matmul takes a W8 (K, N) wq, got rows {wq.shape[0]} for K={K}")
    if M > MAX_ROWS:
        raise NotImplementedError(f"w8a8_matmul: M={M} > {MAX_ROWS}")
    if x_q.device.type == "cpu":
        w8a8_matmul.plain_calls += 1
        return w8a8_matmul_plain(x_q, wq, p["scale"], p["offset"], p["colsum"],
                                 p.get("bias"), x_scale, x_offset)
    dev = _build.require_cuda(x_q, wq)
    lib = _build.lib()
    x = _build.aligned(x_q)
    w = _build.aligned(wq, 4)
    sc, of, cs, b, ss = affine_args(p, N)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    tiles = -(-N // 128) * -(-M // 64)
    ws = _build.WORKSPACE.get(dev, 65 * tiles + M * N + 64)
    code = lib.mqt_w8a8_matmul(
        x.data_ptr(), w.data_ptr(), sc.data_ptr(), of.data_ptr(), cs.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), ws.data_ptr(),
        M, K, N, ss, float(x_scale), float(x_offset), _build.stream_ptr(dev))
    _build.check(code, "w8a8_matmul")
    w8a8_matmul.launches += 1
    return out


w8a8_matmul.launches = 0
w8a8_matmul.plain_calls = 0
