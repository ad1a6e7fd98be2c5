"""W4A8 matmul: shifted-int8 activations × nibble-packed W4 -> fp32.

  out = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum_x + K·o'_x·o_w] + bias

Kernel: csrc/w4a8_matmul.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_matmul.py w4a8_matmul (_w4a8_kernel; wrapper
`w4a8_matmul`) and w4a8_matmul_stacked (_w4a8_kernel_stacked; wrapper
`w4a8_matmul_stacked`), each wrapper with its own counts. Bound: device-memory bandwidth at
decode (M <= 8: the K/2·N packed weight bytes dominate), integer operations at
prefill M. Design: the decode path streams each weight byte once, coalesced
along N, unpacks nibbles in registers and splits K across blocks so that even
a 2048-wide projection fills the card; above 8 rows the int8 tensor-core tile
core (csrc/tc_tile.cuh: mma.sync on 64 x 128 tiles over a cp.async ring)
runs the launch `tile_plan` gives, split over K where the tiles leave SMs
idle, the splits of a tile one thread-block cluster that meets in shared
memory (no workspace). Its weights move in 16-byte copies; a width N that is not a multiple
of 16 (the rows then not 16-byte aligned) takes the tile's 4-byte-copy
edition, chosen here by shape and counted apart in `edge_launches`. The
stacked form of the JAX package becomes a layer offset on the weight pointer,
so no per-layer weight copy exists to avoid.

Both wrappers launch the kernel for CUDA tensors and run `w4a8_matmul_plain`
for CPU tensors; they never fall back from one to the other.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8, unpack_nibbles


def weight_bits(wq: torch.Tensor, K: int) -> int:
    """4 for a nibble-packed (..., K/2, N) weight, 8 for a (..., K, N) one
    (the JAX package's shape rule)."""
    rows = wq.shape[-2]
    if rows * 2 == K:
        return 4
    if rows == K:
        return 8
    raise ValueError(f"weight rows {rows} match neither W4 nor W8 for K={K}")


def w4a8_matmul_plain(x_q: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                      offset: torch.Tensor, colsum: torch.Tensor,
                      bias: Optional[torch.Tensor], x_scale: float,
                      x_offset: float) -> torch.Tensor:
    """The kernel's function in PyTorch operators: x_q (M, K) int8, wq (K/2, N)
    packed (or a (K, N) W8 matrix: the plain version of the W8 editions of the
    kernels that call it), scale/offset (1, N), (N,) or per-tensor,
    colsum/bias (N,)."""
    K = x_q.shape[-1]
    acc = int_dot(x_q, unpack_nibbles(wq) if weight_bits(wq, K) == 4 else wq)
    return int_affine(acc, rowsum_i8(x_q), scale, offset, colsum, bias, x_scale, x_offset, K)


def int_affine(acc: torch.Tensor, rowsum: torch.Tensor, scale: torch.Tensor,
               offset: torch.Tensor, colsum: torch.Tensor, bias: Optional[torch.Tensor],
               x_scale: float, x_offset: float, K: int) -> torch.Tensor:
    """The affine epilogue of an integer matmul over K inputs, in the JAX
    engine's fp32 order: acc (M, N) and the activation row sums (M, 1) as
    fp32 -> s_x·s_w·[acc − o'_x·colsum − o_w·rowsum + K·o'_x·o_w] + bias."""
    ox = f32(np.float32(x_offset) - np.float32(128.0))
    ow = offset.reshape(-1)
    sw = scale.reshape(-1)
    acc = (acc - ox * colsum.reshape(-1) - ow * rowsum
           + f32(K * np.float32(ox)) * ow)
    out = acc * (x_scale * sw)
    if bias is not None:
        out = out + bias.reshape(-1)
    return out


def layer_pack(pack: dict, layer: Optional[int]) -> dict:
    """Layer `layer` of a stacked pack as views (no copy); the pack itself when
    layer is None."""
    if layer is None:
        return pack
    return {k: v[layer] for k, v in pack.items()
            if isinstance(v, torch.Tensor) and v.dim() > 0}


def _vec(v: torch.Tensor, N: int):
    """(pointer-ready tensor, stride) of a per-column or per-tensor vector."""
    v = v.reshape(-1)
    if v.numel() == 1:
        return v, 0
    if v.numel() != N:
        raise ValueError(f"vector of {v.numel()} entries for N={N}")
    return _build.aligned(v, 4), 1


def affine_args(pack: dict, N: int):
    """Pointer-ready (scale, offset, colsum, bias, stride) of one layer's pack."""
    sc, ss = _vec(pack["scale"].to(torch.float32), N)
    of, os_ = _vec(pack["offset"].to(torch.float32), N)
    if ss != os_:
        raise ValueError("scale and offset must both be per-tensor or per-channel")
    cs = _build.aligned(pack["colsum"].reshape(-1).to(torch.float32), 4)
    b = pack.get("bias")
    b = None if b is None else _build.aligned(b.reshape(-1).to(torch.float32), 4)
    return sc, of, cs, b, ss


def check_w48(x_q: torch.Tensor, wq: torch.Tensor) -> tuple:
    """(M, K, N, bits) of x_q (M, K) int8 times a W4 (K/2, N) or W8 (K, N)
    int8 matrix; raises on shapes the tile kernels do not take."""
    if x_q.dim() != 2 or x_q.dtype != torch.int8 or wq.dtype != torch.int8 or wq.dim() != 2:
        raise ValueError("expected x_q (M, K) int8 and wq (K/2, N) or (K, N) int8")
    M, K = x_q.shape
    bits = weight_bits(wq, K)
    N = wq.shape[1]
    if K % 64 or N % 4:
        raise NotImplementedError(f"the int8 tile kernels take K % 64 == 0 and N % 4 == 0 "
                                  f"(K={K}, N={N})")
    return M, K, N, bits


GEMV_ROWS = 8                                      # at most this many rows: the decode path
TILE_ROWS, TILE_COLS, CHUNK_ROWS = 64, 128, 64     # csrc/tc_tile.cuh TC_BM, TC_BN, TC_KP
MAX_SPLITS = 8       # TC_MAX_KS: the K splits of a tile are one (portable) thread-block cluster


def split_k(tiles: int, nchunks: int, sms: int) -> tuple:
    """(K splits, chunks a split) of a tile launch (csrc/tc_tile.cuh): one
    split once the tiles fill the SMs, else about one block an SM, at most
    MAX_SPLITS and at least four chunks a split (at TinyLlama's M=128 o, w2
    and qkv on an H100, 4 splits ran faster than 2 or 8: PERF.md §6)."""
    ks = 1 if tiles >= sms else max(1, min(MAX_SPLITS, -(-sms // tiles), nchunks // 4))
    cps = -(-nchunks // ks)
    return -(-nchunks // cps), cps


def tile_plan(M: int, K: int, N: int, sms: int) -> tuple:
    """(column tiles, row tiles, K splits, chunks a split) of the tile
    kernel's launch above GEMV_ROWS rows: 128 columns by 64 rows a tile,
    chunks of 64 packed rows (128 k), the last column tile ragged."""
    tn, tm = -(-N // TILE_COLS), -(-M // TILE_ROWS)
    return (tn, tm) + split_k(tn * tm, -(-(K // 2) // CHUNK_ROWS), sms)


def workspace_ints(M: int, N: int) -> int:
    """Ints of the decode path's split-K workspace (the layout of
    csrc/tc_tile.cuh's tc_workspace_reduce): a counter and 64 row sums a
    128-column tile, then the (M, N) int32 accumulators."""
    return 65 * -(-N // TILE_COLS) + M * N


def check_w4(x_q: torch.Tensor, wq: torch.Tensor) -> tuple:
    M, K, N, bits = check_w48(x_q, wq)
    if bits != 4:
        raise ValueError(f"packed wq rows {wq.shape[0]} do not match K={K}")
    return M, K, N


def w4a8_matmul(x_q: torch.Tensor, pack: dict, x_scale: float,
                x_offset: float) -> torch.Tensor:
    """x_q (M, K) int8 × a W4 pack {wq (K/2, N), scale, offset, colsum[, bias]}
    -> fp32 (M, N): the JAX package's w4a8_matmul (the quantized head's form;
    its pack has no bias)."""
    return _run(w4a8_matmul, x_q, pack, x_scale, x_offset)


def w4a8_matmul_stacked(x_q: torch.Tensor, pack: dict, x_scale: float, x_offset: float,
                        layer: int) -> torch.Tensor:
    """x_q (M, K) int8 × layer `layer` of a stacked W4 pack {wq (L, K/2, N),
    scale, offset, colsum, bias} -> fp32 (M, N): the JAX package's
    w4a8_matmul_stacked (the decoder's projections). The same kernel as
    w4a8_matmul, at the layer's offset."""
    return _run(w4a8_matmul_stacked, x_q, layer_pack(pack, layer), x_scale, x_offset)


def _run(counted, x_q: torch.Tensor, p: dict, x_scale: float,
         x_offset: float) -> torch.Tensor:
    """The kernel (CUDA tensors) or its plain version (CPU tensors), counted
    on the wrapper `counted`."""
    M, K, N = check_w4(x_q, p["wq"])
    if x_q.device.type == "cpu":
        counted.plain_calls += 1
        return w4a8_matmul_plain(x_q, p["wq"], p["scale"], p["offset"],
                                 p["colsum"], p.get("bias"), x_scale, x_offset)
    dev = _build.require_cuda(x_q, p["wq"])
    lib = _build.lib()
    x = _build.aligned(x_q)
    tiled = M > GEMV_ROWS
    edge = tiled and N % 16 != 0
    w = _build.aligned(p["wq"], 16 if tiled and not edge else 4)
    sc, of, cs, b, ss = affine_args(p, N)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if tiled:
        ws, (_, _, ks, cps) = None, tile_plan(M, K, N, _build.sm_count(dev))
    else:
        ws, ks, cps = _build.WORKSPACE.get(dev, workspace_ints(M, N)).data_ptr(), 0, 0
    code = lib.mqt_w4a8_matmul(
        x.data_ptr(), w.data_ptr(), sc.data_ptr(), of.data_ptr(), cs.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), ws,
        M, K, N, ss, float(x_scale), float(x_offset), ks, cps, _build.stream_ptr(dev))
    _build.check(code, counted.__name__)
    counted.launches += 1
    counted.edge_launches += edge
    return out


w4a8_matmul.launches = w4a8_matmul_stacked.launches = 0
w4a8_matmul.plain_calls = w4a8_matmul_stacked.plain_calls = 0
w4a8_matmul.edge_launches = w4a8_matmul_stacked.edge_launches = 0
