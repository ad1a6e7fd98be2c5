"""Prefill qkv projection with the attention-input epilogue in one kernel:
W4A8 or W8A8 matmul -> per-column output fake-quant -> rotate-half RoPE
(partial rotary) -> per-segment int8 quantization of q | k | v.

Kernel: csrc/qkv_rope.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_qkv.py qkv_rope_stacked (_qkv_rope_kernel), in both
of its editions: the weight bits come from the pack's shape (W4 (K/2, Nq)
nibble-packed, W8 (K, Nq)), as in the JAX kernel. Bound: integer operations
of the matmul at prefill M. Design: the int8 tensor-core tile core
(csrc/tc_tile.cuh: mma.sync on 64 x 128 tiles over a cp.async ring,
templated on the weight bits) on the launch `tile_plan` gives, split over K
where the tiles leave SMs idle (the splits of a tile one thread-block
cluster meeting in shared memory); the tile is then staged in shared memory
so each output reads its RoPE partner column: a 128-column tile holds whole
heads up to head_dim 128, and at head_dim 256 (full rotary, partner 128
columns away) the columns [64 p, 64 p + 64) and [128 + 64 p, 192 + 64 p) of
a head; the int8 rows it writes are the KV cache, so the
epilogue rounds exactly as the plain version does.

Operands (as the JAX engine builds them): ofq (4, Nq) = [scale, offset, clip
max, enabled] of the output fake-quant; outq (3, Nq) = [quant scale, quant
offset, rope mask]; cs (M, 2·head_dim) = [cos | sign-baked sin] per row.
"""

from __future__ import annotations

from typing import Optional

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.w4a8_matmul import (
    CHUNK_ROWS, TILE_COLS, TILE_ROWS, affine_args, check_w48, layer_pack, split_k,
    w4a8_matmul_plain)


def pick_block_tn(K2w: int, Nq: int, hd: int) -> int:
    """The JAX package's column-block width of its qkv kernel
    (pallas_qkv._pick_block_tn): a multiple of max(128, hd) dividing Nq with
    a K2w x TN weight block of at most ~3 MB; 0: no aligned tiling."""
    step = max(128, hd)
    cap = (3 * 1024 * 1024) // max(K2w, 1)
    for t in range(min(cap, Nq) // step * step, step - 1, -step):
        if Nq % t == 0:
            return t
    return 0


def qkv_rope_supported(Nq: int, head_dim: int, rotary_dim: int, K2w: int) -> bool:
    """The JAX engine's gate of its qkv epilogue kernel
    (pallas_qkv.qkv_kernel_supported); K2w: the pack's weight rows (K/2 for
    W4)."""
    return (head_dim % 2 == 0 and rotary_dim % 2 == 0
            and Nq % max(128, head_dim) == 0
            and pick_block_tn(K2w, Nq, head_dim) > 0)


def qkv_rope_kernel_takes(head_dim: int, rotary_dim: int) -> bool:
    """Head shapes the card's kernel takes: 128-column tiles of whole heads
    (head_dim dividing 128), or at head_dim 256 with full rotary tiles of two
    64-column runs 128 apart, each column beside its RoPE partner."""
    return 128 % head_dim == 0 or (head_dim == 256 and rotary_dim == 256)


def tile_plan(M: int, K: int, Nq: int, sms: int) -> tuple:
    """(column tiles, row tiles, K splits, chunks a split) of the kernel's
    launch: 128 columns by 64 rows a tile, chunks of 64
    packed rows (128 k), the split of csrc/tc_tile.cuh (`split_k`); Nq a
    multiple of 128 and the head shape one `qkv_rope_kernel_takes`."""
    tn, tm = Nq // TILE_COLS, -(-M // TILE_ROWS)
    return (tn, tm) + split_k(tn * tm, -(-(K // 2) // CHUNK_ROWS), sms)


def qkv_rope_plain(h8: torch.Tensor, pack: dict, ofq: torch.Tensor,
                   outq: torch.Tensor, cs: torch.Tensor, h_scale: float,
                   h_offset: float, head_dim: int,
                   rotary_dim: int) -> torch.Tensor:
    """The kernel's function in PyTorch operators (one layer's pack)."""
    y = w4a8_matmul_plain(h8, pack["wq"], pack["scale"], pack["offset"],
                          pack["colsum"], pack.get("bias"), h_scale, h_offset)
    fs, fo, fc, fe = ofq[0], ofq[1], ofq[2], ofq[3]
    q = torch.minimum(torch.clamp(torch.round(y / fs) + fo, min=0.0), fc)
    y = torch.where(fe > 0.5, (q - fo) * fs, y)
    M, Nq = y.shape
    hd, shift = head_dim, rotary_dim // 2
    H = Nq // hd
    yh = y.reshape(M, H, hd)
    d = torch.arange(hd, device=y.device)
    partner = torch.where(d < shift, torch.roll(yh, -shift, dims=2),
                          torch.roll(yh, shift, dims=2))
    roped = yh * cs[:, None, :hd] + partner * cs[:, None, hd:]
    yh = torch.where(outq[2].reshape(H, hd) > 0.5, roped, yh)
    qv = torch.round(yh / outq[0].reshape(H, hd)) + outq[1].reshape(H, hd)
    qv = torch.clamp(qv, 0.0, 255.0) - 128.0
    return qv.to(torch.int8).reshape(M, Nq)


def qkv_rope(h8: torch.Tensor, pack: dict, ofq: torch.Tensor,
             outq: torch.Tensor, cs: torch.Tensor, h_scale: float,
             h_offset: float, layer: Optional[int], head_dim: int,
             rotary_dim: int) -> torch.Tensor:
    """h8 (M, K) shifted int8 -> (M, Nq) shifted int8 q | k | v rows, over
    layer `layer` of the stacked W4 or W8 qkv pack."""
    p = layer_pack(pack, layer)
    M, K, Nq, bits = check_w48(h8, p["wq"])
    if not qkv_rope_supported(Nq, head_dim, rotary_dim, p["wq"].shape[0]):
        raise NotImplementedError(f"qkv_rope: Nq={Nq}, head_dim={head_dim}")
    if h8.device.type == "cpu":
        qkv_rope.plain_calls += 1
        return qkv_rope_plain(h8, p, ofq, outq, cs, h_scale, h_offset,
                              head_dim, rotary_dim)
    dev = _build.require_cuda(h8, p["wq"], ofq, outq, cs)
    if not qkv_rope_kernel_takes(head_dim, rotary_dim):
        raise NotImplementedError(f"qkv_rope kernel: head_dim {head_dim}, "
                                  f"rotary_dim {rotary_dim}")
    lib = _build.lib()
    x = _build.aligned(h8)
    w = _build.aligned(p["wq"], 16)
    sc, of, csum, b, ss = affine_args(p, Nq)
    ofq_ = _build.aligned(ofq.to(torch.float32), 4)
    outq_ = _build.aligned(outq.to(torch.float32), 4)
    cs_ = _build.aligned(cs.to(torch.float32), 4)
    if ofq_.shape != (4, Nq) or outq_.shape != (3, Nq) or cs_.shape != (M, 2 * head_dim):
        raise ValueError("qkv_rope: ofq (4, Nq), outq (3, Nq), cs (M, 2 hd)")
    out = torch.empty((M, Nq), dtype=torch.int8, device=dev)
    _, _, ks, cps = tile_plan(M, K, Nq, _build.sm_count(dev))
    code = lib.mqt_qkv_rope(
        x.data_ptr(), w.data_ptr(), sc.data_ptr(), of.data_ptr(), csum.data_ptr(),
        None if b is None else b.data_ptr(), ofq_.data_ptr(), outq_.data_ptr(),
        cs_.data_ptr(), out.data_ptr(), M, K, Nq, ss,
        float(h_scale), float(h_offset), head_dim, rotary_dim, bits, ks, cps,
        _build.stream_ptr(dev))
    _build.check(code, "qkv_rope")
    qkv_rope.launches += 1
    return out


qkv_rope.launches = 0
qkv_rope.plain_calls = 0
