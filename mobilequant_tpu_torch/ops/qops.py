"""Integer compute primitives (the port of mobilequant_tpu/ops/qops.py).

These are the plain building blocks of the integer engine: int8 activations,
int8/int4 weights, exact integer dot products and the affine zero-point
corrections that make the engine an exact re-expression of the fake-quant
simulation, `(x_q-o_x)(w_q-o_w)·s_x·s_w ≡ fq(x)@fq(w)`.

Conventions (identical to the JAX package):
  * asymmetric uint8 values are stored shifted by −128 as int8; the stored
    zero-point is shifted the same way (o'_x = o_x − 128);
  * weights are (in, out); W4 is nibble-packed (in/2, out) in the UNSIGNED
    BLOCK layout: packed row k holds row k (low nibble) and row k + in/2 (high
    nibble), both unsigned 0..15, the 4-bit zero-point absorbing the sign.

Host scalars. Static activation ranges are frozen at pack time, so the engine
hands them to these functions (and to the kernels) as Python floats holding
fp32 values; scalar arithmetic on them goes through `f32` so that it rounds as
the JAX package's fp32 scalar arithmetic does.

Exact integer dots. PyTorch's CPU int8 matmul returns int8 and wraps, and CUDA
has no integer matmul, so `int_dot` multiplies in float64 on both devices:
every partial sum is an integer below 2^53, hence exact in any order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.quant.quantizer import (
    QuantConfig, _group_reshape, scale_offset_from_min_max, true_div, weight_min_max,
)


def f32(v) -> float:
    """A host scalar rounded to fp32 (returned as a Python float, exact)."""
    return float(np.float32(v))


def int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of int8 tensors -> fp32 (the int32 accumulator of
    the JAX package converted to fp32, which rounds the same way)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def rowsum_i8(x: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis of an int8 tensor, as fp32 (keepdim)."""
    return x.to(torch.int32).sum(dim=-1, keepdim=True).to(torch.float32)


def quantize_act(x: torch.Tensor, scale: float, offset: float, qmax=255.0) -> torch.Tensor:
    """fp -> shifted int8 (stored uint8 domain − 128). qmax: the clip bound,
    255 for 8-bit values, 15 for 4-bit KV-cache values; a tensor gives
    per-segment bounds (broadcast against x)."""
    q = torch.round(true_div(x.to(torch.float32), scale)) + offset
    if isinstance(qmax, torch.Tensor):
        q = torch.minimum(torch.clamp(q, min=0.0), qmax)
    else:
        q = torch.clamp(q, 0.0, qmax)
    return (q - 128.0).to(torch.int8)


def pack_nibbles(q_i8: torch.Tensor) -> torch.Tensor:
    """(..., K, N) int8 in [-8, 15] -> (..., K/2, N) int8, two per byte, block
    layout: packed row k = row k (low nibble) | row k + K/2 (high nibble)."""
    if q_i8.shape[-2] % 2:
        raise ValueError("K must be even for nibble packing")
    half = q_i8.shape[-2] // 2
    lo = q_i8[..., :half, :].to(torch.int32) & 0x0F
    hi = q_i8[..., half:, :].to(torch.int32) & 0x0F
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) packed bytes -> (..., K, N) int8 in [0, 15]."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.cat([lo, hi], dim=-2)


# ---------------------------------------------------------------------------
# int4 KV cache (nibble-packed along the SEQUENCE axis, hd-major)
# ---------------------------------------------------------------------------
# The JAX package's layout, kept as it is: a 4-bit cache (L, B, Hkv, hd, S/2)
# whose byte at column c holds position c in its low nibble and position
# c + S/2 in its high nibble, raw values q4 in [0, 15]. Unpacked working rows
# use the int8 cache's shifted convention (q4 − 128), so every affine
# correction of the 8-bit path applies unchanged; (q4 − 128) & 0x0F == q4, so
# shifted rows pack with the same bit operations as raw nibbles. On Hopper the
# layout coalesces as it did on the TPU: K columns run along S for the QK dot,
# V rows along S for P·V.


def unpack_kv_s(packed: torch.Tensor) -> torch.Tensor:
    """(..., hd, S/2) packed KV -> (..., S, hd) shifted int8 (q4 − 128)."""
    q = unpack_nibbles(packed.transpose(-1, -2))
    return (q.to(torch.int32) - 128).to(torch.int8)


def pack_kv_s(k_shifted: torch.Tensor) -> torch.Tensor:
    """(..., S, hd) shifted int8 4-bit values -> (..., hd, S/2) packed."""
    return pack_nibbles(k_shifted).transpose(-1, -2).contiguous()


def kv_colsums_packed(packed: torch.Tensor) -> torch.Tensor:
    """Σ_hd of the shifted unpacked values, from the packed bytes in one pass:
    (..., hd, S/2) -> (..., S) fp32 in sequence order ([lo | hi] planes)."""
    hd = packed.shape[-2]
    lo = (packed & 0x0F).sum(-2, dtype=torch.int32)
    hi = ((packed >> 4) & 0x0F).sum(-2, dtype=torch.int32)
    return (torch.cat([lo, hi], -1) - 128 * hd).to(torch.float32)


def kv_flush_packed(cache_p: torch.Tensor, staged: torch.Tensor,
                    at: torch.Tensor) -> torch.Tensor:
    """Merge a chunk's staged rows into the packed cache, in place.

    cache_p (L, B, Hkv, hd, S/2) packed; staged (L, B, Hkv, cs, hd) shifted
    4-bit rows; at (B,) start positions (staged column j lands at position
    at[b] + j, which maps to column p mod S/2 of nibble plane p div S/2, so a
    chunk may straddle the planes). Per plane, one window of min(cs, S/2)
    columns per sequence is read, merged and written back: the merge touches
    only the chunk's columns, never the whole cache. The planes are merged one
    after the other, so where cs > S/2 and one chunk writes both nibbles of a
    byte, neither write loses the other."""
    L, B, Hkv, hd, S2 = cache_p.shape
    cs = staged.shape[3]
    w = min(cs, S2)
    dev = cache_p.device
    at = torch.as_tensor(at, device=dev).to(torch.long)[:, None]          # (B, 1)
    j = torch.arange(w, device=dev)[None]                                  # (1, w)
    bi = torch.arange(B, device=dev)[:, None]
    raw = (staged.to(torch.int32) & 0x0F).permute(1, 3, 0, 2, 4)          # (B, cs, L, Hkv, hd)
    view = cache_p.permute(1, 4, 0, 2, 3)                                  # (B, S2, L, Hkv, hd)
    for plane in (0, 1):
        base = plane * S2
        cols = torch.clamp(at - base, 0, S2 - w) + j                       # (B, w)
        p = base + cols                                                    # absolute positions
        sel = ((p >= at) & (p < at + cs))[:, :, None, None, None]
        new = raw[bi, torch.clamp(p - at, 0, cs - 1)]
        win = view[bi, cols].to(torch.int32)
        lo, hi = win & 0x0F, (win >> 4) & 0x0F
        if plane == 0:
            lo = torch.where(sel, new, lo)
        else:
            hi = torch.where(sel, new, hi)
        view[bi, cols] = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return cache_p


def pack_weight(w: torch.Tensor, qcfg: QuantConfig) -> dict:
    """Quantize one (in, out) fp weight to its integer representation.

    Returns {wq, scale, offset, colsum}: wq int8 (nibble-packed (in/2, out) for
    4 bits); scale/offset fp32 () per-tensor, (1, out) per-channel or
    (G, 1, out) grouped along the input axis (the auto_gptq W4 g128 layout);
    offset is the shifted zero-point; colsum the per-out-channel sum of the
    stored integer values, (G, out) per group when grouped."""
    grouped = qcfg.is_per_channel and qcfg.group_size != -1
    if qcfg.group_size != -1 and not qcfg.is_per_channel:
        raise ValueError("group_size requires is_per_channel")
    wf = w.to(torch.float32)
    scale, offset = scale_offset_from_min_max(*weight_min_max(wf, qcfg), qcfg)
    x = _group_reshape(wf, qcfg.group_size) if grouped else wf
    q = torch.clamp(torch.round(x / scale) + offset, qcfg.qmin, qcfg.qmax).reshape(wf.shape)
    if qcfg.bitwidth == 4:
        shift = float(qcfg.qmin)        # unsigned nibbles q - qmin in [0, 15]
    elif qcfg.is_symmetric:
        shift = 0.0
    else:
        shift = float(2 ** (qcfg.bitwidth - 1))   # uint8 stored as int8 − 128
    q = q - shift
    q_i8 = q.to(torch.int8)
    wq = pack_nibbles(q_i8) if qcfg.bitwidth == 4 else q_i8
    colsum = _group_reshape(q, qcfg.group_size).sum(dim=-2) if grouped else q.sum(dim=-2)
    return {"wq": wq, "scale": scale.to(torch.float32),
            "offset": (offset - shift).to(torch.float32), "colsum": colsum}


def int_linear(x_q: torch.Tensor, x_scale: float, x_offset: float, pack: dict,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Integer matmul with affine corrections -> fp32:

      out = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum_x + K·o'_x·o_w] + bias

    x_q (..., K) shifted int8 with host-float (scale, offset) in the uint8
    domain; pack from pack_weight (one layer)."""
    K = x_q.shape[-1]
    wq = pack["wq"]
    if wq.shape[0] * 2 == K:
        wq = unpack_nibbles(wq)
    acc = int_dot(x_q, wq)
    ox = f32(np.float32(x_offset) - np.float32(128.0))
    ow = pack["offset"].reshape(-1)
    sw = pack["scale"].reshape(-1)
    acc = acc - ox * pack["colsum"] - ow * rowsum_i8(x_q) + f32(K * np.float32(ox)) * ow
    out = acc * (x_scale * sw)
    if bias is not None:
        out = out + bias
    return out


def dynamic_quantize_act(x: torch.Tensor):
    """Per-row symmetric dynamic int8 quantization: (q int8, scale (..., 1));
    the scale max|x| / 127 one true division (true_div), as the kernels that
    fold the head compute it."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = true_div(torch.clamp(amax, min=1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0)
    return q.to(torch.int8), scale


def int_head_linear(x: torch.Tensor, pack: dict,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized lm_head: dynamic per-token symmetric A8 × per-channel
    symmetric W8/W4 -> fp32 logits, out = s_x·s_w·(x_q @ w_q − o_w·Σ_k x_q)."""
    x_q, sx = dynamic_quantize_act(x)
    K = x_q.shape[-1]
    wq = pack["wq"]
    if wq.shape[0] * 2 == K:
        wq = unpack_nibbles(wq)
    acc = int_dot(x_q, wq)
    ow = pack["offset"].reshape(-1)
    sw = pack["scale"].reshape(-1)
    acc = acc - ow * rowsum_i8(x_q)
    out = acc * (sx * sw)
    if bias is not None:
        out = out + bias
    return out


def dequant_weight(wq: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                   K: int) -> torch.Tensor:
    """A weight-only pack's fp32 weight (..., K, N): wq (..., K or K/2, N),
    scale / offset per tensor (...), per channel (..., 1, N) or grouped
    (..., G, 1, N) along the input axis; w = (q − offset)·scale."""
    if wq.shape[-2] * 2 == K:
        wq = unpack_nibbles(wq)
    wf = wq.to(torch.float32)
    lead, N = wf.shape[:-2], wf.shape[-1]
    if scale.dim() == len(lead) + 3:                      # grouped (..., G, 1, N)
        G = scale.shape[-3]
        wg = wf.reshape(*lead, G, K // G, N)
        return ((wg - offset) * scale).reshape(*lead, K, N)
    sh = (*lead, 1, -1)
    return (wf - offset.reshape(sh)) * scale.reshape(sh)


def weight_only_linear(x: torch.Tensor, pack: dict,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
    """W4A16 / W8A16: fp activations × one layer's integer weight dequantized
    on the fly, x.float() @ (q − offset)·scale + bias, returned in x's dtype
    (scale / offset per tensor (), per channel (1, N) or grouped (G, 1, N))."""
    w = dequant_weight(pack["wq"], pack["scale"], pack["offset"], x.shape[-1])
    y = torch.matmul(x.to(torch.float32), w)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def weight_only_expert_linear(x: torch.Tensor, pack: dict,
                              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Weight-only MoE expert projection over per-expert stacks wq (E, K, N)
    (W4: (E, K/2, N)), scale / offset (E,), (E, 1, N) or grouped (E, G, 1, N):
    x (B, T, K) -> (B, T, E, N) (w1 / w3), x (B, T, E, K) -> (B, T, E, N)
    (w2). Plain PyTorch, as the JAX package leaves it to XLA."""
    w = dequant_weight(pack["wq"], pack["scale"], pack["offset"], x.shape[-1])
    xf = x.to(torch.float32)
    if x.dim() == 3:
        y = torch.einsum("btd,edf->btef", xf, w)
    else:
        y = torch.einsum("btef,efd->bted", xf, w)
    if bias is not None:
        y = y + bias
    return y.to(x.dtype)


def int_matmul_qk(q_i8: torch.Tensor, k_i8: torch.Tensor, q_scale: float,
                  q_offset: float, k_scale: float, k_offset: float,
                  k_colsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized Q·Kᵀ: q (B,Hkv,GT,hd) × k (B,Hkv,S,hd) -> fp32 (B,Hkv,GT,S).
    k_colsum: optional precomputed Σ_hd k (B,Hkv,S) fp32 (the staged decode
    path computes it once per chunk, while the cache is read-only)."""
    hd = q_i8.shape[-1]
    acc = int_dot(q_i8, k_i8.transpose(-1, -2))
    oq = f32(np.float32(q_offset) - np.float32(128.0))
    ok = f32(np.float32(k_offset) - np.float32(128.0))
    qsum = rowsum_i8(q_i8)                                   # (B,Hkv,GT,1)
    ksum = rowsum_i8(k_i8)[..., 0] if k_colsum is None else k_colsum
    acc = (acc - ok * qsum - oq * ksum[:, :, None, :]
           + f32(np.float32(hd) * np.float32(oq) * np.float32(ok)))
    return acc * f32(np.float32(q_scale) * np.float32(k_scale))


def int_matmul_pv(p: torch.Tensor, v_i8: torch.Tensor, v_scale: float,
                  v_offset: float) -> torch.Tensor:
    """P·V with int8 V: p fp32 (B,Hkv,GT,S) × v (B,Hkv,S,hd) -> (B,Hkv,GT,hd),
    P@V = (P@v_shifted − (o_v−128)·Σ_s P)·s_v (fp32 product)."""
    acc = torch.matmul(p, v_i8.to(torch.float32))
    ov = f32(np.float32(v_offset) - np.float32(128.0))
    acc = acc - ov * p.sum(dim=-1, keepdim=True)
    return acc * v_scale
