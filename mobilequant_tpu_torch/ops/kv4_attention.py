"""Staged decode attention over the nibble-packed int4 KV cache.

One launch per layer computes the whole attention of a chunked-staging decode
step on the int4 cache (runtime/engine.py, kv_bits = 4): scores over the
stale packed cache (positions < pos, in its low and high nibble planes), the
chunk's staged columns (< m_staged) and the step's own row, one shared max,
per-part exp and one denominator, then P·V, reading the cache in its packed
form. Four score parts, in the JAX order:

  cache lo   q · (kp & 15)ᵀ     columns c < pos
  cache hi   q · (kp >> 4)ᵀ     columns c with c + S/2 < pos
  staged     q · skᵀ            columns j < m_staged
  self       q · k_new

  score = (acc − o_k·Σq − o'_q·(Σk + 128·hd) + hd·o'_q·o_k)·cf  [then fq16·1/√hd]

with cf = s_q·s_k/√hd when the qk_bmm output fake-quant is off (s_q·s_k when
it is on). The packed cache holds RAW nibbles (zero-point o_k, the 4-bit
offset); the staged and self rows are shifted (q4 − 128), so their
zero-point is o_k − 128. kcs holds the shifted-domain K column sums in
sequence order (qops.kv_colsums_packed, once per chunk). P·V runs in the raw
V domain: relaxed, att = (Σ e·v / den − o_v)·s_v; strict (the pv_bmm input
fake-quant on), p = fq16(e / den) and att = (Σ p·v − o_v·Σp)·s_v.

Kernel: csrc/kv4_attention.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_kv4.py kv4_decode_attention (_kv4_attn_kernel).
Bound: device-memory bytes (the valid packed K and V columns, their K column
sums, the staged rows). Design: the valid packed columns of one (sequence,
kv head) are split, in words of four columns, into contiguous stripes over a
thread-block cluster of `kv4_cluster_size` blocks (from the shapes only:
B·Hkv, S and the SM count); the last block also takes the staged columns and
the self row. Each block reads its sequence's position on the device, so
nothing is read on the host. A thread per (word, query head) turns four
hd-rows of the word's bytes into dp4a operands of both nibble planes (exact
integer dots); the softmax takes two phases: the blocks' maxima meet in
distributed shared memory into the global max, every block takes
exp(s − m) against it, and the fp64 partial denominators (and ΣP) meet in
rank order, rounded once; P·V keeps fp64 partials of (query head, hd)
outputs a thread, summed over the warps, then over the cluster, rounded
once. Only valid columns are read: a masked column's exp is exactly 0 (the
mask adds neg_inf = −40000), so skipping it changes nothing, in the strict
policy as long as fq16(0) is 0 (the pv_bmm input offset within [0, qmax]);
where it is not, every column is read, masked.

Numerics: the max is exact; the sums that feed an int8 rounding downstream
(the denominator, ΣP, the P·V dots and the self score) are fp64 sums of
terms exact in fp64, rounded once to fp32, in the kernel and in the plain
version below, so the two agree whatever the summation order (an order moves
an fp64 sum by far less than an fp32 step); every other step repeats the JAX
kernel's fp32 operations in its order.
tests/test_torch_decode_attention_numerics.py repeats the kernel's order
(stripes, per-stripe maxima and partial sums) on the CPU against the plain
version.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.decode_attention import (
    GROUPS, SMEM_LIMIT, WARPS, _pv_heads, _stats_bytes, pick_cluster)
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq


def kv4_attn_supported(num_kv_heads: int, max_seq_len: int, head_dim: int,
                       B: int) -> bool:
    """The JAX gate (pallas_kv4.kv4_attn_supported): hd 64 or 128, an even
    S >= 16, a packed K slab per sequence of at most 4 MiB."""
    return (head_dim in (64, 128) and max_seq_len % 2 == 0 and max_seq_len >= 16
            and B >= 1 and num_kv_heads * (max_seq_len // 2) * head_dim <= 4 * 1024 * 1024)


def kv4_attn_smem(G: int, S2: int, cs: int, hd: int, ncl: int) -> int:
    """Shared-memory bytes of the kernel with ncl blocks a (sequence, kv head)
    and cs staged columns: the statistics, and fp64 slots for the scores of a
    stripe's columns in both planes, the staged and the self column (then e
    or P; after P·V the warps' partials)."""
    ww = -(-(S2 // 4) // ncl)
    ldc = (8 * ww + cs + 2) // 2 * 2
    return _stats_bytes(G, hd) + 8 * max(G * ldc, WARPS * _pv_heads(G, hd) * hd)


def kv4_cluster_size(B: int, Hkv: int, S2: int, cs: int, sms: int, G: int, hd: int) -> int:
    """The kernel's blocks a (sequence, kv head) for B sequences of Hkv kv
    heads over S2 packed columns a plane and cs staged columns, on a card of
    `sms` SMs."""
    return pick_cluster(B * Hkv, S2, sms, lambda n: kv4_attn_smem(G, S2, cs, hd, n))


def _consts(meta, hd: int, qk_fq_on: bool) -> dict:
    m = [float(v) for v in meta]
    sq, skk = m[0], m[2]
    oqs = f32(np.float32(m[1]) - np.float32(128.0))
    ok = f32(m[3])
    oks = f32(np.float32(ok) - np.float32(128.0))
    inv = f32(1.0 / math.sqrt(hd))
    sqk = f32(np.float32(sq) * np.float32(skk))
    cf = sqk if qk_fq_on else f32(np.float32(sqk) * np.float32(inv))
    hdo = f32(np.float32(hd) * np.float32(oqs))
    return dict(m=m, oqs=oqs, ok=ok, oks=oks, inv=inv, sqk=sqk, cf=cf,
                c_lo=f32(np.float32(hdo) * np.float32(ok)),
                c_st=f32(np.float32(hdo) * np.float32(oks)),
                ksh=float(128 * hd))


def kv4_decode_attention_plain(q8, kp, vp, kcs, sk, sv, k_new, v_new, meta: Sequence[float],
                               pos, m_staged: int, layer: int, *, qk_fq_on: bool = False,
                               pv_fq_on: bool = False) -> torch.Tensor:
    """The kernel's function in PyTorch operators, over every column with the
    additive masks of the JAX kernel (see kv4_decode_attention for shapes)."""
    BH, G, hd = q8.shape
    B = pos.shape[0]
    Hkv = BH // B
    S2 = kp.shape[3]
    cs = sk.shape[2]
    k = _consts(meta, hd, qk_fq_on)
    m = k["m"]
    dev = q8.device
    qf = q8.to(torch.float32)
    qs = rowsum_i8(q8)                                            # (BH, G, 1)
    posb = pos.to(torch.int64)[:, None].expand(B, Hkv).reshape(BH, 1, 1)
    kpl, vpl = kp[layer], vp[layer]                               # (BH, hd, S2)
    kcl = kcs[layer].to(torch.float32)                            # (BH, S)
    zero = torch.zeros((), device=dev)

    def fq_qk(sc):
        return _fq(sc, m[6], m[7], m[8]) * k["inv"] if qk_fq_on else sc

    def part(k4, ksum, valid):
        acc = int_dot(q8, k4)                                     # (BH, G, S2)
        sc = (acc - k["ok"] * qs - k["oqs"] * (ksum[:, None, :] + k["ksh"]) + k["c_lo"]) * k["cf"]
        return fq_qk(sc) + torch.where(valid, zero, m[12])

    col = torch.arange(S2, device=dev)[None, None, :]
    lg_lo = part(kpl & 0x0F, kcl[:, :S2], col < posb)
    lg_hi = part((kpl >> 4) & 0x0F, kcl[:, S2:], S2 + col < posb)
    skl, svl = sk[layer], sv[layer]                               # (BH, cs, hd) shifted
    acc = int_dot(q8, skl.transpose(-1, -2))                      # (BH, G, cs)
    kss = rowsum_i8(skl).transpose(-1, -2)                        # (BH, 1, cs)
    sc = (acc - k["oks"] * qs - k["oqs"] * kss + k["c_st"]) * k["cf"]
    col2 = torch.arange(cs, device=dev)[None, None, :]
    lg_st = fq_qk(sc) + torch.where(col2 < int(m_staged), zero, m[12])
    kn = k_new.reshape(BH, 1, hd).to(torch.float32)
    prod = (qf - k["oqs"]) * (kn - k["oks"])
    s_self = prod.to(torch.float64).sum(-1, keepdim=True).to(torch.float32) * k["sqk"]
    if qk_fq_on:
        s_self = _fq(s_self, m[6], m[7], m[8])
    lg_self = s_self * k["inv"]                                   # (BH, G, 1)

    mx = torch.maximum(torch.maximum(lg_lo.amax(-1, keepdim=True), lg_hi.amax(-1, keepdim=True)),
                       torch.maximum(lg_st.amax(-1, keepdim=True), lg_self))
    e = torch.cat([torch.exp(lg_lo - mx), torch.exp(lg_hi - mx), torch.exp(lg_st - mx),
                   torch.exp(lg_self - mx)], -1)                  # (BH, G, 2 S2 + cs + 1)
    v_all = torch.cat([(vpl & 0x0F).transpose(-1, -2), ((vpl >> 4) & 0x0F).transpose(-1, -2),
                       svl & 0x0F, v_new.reshape(BH, 1, hd) & 0x0F], 1).to(torch.float64)
    den = e.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    sv_, ov = m[4], m[5]
    if pv_fq_on:
        p = _fq(e / den, m[9], m[10], m[11])
        A = torch.matmul(p.to(torch.float64), v_all).to(torch.float32)
        psum = p.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
        return (A - ov * psum) * sv_
    A = torch.matmul(e.to(torch.float64), v_all).to(torch.float32)
    return (A / den - ov) * sv_


def kv4_decode_attention(q8: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                         kcs: torch.Tensor, sk: torch.Tensor, sv: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor, meta: Sequence[float],
                         pos: torch.Tensor, m_staged: int, layer: int, *,
                         qk_fq_on: bool = False, pv_fq_on: bool = False) -> torch.Tensor:
    """Layer `layer` of a staged decode step over the packed cache, batched over
    BH = B·Hkv (sequence-major) -> att (BH, G, hd) fp32.

    q8 (BH, G, hd) int8 shifted; kp / vp (L, BH, hd, S/2) the layer-stacked
    packed caches (read by layer index, no slice copies); kcs (L, BH, S) fp32
    shifted K column sums; sk / sv (L, BH, cs, hd) int8 shifted staged rows,
    m_staged of them valid; k_new / v_new (BH, hd) (or (BH, 1, hd)) the step's
    shifted rows; meta the 13-float attention meta; pos (B,) int32 chunk-start
    positions. qk_fq_on / pv_fq_on: the policy's qk_bmm output and pv_bmm
    input enables."""
    BH, G, hd = q8.shape
    L, _, _, S2 = kp.shape
    B = pos.shape[0]
    cs = sk.shape[2]
    mst, layer = int(m_staged), int(layer)
    if BH % B or kp.shape != (L, BH, hd, S2) or vp.shape != kp.shape \
            or tuple(kcs.shape) != (L, BH, 2 * S2) or tuple(sk.shape) != (L, BH, cs, hd) \
            or sv.shape != sk.shape or k_new.numel() != BH * hd or v_new.numel() != BH * hd:
        raise ValueError(f"kv4_decode_attention: q {tuple(q8.shape)}, cache {tuple(kp.shape)}, "
                         f"kcs {tuple(kcs.shape)}, staged {tuple(sk.shape)}, pos {tuple(pos.shape)}")
    if not (0 <= mst <= cs and 0 <= layer < L):
        raise ValueError(f"kv4_decode_attention: m_staged {mst} of {cs}, layer {layer} of {L}")
    kw = dict(qk_fq_on=qk_fq_on, pv_fq_on=pv_fq_on)
    if q8.device.type == "cpu":
        kv4_decode_attention.plain_calls += 1
        return kv4_decode_attention_plain(q8, kp, vp, kcs, sk, sv, k_new, v_new, meta, pos,
                                          mst, layer, **kw)
    dev = _build.require_cuda(q8, kp, vp, kcs, sk, sv, k_new, v_new, pos)
    if hd not in (64, 128) or S2 % 4 or G not in GROUPS or q8.dtype != torch.int8 \
            or kp.dtype != torch.int8 or kcs.dtype != torch.float32:
        raise NotImplementedError(f"kv4_decode_attention kernel: hd {hd}, S/2 {S2}, G {G}")
    ncl = kv4_cluster_size(B, BH // B, S2, cs, _build.sm_count(dev), G, hd)
    if kv4_attn_smem(G, S2, cs, hd, ncl) > SMEM_LIMIT:
        raise NotImplementedError(f"kv4_decode_attention kernel: S/2 {S2}, {cs} staged "
                                  f"columns need too much shared memory")
    k = _consts(meta, hd, qk_fq_on)
    m = k["m"]
    # masked columns may be skipped where their probability is exactly 0
    skip = (not pv_fq_on) or (0.0 <= m[10] <= m[11])
    consts = [k[n] for n in ("oqs", "ok", "oks", "inv", "sqk", "cf", "c_lo", "c_st", "ksh")]
    consts += [m[6], m[7], m[8], m[9], m[10], m[11], m[4], m[5], m[12]]
    q = _build.aligned(q8)
    kp_, vp_ = _build.aligned(kp), _build.aligned(vp)
    kcs_ = _build.aligned(kcs)
    sk_, sv_ = _build.aligned(sk), _build.aligned(sv)
    kn, vn = _build.aligned(k_new.reshape(BH, hd)), _build.aligned(v_new.reshape(BH, hd))
    pos_ = pos.to(torch.int32).contiguous()
    out = torch.empty((BH, G, hd), dtype=torch.float32, device=dev)
    mh = _build.host_floats(consts)
    code = _build.lib().mqt_kv4_decode_attention(
        q.data_ptr(), kp_.data_ptr(), vp_.data_ptr(), kcs_.data_ptr(), sk_.data_ptr(),
        sv_.data_ptr(), kn.data_ptr(), vn.data_ptr(), pos_.data_ptr(), out.data_ptr(),
        _build.addr(mh), BH, BH // B, G, hd, S2, cs, mst, layer, int(bool(qk_fq_on)),
        int(bool(pv_fq_on)), int(skip), ncl, _build.stream_ptr(dev))
    _build.check(code, "kv4_decode_attention")
    kv4_decode_attention.launches += 1
    return out


kv4_decode_attention.launches = 0
kv4_decode_attention.plain_calls = 0
