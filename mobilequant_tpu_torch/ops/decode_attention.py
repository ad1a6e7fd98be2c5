"""int8-KV decode attention (T = 1) over one layer of the cache.

  scores = ((q−o'_q)·(k−o'_k))·s_q·s_k -> [fq16] -> ·1/√hd + mask (col < valid)
  probs  = softmax(scores) -> [fq16];  out = (P·v_shifted − o'_v·ΣP)·s_v

The step's own row is already in the cache (the engine writes it before the
call), so the cache rows < valid_len are the whole attention. Used by a T = 1
step under KernelConfig.attn_kernel (KernelConfig.attn()).

Kernel: csrc/decode_attention.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_attention.py decode_attention
(_decode_attn_kernel). Bound: device-memory bytes (the valid K and V rows).
Design: the valid rows of one (sequence, kv head) are split into contiguous
stripes over a thread-block cluster of `cluster_size` blocks (from the
shapes only: B·Hkv, S and the SM count); each block reads its sequence's
valid_len on the device, so nothing is read on the host. A thread per (row,
query head) computes the integer dot (dp4a, exact) and the score epilogue in
the JAX kernel's fp32 order; the softmax takes two phases: the blocks'
maxima meet in distributed shared memory into the global max, every block
takes exp(s − m) against it, and the fp64 partial denominators meet (rank
order) and are rounded once; P·V keeps fp64 partials of (query head, hd)
outputs a thread, summed over the warps, then over the cluster, rounded
once. Only rows < valid_len are read (a masked row's exp is exactly 0; in the
strict policy while fq16(0) is 0, else every row).

Numerics: the max is exact; the denominator, ΣP and the P·V dots are fp64
sums of terms exact in fp64 (p·v: 24 × 8 bits), rounded once to fp32, in the
kernel and in the plain version below, so the two agree whatever the
summation order (an order moves an fp64 sum by far less than an fp32 step);
the rest repeats the JAX kernel's fp32 operations.
tests/test_torch_decode_attention_numerics.py models the split over the
blocks (stripes, per-stripe maxima, the global max, fp64 partials added in
rank order) on the CPU against the plain version; the order inside a block
rests on the fp64 argument and on the checks on the card (chip_smoke.py,
scripts/check_decode_attention.py). meta: the JAX engine's 13-float
attention meta.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq

SMEM_LIMIT = 200 * 1024
# blocks a (sequence, kv head), one thread-block cluster: at most Hopper's
# portable limit (16 blocks, the non-portable limit, ran slower than 8 at B=1
# on an H100: PERF.md §6)
MAX_CLUSTER = 8
MIN_ROWS = 16           # cache rows (kv4: packed columns) a block takes at least
WARPS = 8               # the kernels' 256 threads


def _stats_bytes(G: int, hd: int) -> int:
    """csrc/decode_cluster.cuh Stats: fp64 P·V partials (G·hd), denominator
    and ΣP partials (G each), warp sums (8 G); fp32 maxima (G) and warp maxima
    (8 G); rounded up to 16 bytes."""
    return -(-(8 * (G * hd + 10 * G) + 4 * 9 * G) // 16) * 16


# the group sizes the kernels are instantiated for (csrc/decode_attention.cu,
# csrc/kv4_attention.cu); 6 is Qwen2-1.5B's 12 q heads over 2 kv heads
GROUPS = (1, 2, 4, 6, 8, 16)


def _pv_heads(G: int, hd: int) -> int:
    """Query heads of a thread in P·V (decode_cluster.cuh PvLayout::GPT): the
    largest divisor of G with GPT·hd/32 <= 32."""
    d = min(G, 32 // (hd // 32))
    while G % d:
        d -= 1
    return d


def decode_attn_smem(G: int, S: int, hd: int, ncl: int) -> int:
    """Shared-memory bytes of the kernel with ncl blocks a (sequence, kv head):
    the statistics, and fp64 slots for the scores of a stripe's rows (then P;
    after P·V the warps' partials)."""
    W = (-(-S // ncl) + 1) // 2 * 2
    return _stats_bytes(G, hd) + 8 * max(G * W, WARPS * _pv_heads(G, hd) * hd)


def pick_cluster(BH: int, units: int, sms: int, smem) -> int:
    """Blocks a (sequence, kv head), from shapes only: the largest power of
    two up to MAX_CLUSTER with BH·ncl <= 2·sms and at least MIN_ROWS of the
    `units` (cache rows, or packed columns) a block, so 1 where BH already
    fills the card; then larger while smem(ncl) is above SMEM_LIMIT and
    MAX_CLUSTER allows (smaller stripes need less)."""
    ncl = 1
    while 2 * ncl <= MAX_CLUSTER and BH * 2 * ncl <= 2 * sms \
            and units >= MIN_ROWS * 2 * ncl:
        ncl *= 2
    while smem(ncl) > SMEM_LIMIT and 2 * ncl <= MAX_CLUSTER:
        ncl *= 2
    return ncl


def cluster_size(B: int, Hkv: int, S: int, sms: int, G: int, hd: int) -> int:
    """The kernel's blocks a (sequence, kv head) for B sequences of Hkv kv
    heads over an S-row cache on a card of `sms` SMs."""
    return pick_cluster(B * Hkv, S, sms, lambda n: decode_attn_smem(G, S, hd, n))


def _consts(meta, hd: int) -> dict:
    m = [float(v) for v in meta]
    oq = f32(np.float32(m[1]) - np.float32(128.0))
    ok = f32(np.float32(m[3]) - np.float32(128.0))
    return dict(m=m, oq=oq, ok=ok, ov=f32(np.float32(m[5]) - np.float32(128.0)),
                sqk=f32(np.float32(m[0]) * np.float32(m[2])),
                c_hd=f32(np.float32(np.float32(hd) * np.float32(oq)) * np.float32(ok)),
                inv=f32(1.0 / math.sqrt(hd)))


def decode_attention_plain(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                           meta: Sequence[float], valid_len: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch operators, every cache row masked as
    the JAX kernel masks it (see decode_attention for shapes)."""
    B, Hkv, G, hd = q8.shape
    S = k8.shape[2]
    k = _consts(meta, hd)
    m = k["m"]
    acc = int_dot(q8, k8.transpose(-1, -2))                       # (B, Hkv, G, S)
    ksum = rowsum_i8(k8).transpose(-1, -2)                        # (B, Hkv, 1, S)
    sc = (acc - k["ok"] * rowsum_i8(q8) - k["oq"] * ksum + k["c_hd"]) * k["sqk"]
    if m[8] > 0.5:
        sc = _fq(sc, m[6], m[7], m[8])
    sc = sc * k["inv"]
    col = torch.arange(S, device=q8.device)
    valid = col[None] < valid_len.to(torch.int64)[:, None]         # (B, S)
    sc = sc + torch.where(valid, torch.zeros((), device=q8.device), m[12])[:, None, None]
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    den = e.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    p = e / den
    if m[11] > 0.5:
        p = _fq(p, m[9], m[10], m[11])
    pv = torch.matmul(p.to(torch.float64), v8.to(torch.float64)).to(torch.float32)
    psum = p.to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
    return (pv - k["ov"] * psum) * m[4]


def decode_attention(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                     meta: Sequence[float], valid_len: torch.Tensor) -> torch.Tensor:
    """q8 (B, Hkv, G, hd) int8 × one layer of the cache k8 / v8 (B, Hkv, S, hd)
    int8 -> fp32 (B, Hkv, G, hd); valid_len (B,) int32 rows per sequence."""
    B, Hkv, G, hd = q8.shape
    S = k8.shape[2]
    if k8.shape != (B, Hkv, S, hd) or v8.shape != k8.shape or tuple(valid_len.shape) != (B,):
        raise ValueError(f"decode_attention: q {tuple(q8.shape)}, k/v {tuple(k8.shape)}, "
                         f"valid {tuple(valid_len.shape)}")
    if q8.device.type == "cpu":
        decode_attention.plain_calls += 1
        return decode_attention_plain(q8, k8, v8, meta, valid_len)
    dev = _build.require_cuda(q8, k8, v8, valid_len)
    if hd not in (64, 128, 256) or G not in GROUPS or q8.dtype != torch.int8 \
            or k8.dtype != torch.int8:
        raise NotImplementedError(f"decode_attention kernel: hd {hd}, G {G}")
    ncl = cluster_size(B, Hkv, S, _build.sm_count(dev), G, hd)
    if decode_attn_smem(G, S, hd, ncl) > SMEM_LIMIT:
        raise NotImplementedError(f"decode_attention kernel: S={S} needs too much shared memory")
    k = _consts(meta, hd)
    m = k["m"]
    # masked rows may be skipped where their probability is exactly 0
    skip = m[11] <= 0.5 or 0.0 <= m[10] <= m[11]
    consts = [k["oq"], k["ok"], k["ov"], k["sqk"], k["c_hd"], k["inv"], m[6], m[7], m[8],
              m[9], m[10], m[11], m[4], m[12]]
    q = _build.aligned(q8)
    kk, vv = _build.aligned(k8), _build.aligned(v8)
    vl = valid_len.to(torch.int32).contiguous()
    out = torch.empty((B, Hkv, G, hd), dtype=torch.float32, device=dev)
    mh = _build.host_floats(consts)
    code = _build.lib().mqt_decode_attention(
        q.data_ptr(), kk.data_ptr(), vv.data_ptr(), vl.data_ptr(), out.data_ptr(),
        _build.addr(mh), B, Hkv, G, hd, S, int(skip), ncl, _build.stream_ptr(dev))
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.plain_calls = 0
