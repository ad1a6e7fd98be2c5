"""Causal int8-KV prefill attention.

  scores = ((q−o'_q)·(k−o'_k))·s_q·s_k -> [fq16] -> ·1/√hd + causal/valid mask
  probs  = softmax(scores) -> [fq16];  out = (P·v_shifted − o'_v·ΣP)·s_v

Kernel: csrc/prefill_attention.cu, which replaces the JAX package's
mobilequant_tpu/ops/pallas_prefill_attention.py prefill_attention
(_prefill_attn_online_kernel when pv_fq is off, the relaxed serving policy;
_prefill_attn_kernel when it is on, the strict policy). Bound: operations
over the causal half of the score matrix: Q·Kᵀ in int8 and P·V in fp16 on
the tensor cores, one exp a score. The scalar edition it replaces ran both
products on the CUDA cores. Design: one block per (batch, kv head, Q tile),
all query heads of the kv head together; K/V tiles stream through a cp.async
ring up to the causal bound only; Q·Kᵀ is int8 mma.sync (the exact integer,
so every score is the float the plain version makes); P·V is fp16 mma.sync
on V made fp16 exactly and P split into two fp16 terms (22 bits, so the
output differs from the plain version's fp32 P·V by about 2^-22 of Σ p·|v|).
Head dims 64, 128 and 256 (a template on the head dim; at 256 the block's two
column groups split the head dim rather than the K/V tiles). Any group size
G <= 64: a block's 64 query rows hold ⌊64 / G⌋ positions of each of the G
query heads (at G = 6, Qwen2-1.5B's, 60 rows; the other 4 idle and masked,
as the JAX kernel masks its padded queries).
The relaxed policy runs an online softmax; the strict one three passes over
recomputed scores (row max, denominator in fp64, then normalised,
fake-quantized probabilities into P·V), since the prob fake-quant needs the
normalised probability and a whole score row does not fit shared memory.

meta: the JAX engine's 13-float attention meta [sq, oq, sk, ok, sv, ov,
qk_out scale, offset, qmax, pv_in scale, offset, qmax, neg_inf].
Mask: column s of batch b is visible to a query at position p when
s <= p and s < valid[b].
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq

# the kernel's head-dim editions; the G query heads of a kv head share a
# block's 64 rows, ⌊64 / G⌋ positions each, so G is at most 64
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 64


def prefill_attention_plain(q8: torch.Tensor, k8: torch.Tensor,
                            v8: torch.Tensor, meta: Sequence[float],
                            positions: torch.Tensor, valid: torch.Tensor,
                            qk_fq: bool, pv_fq: bool) -> torch.Tensor:
    """The kernel's function in PyTorch operators, with a whole-row softmax:
    q8 (B,Hkv,G,T,hd), k8/v8 (B,Hkv,S,hd) int8 -> fp32 (B,Hkv,G,T,hd)."""
    m = [float(x) for x in meta]
    B, Hkv, G, T, hd = q8.shape
    S = k8.shape[2]
    oq = f32(np.float32(m[1]) - np.float32(128.0))
    ok = f32(np.float32(m[3]) - np.float32(128.0))
    ov = f32(np.float32(m[5]) - np.float32(128.0))
    q2 = q8.reshape(B, Hkv, G * T, hd)
    acc = int_dot(q2, k8.transpose(-1, -2))                   # (B,Hkv,GT,S)
    ksum = rowsum_i8(k8)[..., 0][:, :, None, :]
    sc = (acc - ok * rowsum_i8(q2) - oq * ksum
          + f32(np.float32(hd) * np.float32(oq) * np.float32(ok)))
    sc = sc * f32(np.float32(m[0]) * np.float32(m[2]))
    if qk_fq:
        sc = _fq(sc, m[6], m[7], m[8])
    sc = sc * (1.0 / math.sqrt(hd))
    col = torch.arange(S, device=q8.device)
    vis = ((col[None, None, :] <= positions[:, :, None])
           & (col[None, None, :] < valid[:, None, None]))      # (B,T,S)
    zero = torch.zeros((), device=q8.device)
    mask = torch.where(vis, zero, m[12])[:, None, None]         # (B,1,1,T,S)
    sc = sc.reshape(B, Hkv, G, T, S) + mask
    e = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1, keepdim=True)
    linv = 1.0 / torch.clamp(l, min=1e-30)
    vf = v8.to(torch.float32)[:, :, None]                       # (B,Hkv,1,S,hd)
    if pv_fq:
        p = _fq(e * linv, m[9], m[10], m[11])
        return (torch.matmul(p, vf) - ov * p.sum(dim=-1, keepdim=True)) * m[4]
    return (torch.matmul(e, vf) - ov * l) * linv * m[4]


def prefill_attention(q8: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                      meta: Sequence[float], positions: torch.Tensor,
                      valid: torch.Tensor, qk_fq: bool = False,
                      pv_fq: bool = False) -> torch.Tensor:
    """q8 (B,Hkv,G,T,hd) int8 (any strides with a unit hd stride) × one layer
    of the cache k8/v8 (B,Hkv,S,hd) int8 -> fp32 (B,Hkv,G,T,hd). On the card
    the result is a view of a (B,T,Hkv,G,hd) buffer, the layout the engine
    continues in. positions (B,T) / valid (B,) int32."""
    B, Hkv, G, T, hd = q8.shape
    S = k8.shape[2]
    if k8.shape != (B, Hkv, S, hd) or v8.shape != k8.shape:
        raise ValueError(f"k/v {tuple(k8.shape)} do not match q {tuple(q8.shape)}")
    if q8.device.type == "cpu":
        prefill_attention.plain_calls += 1
        return prefill_attention_plain(q8, k8, v8, meta, positions, valid,
                                       qk_fq, pv_fq)
    dev = _build.require_cuda(q8, k8, v8, positions, valid)
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise NotImplementedError(f"prefill_attention kernel: head_dim {hd}, "
                                  f"group {G}")
    if q8.stride(-1) != 1 or q8.data_ptr() % 4 or any(s % 4 for s in q8.stride()[:4]):
        q8 = q8.contiguous()
    lib = _build.lib()
    k = _build.aligned(k8)
    v = _build.aligned(v8)
    pos = positions.to(torch.int32).contiguous()
    vl = valid.to(torch.int32).contiguous()
    buf = torch.empty((B, T, Hkv, G, hd), dtype=torch.float32, device=dev)
    out = buf.permute(0, 2, 3, 1, 4)
    qs = _build.host_int64s(q8.stride()[:4])
    os_ = _build.host_int64s(out.stride()[:4])
    mh = _build.host_floats(list(meta)[:13] + [f32(1.0 / math.sqrt(hd))])
    code = lib.mqt_prefill_attention(
        q8.data_ptr(), _build.addr(qs), k.data_ptr(), v.data_ptr(),
        pos.data_ptr(), vl.data_ptr(), buf.data_ptr(), _build.addr(os_),
        _build.addr(mh), B, Hkv, G, T, S, hd, int(qk_fq), int(pv_fq),
        _build.stream_ptr(dev))
    _build.check(code, "prefill_attention")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
prefill_attention.plain_calls = 0
