"""A whole staged decode step of a serving batch (B = 16..128) in one kernel.

fused_model_w4_chunk: every layer of a T=1 step on the chunked-staging decode
path (runtime/engine.decode_loop at B > 8), then (optionally) the final norm
and the quantized head:

  per layer: [fq16] -> norm -> quantize -> qkv -> per-column output fq
  -> RoPE -> joint segment quantization (the step's K/V rows) -> attention
  over [stale cache rows < pos0 | staged columns < m | self term] with one
  shared max, per-part exp and one denominator -> pv-output quantize -> o
  -> fq -> resid_add_1 -> the MLP block (ops/mlp_block)
  head: norm -> dynamic per-row A8 -> W4 or W8 head -> logits (B, Vp)

Every norm is RMSNorm, or with norm_kind "layernorm" (StableLM) LayerNorm
with its bias (the kernel's runtime flag `ln`).

The layer packs are all W4 or all W8 (the JAX kernel's two editions, there
by the packs' shapes); the head has its own width (the W8 head folded as the
JAX chunk kernel folds it).

Kernel: csrc/fused_rows.cu / fused_rows_w8.cu (mqt_fused_chunk; the head-dim-256
editions in fused_rows_hd256.cu / fused_rows_hd256_w8.cu), which replace
the JAX package's mobilequant_tpu/ops/pallas_chunk.py fused_model_w4_chunk
(_chunk_kernel, _chunk_mlp_phase). Bound: device-memory bytes: each weight
byte once per step (518 MB for TinyLlama-1.1B with its W4 head, 1,036 MB with
W8 layers and head) plus the valid cache rows, the staged columns and the K
column sums. Design: the cooperative persistent launch of ops/fused_layer with
its grid barrier, and three changes for B rows: the norms are stages of their
own (one block per row, writing int8 rows), the matvec stages run the int8
tensor-core tile core of csrc/tc_tile.cuh (64-row x 128-column mma.sync tiles
over a four-stage cp.async ring; the row tiles of a column tile side by side,
so each weight byte comes once a step from device memory; where the tiles
leave blocks idle, K splits meet in slabs of a workspace, SLABS, with plain
stores and a grid barrier: no atomics; mlp_block.rows_plan mirrors the
plan), and the attention runs one block per
(sequence, q head) (above 64 rows, one per (sequence, kv head) with its q
heads, so each K/V row is read once for them), reading only valid rows: the
cache's K column sums come from kcs (computed once per chunk), the staged
columns' are computed in the kernel.

The caches are read-only within a chunk (cache_position is the chunk-start
position pos0); the step's rows come back as kv_new (L, B, 2 Hkv, hd), the
pending rows that decode_loop appends to the staging buffers.

Numerics follow the JAX chunk kernel, which differs from the engine's staged
XLA path by fp32 rounding: without the qk_bmm output fake-quant the score
scale folds 1/sqrt(hd) in (s_q·s_k/sqrt(hd)); without the pv_bmm input
fake-quant P·V is unnormalised, att = (Σ e·v / den − o_v)·s_v; with it the
fake-quanted probabilities multiply V part by part. The plain version below
repeats that math; its sums that feed an int8 rounding (norms, the
denominator's parts, P·V, ΣP, the self score) are fp64 rounded once, as in
the kernel, so the two agree whatever the summation order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.fused_layer import (
    LAYER_META_LEN, head_kernel_supported, layer_kernel_supported, layer_pack_bits,
    layer_tail_plain, qkv_rows_plain)
from mobilequant_tpu_torch.ops.mlp_block import (
    BARRIER, MAX_ROWS, FusedArgs, check_norm_kind, layer_norm, ptr, rms_norm, rows_smem,
    rows_workspace, stacked_w4, sum_f32)
from mobilequant_tpu_torch.ops.qops import f32, int_dot, int_head_linear, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, weight_bits

SMEM_LIMIT = 200 * 1024


def chunk_head_dim_ok(hd: int) -> bool:
    """The kernel's attention editions (csrc/fused_rows.cu mqt_fused_chunk):
    4 head dims a lane up to 128, 8 at 256 (Gemma-2B)."""
    return hd % 32 == 0 and (hd <= 128 or hd == 256)


def chunk_qwords(hd: int) -> int:
    """The packed q words the per-head attention stage reserves (8·DPL)."""
    return 32 if hd <= 128 else 64


def chunk_attn_smem(hd: int, S: int, ncs: int, G: int) -> int:
    """Shared-memory bytes of the chunk kernel's attention stages (per q head,
    and up to hd 128 per kv head with its G <= 8 q heads: csrc/fused_rows.cuh
    AttnLayout, GroupLayout)."""
    def a16(n):
        return (n + 15) & ~15
    per_head = 1280 + hd * 24 + 2 * 8 * hd * 8 + 4 * chunk_qwords(hd) + (S + ncs) * 4 + 256 * hd
    if hd > 128:            # the hd-256 edition never takes the grouped stage
        return per_head
    g = G if G <= 8 else 1
    part = a16(a16(128 + 2 * (g + 2) * hd * 4) + 8 * 8 * 4 + g * hd)
    grouped = a16(part + 2 * 256 * 8 + g * (S + ncs) * 4) + 256 * hd
    return max(per_head, grouped)


def chunk_smem(wbits: int, hbits: int, hd: int, S: int, ncs: int, G: int) -> int:
    """Dynamic shared memory of the chunk kernel (csrc/fused_rows.cuh
    chunk_smem): its matvec stages' tile ring at the wider of the layers' and
    the head's weight bits (hbits 0: no head), or its attention stages."""
    return max(rows_smem(max(wbits, hbits)), chunk_attn_smem(hd, S, ncs, G))


def chunk_kernel_supported(c, max_seq_len: int, B: int) -> bool:
    """Static shape gate of the chunk kernel (the JAX package's
    chunk_kernel_supported): 8 < B <= 128, B % 8 == 0, a sequence's K slab
    at most 4 MiB, and the whole-layer kernels' gate (head_dim a multiple of
    32 up to 256: the registry's head dims 64, 128 and 256 take the kernel's
    two attention editions, 4 dims a lane up to 128, 8 at 256). Llama-2-7B
    (32 kv heads of 128) passes the slab rule at S 1024 (4 MiB) and fails it
    at S 2048."""
    per_seq = c.num_kv_heads * max_seq_len * c.head_dim_
    return (8 < B <= MAX_ROWS and B % 8 == 0 and per_seq <= 4 * 1024 * 1024
            and layer_kernel_supported(c, max_seq_len))


def chunk_attention_plain(q8, kc, vc, kcs, skl, svl, pos, mst, m, Hq, Hkv, hd,
                          qk_fq_on, pv_fq_on):
    """One layer's staged attention of the chunk kernel -> (B, Hq·hd) fp32.
    q8 (B, Nq) int8 rows [q | k | v]; kc / vc (B, Hkv, S, hd) the stale cache;
    kcs (B, Hkv, S) its K column sums; skl / svl (B, Hkv, cs, hd) the staged
    columns, mst of them valid; pos (B,) chunk-start positions."""
    B = q8.shape[0]
    G = Hq // Hkv
    S, ncs = kc.shape[2], skl.shape[2]
    qg = q8[:, :Hq * hd].reshape(B, Hkv, G, hd)
    kn = q8[:, Hq * hd:(Hq + Hkv) * hd].reshape(B, Hkv, 1, hd).to(torch.float32)
    vn = q8[:, (Hq + Hkv) * hd:].reshape(B, Hkv, 1, hd).to(torch.float32)
    oq = f32(np.float32(m[7]) - np.float32(128.0))
    ok = f32(np.float32(m[9]) - np.float32(128.0))
    ov = f32(np.float32(m[11]) - np.float32(128.0))
    sqk = f32(np.float32(m[6]) * np.float32(m[8]))
    inv = f32(1.0 / math.sqrt(hd))
    cf = sqk if qk_fq_on else f32(np.float32(sqk) * np.float32(inv))
    hdoo = f32(np.float32(hd) * np.float32(oq) * np.float32(ok))
    qsum = rowsum_i8(qg)                                         # (B, Hkv, G, 1)
    dev = q8.device

    def logits(k_i8, ksum, valid, n):
        raw = int_dot(qg, k_i8.transpose(-1, -2)) - ok * qsum - oq * ksum[:, :, None, :] + hdoo
        lg = _fq(raw * sqk, m[12], m[13], m[14]) * inv if qk_fq_on else raw * cf
        col = torch.arange(n, device=dev)
        mask = torch.where(col[None] < valid[:, None], torch.zeros((), device=dev),
                           torch.full((), m[18], device=dev))
        return lg + mask[:, None, None, :]

    lg_c = logits(kc, kcs, pos.to(torch.int64), S)
    lg_st = logits(skl, rowsum_i8(skl)[..., 0],
                   torch.full((B,), int(mst), dtype=torch.int64, device=dev), ncs)
    s_self = sum_f32((qg.to(torch.float32) - oq) * (kn - ok)) * sqk
    if qk_fq_on:
        s_self = _fq(s_self, m[12], m[13], m[14])
    lg_self = s_self * inv
    mx = torch.maximum(lg_c.amax(-1, keepdim=True), lg_self)
    mx = torch.maximum(mx, lg_st.amax(-1, keepdim=True))
    e_c, e_st = torch.exp(lg_c - mx), torch.exp(lg_st - mx)
    e_self = torch.exp(lg_self - mx)
    den = sum_f32(e_c) + e_self + sum_f32(e_st)
    vc64, vs64 = vc.to(torch.float64), svl.to(torch.float64)
    if not pv_fq_on:
        acc = torch.matmul(e_c.to(torch.float64), vc64) + torch.matmul(e_st.to(torch.float64),
                                                                       vs64)
        att = (acc.to(torch.float32) + e_self * vn) / den
        att = (att - ov) * m[10]
    else:
        def pfq(p):
            return _fq(p, m[15], m[16], m[17])

        p_c, p_st, p_self = pfq(e_c / den), pfq(e_st / den), pfq(e_self / den)
        att = (torch.matmul(p_c.to(torch.float64), vc64).to(torch.float32)
               - ov * sum_f32(p_c)) * m[10]
        att = att + (torch.matmul(p_st.to(torch.float64), vs64).to(torch.float32)
                     - ov * sum_f32(p_st)) * m[10]
        att = att + p_self * ((vn + 128.0 - m[11]) * m[10])
    return att.reshape(B, Hq * hd)


def fused_model_w4_chunk_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2,
                               kcache, vcache, kcs, sk, sv, m_staged, meta_L, head=None,
                               final_norm=None, *, num_q_heads, num_kv_heads, head_dim,
                               rotary_dim, act_kind="silu", norm_kind="rmsnorm",
                               qk_fq_on=False, pv_fq_on=False):
    """The chunk kernel's function in PyTorch operators."""
    L = meta_L.shape[0]
    Hq, Hkv, hd = num_q_heads, num_kv_heads, head_dim
    B = x.shape[0]
    S = kcache.shape[3]
    kcs = kcs.reshape(L, B, Hkv, S).to(torch.float32)
    metas = meta_L.to(torch.float32).tolist()
    kv = []
    for l in range(L):
        m = metas[l]
        q8 = qkv_rows_plain(x, cs, ofq_L[l], attn_norm["w"][l], attn_norm["b"][l],
                            layer_pack(qkv, l), m, Hq, Hkv, hd, rotary_dim, norm_kind)
        att = chunk_attention_plain(q8, kcache[l], vcache[l], kcs[l], sk[l], sv[l], pos,
                                    m_staged, m, Hq, Hkv, hd, qk_fq_on, pv_fq_on)
        x = layer_tail_plain(x, att, layer_pack(o, l), mlp_norm["w"][l], mlp_norm["b"][l],
                             layer_pack(w13, l), layer_pack(w2, l), m, act_kind, norm_kind)
        kv.append(q8[:, Hq * hd:].reshape(B, 2 * Hkv, hd))
    kv = torch.stack(kv)
    if head is None:
        return x, kv
    norm = layer_norm if norm_kind == "layernorm" else rms_norm
    y = norm(x, float(meta_L[L - 1, 3])) * final_norm["w"] + final_norm["b"]
    return x, kv, int_head_linear(y, head)


def fused_model_w4_chunk(x: torch.Tensor, pos: torch.Tensor, cs: torch.Tensor,
                         ofq_L: torch.Tensor, attn_norm: dict, qkv: dict, o: dict,
                         mlp_norm: dict, w13: dict, w2: dict, kcache: torch.Tensor,
                         vcache: torch.Tensor, kcs: torch.Tensor, sk: torch.Tensor,
                         sv: torch.Tensor, m_staged: int, meta_L: torch.Tensor,
                         head: Optional[dict] = None, final_norm: Optional[dict] = None,
                         *, num_q_heads: int, num_kv_heads: int, head_dim: int,
                         rotary_dim: int, act_kind: str = "silu", norm_kind: str = "rmsnorm",
                         qk_fq_on: bool = False, pv_fq_on: bool = False,
                         trace: Optional[torch.Tensor] = None):
    """x (B, K) fp32 with B % 8 == 0, 8 <= B <= 128; pos (B,) chunk-start
    cache positions; cs (B, 2, hd); caches (L, B, Hkv, S, hd) int8; kcs
    (L, B, Hkv, S) or (L, B, Hkv, 1, S) fp32 K column sums of the caches;
    sk / sv (L, B, Hkv, ncs, hd) int8 staged columns, m_staged of them valid
    -> (x_out (B, K), kv_new (L, B, 2 Hkv, hd) int8 [k rows; v rows]) and,
    with a W4 or W8 head pack and final_norm {w, b}, logits (B, Vp); the
    layer packs all W4 or all W8; norm_kind "rmsnorm" or "layernorm". qk_fq_on /
    pv_fq_on: the policy's qk_bmm output and pv_bmm input enables. trace:
    optional int64 (3 + 5 L,) device tensor that receives the global timer
    (ns) at the start and at the end of each stage (norm1, qkv, attention,
    o, MLP block per layer, then the head's norm and matvec)."""
    B, K = x.shape
    L, _, Nq = qkv["wq"].shape
    Hq, Hkv, hd = num_q_heads, num_kv_heads, head_dim
    S = kcache.shape[3]
    F = w13["wq"].shape[2] // 2
    ncs, mst = sk.shape[3], int(m_staged)
    if not (8 <= B <= MAX_ROWS and B % 8 == 0):
        raise NotImplementedError(f"chunk kernel: B={B} (B % 8 == 0, 8 <= B <= 128)")
    if not layer_pack_bits(K, Hq * hd, qkv, o, w13, w2):
        raise NotImplementedError("the chunk kernel takes all-W4 or all-W8 packs")
    if act_kind not in ("silu", "gelu_tanh"):
        raise NotImplementedError(f"chunk kernel: act {act_kind!r}")
    check_norm_kind(norm_kind, "chunk")
    if head is not None and not head_kernel_supported(head, K):
        raise NotImplementedError("the chunk kernel folds W4 (K/2, Vp) or W8 (K, Vp) heads "
                                  "with Vp % 128 == 0")
    if kcache.shape != (L, B, Hkv, S, hd) or vcache.shape != kcache.shape \
            or kcs.numel() != L * B * Hkv * S or tuple(sk.shape[:3]) != (L, B, Hkv) \
            or sk.shape[4] != hd or sv.shape != sk.shape or not 0 <= mst <= ncs:
        raise ValueError("chunk kernel: cache / kcs / staging shapes")
    if Nq != (Hq + 2 * Hkv) * hd or tuple(meta_L.shape) != (L, LAYER_META_LEN) \
            or tuple(ofq_L.shape) != (L, 4, Nq) or tuple(cs.shape) != (B, 2, hd):
        raise ValueError("chunk kernel: operand shapes")
    kw = dict(num_q_heads=Hq, num_kv_heads=Hkv, head_dim=hd, rotary_dim=rotary_dim,
              act_kind=act_kind, norm_kind=norm_kind, qk_fq_on=qk_fq_on, pv_fq_on=pv_fq_on)
    if x.device.type == "cpu":
        fused_model_w4_chunk.plain_calls += 1
        return fused_model_w4_chunk_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm,
                                          w13, w2, kcache, vcache, kcs, sk, sv, mst,
                                          meta_L, head, final_norm, **kw)
    dev = _build.require_cuda(x, pos, cs, ofq_L, meta_L, kcache, vcache, kcs, sk, sv,
                              qkv["wq"])
    if not chunk_head_dim_ok(hd):
        raise NotImplementedError(f"chunk kernel: head_dim {hd} (a multiple of 32 up to "
                                  f"128, or 256)")
    if chunk_smem(weight_bits(qkv["wq"], K), weight_bits(head["wq"], K) if head else 0, hd, S,
                  ncs, Hq // Hkv) > SMEM_LIMIT:
        raise NotImplementedError(f"chunk kernel: S={S}, {ncs} staged columns need too "
                                  f"much shared memory")
    lib = _build.lib()
    keep = []

    def f32c(t):
        t = t.to(torch.float32).contiguous()
        keep.append(t)
        return t

    def i8c(t):
        t = _build.aligned(t)
        keep.append(t)
        return t

    a = FusedArgs()
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    kv_new = torch.empty((L, B, 2 * Hkv, hd), dtype=torch.int8, device=dev)
    scratch = dict(yq=torch.empty((B, Nq), dtype=torch.float32, device=dev),
                   resid=torch.empty((B, K), dtype=torch.float32, device=dev),
                   a8=torch.empty((B, Hq * hd), dtype=torch.int8, device=dev),
                   act8=torch.empty((B, F), dtype=torch.int8, device=dev),
                   h8=torch.empty((B, K), dtype=torch.int8, device=dev),
                   sx=torch.empty((B,), dtype=torch.float32, device=dev))
    keep += list(scratch.values())
    logits, Vp = None, 0
    if head is not None:
        Vp = head["wq"].shape[1]
        logits = torch.empty((B, Vp), dtype=torch.float32, device=dev)
        a.hwq = ptr(i8c(head["wq"]))
        a.hbits = weight_bits(head["wq"], K)
        a.hscale = ptr(f32c(head["scale"].reshape(-1)))
        a.hoffset = ptr(f32c(head["offset"].reshape(-1)))
        a.fnw = ptr(f32c(final_norm["w"]))
        a.fnb = ptr(f32c(final_norm["b"]))
    stages = ((K, Nq, False), (Hq * hd, K, False), (K, 2 * F, True), (F, K, False))
    ws = rows_workspace(dev, (B,), stages + (((K, Vp, False),) if Vp else ()))
    a.x_in, a.x_out, a.kv_new, a.logits = ptr(f32c(x)), ptr(out), ptr(kv_new), ptr(logits)
    pos_ = pos.to(torch.int32).contiguous()
    keep.append(pos_)
    a.pos, a.cs, a.meta, a.ofq = ptr(pos_), ptr(f32c(cs)), ptr(f32c(meta_L)), ptr(f32c(ofq_L))
    a.anw, a.anb = ptr(f32c(attn_norm["w"])), ptr(f32c(attn_norm["b"]))
    a.mnw, a.mnb = ptr(f32c(mlp_norm["w"])), ptr(f32c(mlp_norm["b"]))
    a.kcache, a.vcache = ptr(i8c(kcache)), ptr(i8c(vcache))
    a.kcs, a.sk, a.sv = ptr(f32c(kcs)), ptr(i8c(sk)), ptr(i8c(sv))
    for name, t in scratch.items():
        setattr(a, name, ptr(t))
    a.ws, a.bar = ptr(ws), ptr(BARRIER.get(dev, 2))
    if trace is not None:
        if trace.dtype != torch.int64 or trace.device != dev or trace.numel() < 3 + 5 * L:
            raise ValueError("trace: an int64 tensor of 3 + 5·layers entries on the device")
        a.trace = ptr(trace)
    a.qkv, a.o = stacked_w4(qkv, keep, K), stacked_w4(o, keep, Hq * hd)
    a.w13, a.w2 = stacked_w4(w13, keep, K), stacked_w4(w2, keep, F)
    a.M, a.K, a.Hq, a.Hkv, a.hd, a.rot, a.S, a.F = B, K, Hq, Hkv, hd, rotary_dim, S, F
    a.Vp, a.L, a.l0, a.l1 = Vp, L, 0, L
    a.gelu = int(act_kind == "gelu_tanh")
    a.ln = int(norm_kind == "layernorm")
    a.ncs, a.mst, a.qk_fq, a.pv_fq = ncs, mst, int(bool(qk_fq_on)), int(bool(pv_fq_on))
    a.inv_sqrt_hd = 1.0 / math.sqrt(hd)
    code = lib.mqt_fused_chunk(ctypes.addressof(a), _build.stream_ptr(dev))
    _build.check(code, "fused_model_w4_chunk")
    fused_model_w4_chunk.launches += 1
    return (out, kv_new) if head is None else (out, kv_new, logits)


fused_model_w4_chunk.launches = 0
fused_model_w4_chunk.plain_calls = 0
