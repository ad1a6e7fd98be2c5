"""A whole decode step, or one whole decoder layer, in one kernel.

fused_model_w4: every layer of a T=1 decode step at B <= 8 sequences, then
(optionally) the final norm and the quantized head:

  per layer: [fq16] -> norm -> quantize -> qkv -> per-column output fq
  -> RoPE -> joint segment quantization (the new K/V rows) -> decode-light
  attention over the int8 cache (stale rows < pos, plus the self term) ->
  pv-output quantize -> o -> fq -> resid_add_1 -> the MLP block
  (ops/mlp_block)
  head: norm -> dynamic per-row A8 -> W4 or W8 head -> logits (B, Vp)

Every norm is RMSNorm, or with norm_kind "layernorm" (StableLM) the
mean-centred LayerNorm with its bias (the JAX kernels' two editions; the
kernel's runtime flag `ln`).

fused_layer_w4: one layer of the same at B = 1, no head.

The layer packs are all W4 (nibble-packed, (L, kin/2, n)) or all W8 ((L,
kin, n), per-tensor or per-channel scales); the head, W4 (K/2, Vp) or W8
(K, Vp), has its own width. The names keep the JAX package's, whose kernels
also take both editions by the packs' shapes.

Kernel: csrc/fused_layer.cuh (entry mqt_fused_decode in fused_layer.cu; the
head-dim-256 editions instantiated in fused_layer_hd256.cu), which replaces the JAX
package's mobilequant_tpu/ops/pallas_layer.py fused_model_w4_stacked
(_model_kernel, _layer_phase, _head_phase) and fused_layer_w4_stacked
(_layer_kernel), W4 and W8, RMSNorm and LayerNorm editions. Bound: device-memory bytes (each weight
byte once per step, plus the valid K/V rows). Design: one cooperative
persistent launch, one block an SM; stages split by grid barriers (five per
layer); each block owns fixed whole-K 32-column items of every matvec stage,
so no partial sum leaves it, and a producer warp streams their weights
through a shared-memory ring of 16 KB chunks that runs ahead across the
barriers and layers (ring_stream walks it, ring_smem lays out its shared
memory); the attention runs one block per (sequence, q head), its scores and
the cache rows in shared memory. The TPU column / row permutations of the
JAX kernels' qkv and o packs (a Mosaic layout workaround) are not ported: the
kernels read the canonical qkv_proj / o_proj packs.

Operands, as the engine prepares them once per (packed model, policy):
meta_L (L, 65) = the JAX engine's _layer_meta per layer (33 attention entries
then the 32 MLP-block entries), ofq_L (L, 4, Nq) = [scale, offset, clip max,
enabled] of the qkv output fake-quant per column; per step: pos (B,) cache
positions and cs (B, 2, head_dim) = [cos; sign-baked sin] RoPE rows. The K/V
caches are read, not written: the new rows come back as kv_new for the
engine's post-step row write.

The plain versions below repeat the kernels' function in PyTorch operators
(the JAX phase bodies' fp32 operation order, masked full-length scores) and
do not call the engine. The sums that feed an int8 rounding (norms, softmax
denominator, P·V, ΣP, self score) are taken in fp64 and rounded once, as in
the kernel, so kernel and plain version agree whatever the summation order.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.mlp_block import (
    BARRIER, FusedArgs, check_norm_kind, fused_mlp_block_w4_plain, layer_norm,
    mlp_block_supported, mlp_pack_bits, ptr, rms_norm, stacked_w4, sum_f32)
from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope_plain
from mobilequant_tpu_torch.ops.qops import f32, int_head_linear, int_matmul_qk, quantize_act
from mobilequant_tpu_torch.ops.w13_gate import _fq
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, w4a8_matmul_plain, weight_bits

LAYER_META_LEN = 65
MAX_BATCH = 8
SMEM_MAX = 232448 - 1024   # the ring kernel's dynamic shared memory (H100: 227 KB a
                           # block, its static arrays beside)
RING_W = 32                # bytes (columns) of a ring item's row segment
RING_ROWS = 512            # weight rows a ring chunk (16 KB)
RING_MAX_SLOTS = 13


def ring_smem(hd: int, S: int, K: int, kmax: int, MR: int):
    """(ring offset, slots, bytes) of csrc/fused_layer.cuh's ring kernel for
    MR rows (ring_base and launch_ring): the small arrays; one region that is
    the matvec stages' MR activation rows (kmax wide), per-warp column sums
    and w13 buffer, or a norm's MR int8 output rows of K and its staged
    inputs (MR + 2 fp32 rows of K), or the attention stage's rows, fp64 P·V
    partials, q words (32 up to hd 128, else 64), scores and 256-row K / V
    chunk, rounded up to 128 bytes; then as many 16 KB ring slots as the rest
    holds (at most 13; slots 0 when fewer than 2 fit: the launch is
    refused)."""
    mv = max(MR * kmax + 8 * MR * RING_W * 4 + MR * RING_W * 4, MR * K + (MR + 2) * K * 4)
    at = hd * 24 + 8 * hd * 8 + 4 * (32 if hd <= 128 else 64) + S * 4 + 256 * hd
    base = 1280 + -(-max(mv, at) // 128) * 128
    slot = RING_W * RING_ROWS
    nslot = min(RING_MAX_SLOTS, (SMEM_MAX - base) // slot) if base <= SMEM_MAX else 0
    nslot = nslot if nslot >= 2 else 0
    return base, nslot, base + nslot * slot


def kmax_of(K: int, Ko: int, F: int) -> int:
    """The widest activation row a matvec stage stages (csrc kmax_of)."""
    return -(-max(K, Ko, F) // 16) * 16


_QKV, _O, _W13, _W2, _HEAD, _END = range(6)


def ring_plan_dims(K: int, Ko: int, Nq: int, F: int, wbits: int, Vp: int = 0,
                   hbits: int = 4):
    """(items, weight rows) of the ring kernel's qkv, o, w13, w2 and head
    stages (csrc ring_plan_init): an item is 32 columns over the whole K (a
    w13 item: 32 gate outputs, their w1 then their w3 columns)."""
    div = 2 if wbits == 4 else 1
    items = (Nq // RING_W, K // RING_W, F // RING_W, K // RING_W, Vp // RING_W)
    rows = (K // div, Ko // div, K // div, F // div, K // (2 if hbits == 4 else 1))
    return items, rows


def ring_stream(dims: tuple, nlayers: int, G: int, block: int, head: bool):
    """The chunk stream of one block of the ring kernel, as its ring_settle /
    ring_advance walk it: (stage, layer, item, sub-item, chunk) in order.
    dims: ring_plan_dims; item i of a stage goes to block (i + off) mod G, off
    counting the items of every earlier stage of the launch."""
    items, rows = dims
    per = sum(items[:4])
    nch = [-(-r // RING_ROWS) for r in rows]

    def first(st, l):
        before = (l * (per % G) + (0 if st == _HEAD else sum(items[:st]))) % G
        return (block + G - before) % G

    out = []
    l, st, it = 0, _QKV, 0
    while st != _END:
        f = first(st, l)
        if f + it * G >= items[st]:
            it = 0
            if st == _HEAD:
                st = _END
            else:
                st += 1
                if st == _HEAD:
                    l += 1
                    if l < nlayers:
                        st = _QKV
                    elif not head:
                        st = _END
            continue
        for sub in range(2 if st == _W13 else 1):
            for ch in range(nch[st]):
                out.append((st, l, f + it * G, sub, ch))
        it += 1
    return out


def layer_kernel_supported(c, max_seq_len: int) -> bool:
    """Static shape gate of the whole-layer and whole-model kernels: head_dim
    a multiple of 32 up to 256 (the attention stage's 4- and 8-dims-a-lane
    editions: the registry's head dims 64 and 128 take the first, Gemma-2B's
    256 the second; the JAX gate takes hd % 128 == 0, but its Ko % 512 term
    is not copied: it would move test-llama-256 off the kernel routes), and
    at B = 8 two ring slots beside the attention stage's shared memory."""
    hd, Hq, Hkv = c.head_dim_, c.num_heads, c.num_kv_heads
    if Hkv < 1 or Hq % Hkv:
        return False
    K, Ko, Nq = c.hidden_size, Hq * hd, (Hq + 2 * Hkv) * hd
    F = c.intermediate_size
    rot = c.rotary_dim
    return (hd % 32 == 0 and hd <= 256 and rot % 2 == 0 and 0 < rot <= hd
            and K % 128 == 0 and Ko % 64 == 0 and Nq % 128 == 0
            and mlp_block_supported(K, F)
            and c.hidden_act in ("silu", "gelu_tanh")
            and c.neg_inf <= -1e4 and max_seq_len % 4 == 0
            and ring_smem(hd, max_seq_len, K, kmax_of(K, Ko, F), MAX_BATCH)[1] >= 2)


def head_kernel_supported(head_pack: dict, hidden_size: int) -> bool:
    """Whether a quantized head folds into the whole-model and chunk kernels:
    W4 (K/2, Vp) or W8 (K, Vp) (the JAX package's Kh in (K, K/2))."""
    Kh, Vp = head_pack["wq"].shape
    return Kh in (hidden_size, hidden_size // 2) and Vp % 128 == 0


def _outq(m: list, Hq: int, Hkv: int, hd: int, device) -> torch.Tensor:
    """(3, Nq) segment quantization rows from the layer meta."""
    qd, kvd = Hq * hd, Hkv * hd
    rows = torch.zeros((3, qd + 2 * kvd), dtype=torch.float32, device=device)
    for i in (0, 1):
        rows[i, :qd] = m[6 + i]
        rows[i, qd:qd + kvd] = m[8 + i]
        rows[i, qd + kvd:] = m[10 + i]
    rows[2, :qd + kvd] = 1.0
    return rows


def norm_kind_of(c) -> str:
    """The kernels' norm_kind of a model config: "layernorm" or "rmsnorm"."""
    return "layernorm" if c.norm_class == "layernorm" else "rmsnorm"


def qkv_rows_plain(x, cs, ofq, anw, anb, qkv, m, Hq, Hkv, hd, rot, norm_kind="rmsnorm"):
    """norm1 -> quantize -> qkv -> output fq -> RoPE -> segment quantization:
    x (B, K) -> q8 (B, Nq) int8 rows [q | k | v] of one layer."""
    B = x.shape[0]
    xx = _fq(x.to(torch.float32), m[0], m[1], m[2])
    norm = layer_norm if norm_kind == "layernorm" else rms_norm
    h8 = quantize_act(norm(xx, m[3]) * anw + anb, m[4], m[5])
    return qkv_rope_plain(h8, qkv, ofq, _outq(m, Hq, Hkv, hd, x.device),
                          cs.reshape(B, 2 * hd), m[4], m[5], hd, rot)


def layer_tail_plain(x, attn, o, mnw, mnb, w13, w2, m, act_kind, norm_kind="rmsnorm"):
    """pv-output quantize -> o -> fq -> resid_add_1 -> the MLP block:
    attn (B, Ko) fp32 and the layer input x (B, K) -> the layer output."""
    a8 = quantize_act(attn, m[19], m[20])
    y = w4a8_matmul_plain(a8, o["wq"], o["scale"], o["offset"], o["colsum"],
                          o.get("bias"), m[19], m[20])
    y = _fq(y, m[21], m[22], m[23])
    xr = _fq(x.to(torch.float32), m[24], m[25], m[26])
    y = _fq(y, m[27], m[28], m[29])
    resid = _fq(xr + y, m[30], m[31], m[32])
    return fused_mlp_block_w4_plain(resid, mnw, mnb, w13, w2, m[33:], act_kind,
                                    norm_kind=norm_kind)


def layer_attention_plain(q8, kc, vc, pos, m, Hq, Hkv, hd):
    """One layer's decode-light attention of the kernels: q8 (B, Nq) int8 rows
    [q | k | v], the cache slices kc / vc (B, Hkv, S, hd) read below pos (B,),
    plus the self term -> (B, Hq·hd) fp32."""
    B = q8.shape[0]
    G = Hq // Hkv
    S = kc.shape[2]
    qg = q8[:, :Hq * hd].reshape(B, Hkv, G, hd)
    kn = q8[:, Hq * hd:(Hq + Hkv) * hd].reshape(B, Hkv, 1, hd).to(torch.float32)
    vn = q8[:, (Hq + Hkv) * hd:].reshape(B, Hkv, 1, hd).to(torch.float32)
    oq, ok = f32(np.float32(m[7]) - np.float32(128.0)), f32(np.float32(m[9]) - np.float32(128.0))
    ov = f32(np.float32(m[11]) - np.float32(128.0))
    sqk = f32(np.float32(m[6]) * np.float32(m[8]))
    scores = _fq(int_matmul_qk(qg, kc, m[6], m[7], m[8], m[9]), m[12], m[13], m[14])
    s_self = sum_f32((qg.to(torch.float32) - oq) * (kn - ok)) * sqk
    s_self = _fq(s_self, m[12], m[13], m[14])
    inv = 1.0 / math.sqrt(hd)
    col = torch.arange(S, device=q8.device)[None, None, None, :]
    zero = torch.zeros((), device=q8.device)
    lg = scores * inv + torch.where(col < pos.reshape(B, 1, 1, 1), zero, m[18])
    lg_self = s_self * inv
    mx = torch.maximum(lg.amax(-1, keepdim=True), lg_self)
    e = torch.exp(lg - mx)
    es = torch.exp(lg_self - mx)
    den = sum_f32(e) + es
    p = _fq(e / den, m[15], m[16], m[17])
    ps = _fq(es / den, m[15], m[16], m[17])
    pv = torch.matmul(p.to(torch.float64), vc.to(torch.float64)).to(torch.float32)
    vnf = (vn + 128.0 - m[11]) * m[10]
    return ((pv - ov * sum_f32(p)) * m[10] + ps * vnf).reshape(B, Hq * hd)


def _layer_plain(x, pos, cs, ofq, anw, anb, qkv, o, mnw, mnb, w13, w2, kc, vc,
                 m, Hq, Hkv, hd, rot, act_kind, norm_kind):
    """One layer's function: x (B, K) -> (x_out (B, K), kv_new (B, 2Hkv, hd))
    over one layer's packs / vectors and cache slices kc / vc (B, Hkv, S, hd)."""
    B = x.shape[0]
    q8 = qkv_rows_plain(x, cs, ofq, anw, anb, qkv, m, Hq, Hkv, hd, rot, norm_kind)
    attn = layer_attention_plain(q8, kc, vc, pos, m, Hq, Hkv, hd)
    out = layer_tail_plain(x, attn, o, mnw, mnb, w13, w2, m, act_kind, norm_kind)
    return out, q8[:, Hq * hd:].reshape(B, 2 * Hkv, hd)


def _layers_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2, kcache,
                  vcache, meta_L, layers, Hq, Hkv, hd, rot, act_kind, norm_kind):
    metas = meta_L.to(torch.float32).tolist()
    kv = []
    for l in layers:
        x, rows = _layer_plain(
            x, pos, cs, ofq_L[l], attn_norm["w"][l], attn_norm["b"][l],
            layer_pack(qkv, l), layer_pack(o, l), mlp_norm["w"][l], mlp_norm["b"][l],
            layer_pack(w13, l), layer_pack(w2, l), kcache[l], vcache[l], metas[l],
            Hq, Hkv, hd, rot, act_kind, norm_kind)
        kv.append(rows)
    return x, torch.stack(kv)


def fused_model_w4_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2,
                         kcache, vcache, meta_L, head=None, final_norm=None, *,
                         num_q_heads, num_kv_heads, head_dim, rotary_dim,
                         act_kind="silu", norm_kind="rmsnorm"):
    """The whole-model kernel's function in PyTorch operators."""
    L = meta_L.shape[0]
    xo, kv = _layers_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2,
                           kcache, vcache, meta_L, range(L), num_q_heads,
                           num_kv_heads, head_dim, rotary_dim, act_kind, norm_kind)
    if head is None:
        return xo, kv
    eps = float(meta_L[L - 1, 3])
    norm = layer_norm if norm_kind == "layernorm" else rms_norm
    y = norm(xo, eps) * final_norm["w"] + final_norm["b"]
    return xo, kv, int_head_linear(y, head)


def fused_layer_w4_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2,
                         kcache, vcache, meta_L, layer, *, num_q_heads,
                         num_kv_heads, head_dim, rotary_dim, act_kind="silu",
                         norm_kind="rmsnorm"):
    """The whole-layer kernel's function in PyTorch operators."""
    xo, kv = _layers_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2,
                           kcache, vcache, meta_L, [layer], num_q_heads,
                           num_kv_heads, head_dim, rotary_dim, act_kind, norm_kind)
    return xo, kv[0, 0]


def _launch(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2, kcache, vcache,
            meta_L, layers, head, final_norm, Hq, Hkv, hd, rot, act_kind, norm_kind,
            trace=None):
    B, K = x.shape
    L, _, Nq = qkv["wq"].shape
    F = w13["wq"].shape[2] // 2
    S = kcache.shape[3]
    dev = _build.require_cuda(x, pos, cs, ofq_L, meta_L, kcache, vcache, qkv["wq"])
    if kcache.shape != (L, B, Hkv, S, hd) or vcache.shape != kcache.shape:
        raise ValueError(f"caches {tuple(kcache.shape)} do not match (L, B, Hkv, S, hd)")
    if Nq != (Hq + 2 * Hkv) * hd or tuple(meta_L.shape) != (L, LAYER_META_LEN) \
            or tuple(ofq_L.shape) != (L, 4, Nq) or tuple(cs.shape) != (B, 2, hd):
        raise ValueError("fused decode kernel: operand shapes")
    MR = 1 << (B - 1).bit_length()
    if not ring_smem(hd, S, K, kmax_of(K, Hq * hd, F), MR)[1]:
        raise NotImplementedError(f"fused decode kernel: S={S} needs too much shared memory")
    lib = _build.lib()
    keep = []

    def f32c(t):
        t = t.to(torch.float32).contiguous()
        keep.append(t)
        return t

    a = FusedArgs()
    xin = f32c(x)
    out = torch.empty((B, K), dtype=torch.float32, device=dev)
    kv_new = torch.empty((len(layers), B, 2 * Hkv, hd), dtype=torch.int8, device=dev)
    pos_ = pos.to(torch.int32).contiguous()
    kc, vc = kcache.contiguous(), vcache.contiguous()
    yq = torch.empty((B, Nq), dtype=torch.float32, device=dev)
    resid = torch.empty((B, K), dtype=torch.float32, device=dev)
    a8 = torch.empty((B, Hq * hd), dtype=torch.int8, device=dev)
    act8 = torch.empty((B, F), dtype=torch.int8, device=dev)
    logits, Vp = None, 0
    if head is not None:
        Vp = head["wq"].shape[1]
        logits = torch.empty((B, Vp), dtype=torch.float32, device=dev)
        hwq = _build.aligned(head["wq"], 16)
        keep.append(hwq)
        a.hwq = ptr(hwq)
        a.hbits = weight_bits(hwq, K)
        a.hscale = ptr(f32c(head["scale"].reshape(-1)))
        a.hoffset = ptr(f32c(head["offset"].reshape(-1)))
        a.fnw = ptr(f32c(final_norm["w"]))
        a.fnb = ptr(f32c(final_norm["b"]))
    a.x_in, a.x_out, a.kv_new, a.logits = ptr(xin), ptr(out), ptr(kv_new), ptr(logits)
    a.pos, a.cs, a.meta, a.ofq = ptr(pos_), ptr(f32c(cs)), ptr(f32c(meta_L)), ptr(f32c(ofq_L))
    a.anw, a.anb = ptr(f32c(attn_norm["w"])), ptr(f32c(attn_norm["b"]))
    a.mnw, a.mnb = ptr(f32c(mlp_norm["w"])), ptr(f32c(mlp_norm["b"]))
    a.kcache, a.vcache = ptr(kc), ptr(vc)
    a.yq, a.resid, a.a8, a.act8 = ptr(yq), ptr(resid), ptr(a8), ptr(act8)
    a.bar = ptr(BARRIER.get(dev, 4))   # the grid barrier's words
    if trace is not None:
        if trace.dtype != torch.int64 or trace.device != dev or trace.numel() < 2 + 5 * len(layers):
            raise ValueError("trace: an int64 tensor of 2 + 5·layers entries on the device")
        a.trace = ptr(trace)
    a.qkv, a.o = stacked_w4(qkv, keep, K), stacked_w4(o, keep, Hq * hd)
    a.w13, a.w2 = stacked_w4(w13, keep, K), stacked_w4(w2, keep, F)
    a.M, a.K, a.Hq, a.Hkv, a.hd, a.rot, a.S, a.F = B, K, Hq, Hkv, hd, rot, S, F
    a.Vp, a.L, a.l0, a.l1 = Vp, L, layers[0], layers[-1] + 1
    a.gelu = int(act_kind == "gelu_tanh")
    a.ln = int(norm_kind == "layernorm")
    a.inv_sqrt_hd = 1.0 / math.sqrt(hd)
    code = lib.mqt_fused_decode(ctypes.addressof(a), _build.stream_ptr(dev))
    return code, out, kv_new, logits


def layer_pack_bits(K: int, Ko: int, qkv: dict, o: dict, w13: dict, w2: dict) -> int:
    """4 or 8 when the four stacked packs of a layer share that bit width
    (W4: (L, kin/2, n); W8: (L, kin, n)), else 0."""
    bits = mlp_pack_bits(K, w13, w2)
    div = 2 if bits == 4 else 1
    if bits and qkv["wq"].shape[1] * div == K and o["wq"].shape[1] * div == Ko:
        return bits
    return 0


def _check(x, qkv, w13, w2, o, Hq, hd, act_kind, norm_kind, B_max):
    B, K = x.shape
    check_norm_kind(norm_kind, "fused decode")
    if B > B_max:
        raise NotImplementedError(f"fused decode kernel: B={B} > {B_max}")
    if not layer_pack_bits(K, Hq * hd, qkv, o, w13, w2):
        raise NotImplementedError("the fused decode kernels take all-W4 or all-W8 packs")
    if act_kind not in ("silu", "gelu_tanh"):
        raise NotImplementedError(f"fused decode kernel: act {act_kind!r}")


def fused_model_w4(x: torch.Tensor, pos: torch.Tensor, cs: torch.Tensor,
                   ofq_L: torch.Tensor, attn_norm: dict, qkv: dict, o: dict,
                   mlp_norm: dict, w13: dict, w2: dict, kcache: torch.Tensor,
                   vcache: torch.Tensor, meta_L: torch.Tensor,
                   head: Optional[dict] = None, final_norm: Optional[dict] = None, *,
                   num_q_heads: int, num_kv_heads: int, head_dim: int,
                   rotary_dim: int, act_kind: str = "silu", norm_kind: str = "rmsnorm",
                   trace: Optional[torch.Tensor] = None):
    """x (B<=8, K) fp32, pos (B,), cs (B, 2, hd), caches (L, B, Hkv, S, hd) int8
    -> (x_out (B, K), kv_new (L, B, 2 Hkv, hd) int8 [k rows; v rows]) and,
    with a W4 or W8 head pack (pack_head) and final_norm {w, b}, logits
    (B, Vp). The layer packs are all W4 or all W8; norm_kind "rmsnorm" or
    "layernorm" for every norm.
    trace: optional int64 (2 + 5 L,) device tensor that receives the global
    timer (ns) at the start and at the end of each stage (qkv, attention, o,
    w13, w2 per layer, then the head); every stage then ends in a barrier."""
    _check(x, qkv, w13, w2, o, num_q_heads, head_dim, act_kind, norm_kind, MAX_BATCH)
    if head is not None and not head_kernel_supported(head, x.shape[1]):
        raise NotImplementedError("the whole-model kernel folds W4 (K/2, Vp) or W8 (K, Vp) "
                                  "heads with Vp % 128 == 0")
    kw = dict(num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
              head_dim=head_dim, rotary_dim=rotary_dim, act_kind=act_kind,
              norm_kind=norm_kind)
    if x.device.type == "cpu":
        fused_model_w4.plain_calls += 1
        return fused_model_w4_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm,
                                    w13, w2, kcache, vcache, meta_L, head, final_norm,
                                    **kw)
    L = meta_L.shape[0]
    code, out, kv_new, logits = _launch(
        x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2, kcache, vcache, meta_L,
        list(range(L)), head, final_norm, num_q_heads, num_kv_heads, head_dim,
        rotary_dim, act_kind, norm_kind, trace)
    _build.check(code, "fused_model_w4")
    fused_model_w4.launches += 1
    return (out, kv_new) if head is None else (out, kv_new, logits)


def fused_layer_w4(x: torch.Tensor, pos: torch.Tensor, cs: torch.Tensor,
                   ofq_L: torch.Tensor, attn_norm: dict, qkv: dict, o: dict,
                   mlp_norm: dict, w13: dict, w2: dict, kcache: torch.Tensor,
                   vcache: torch.Tensor, meta_L: torch.Tensor, layer: int, *,
                   num_q_heads: int, num_kv_heads: int, head_dim: int,
                   rotary_dim: int, act_kind: str = "silu", norm_kind: str = "rmsnorm"):
    """Layer `layer` at B = 1: x (1, K) -> (x_out (1, K), kv_new (2 Hkv, hd))."""
    _check(x, qkv, w13, w2, o, num_q_heads, head_dim, act_kind, norm_kind, 1)
    kw = dict(num_q_heads=num_q_heads, num_kv_heads=num_kv_heads,
              head_dim=head_dim, rotary_dim=rotary_dim, act_kind=act_kind,
              norm_kind=norm_kind)
    if x.device.type == "cpu":
        fused_layer_w4.plain_calls += 1
        return fused_layer_w4_plain(x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm,
                                    w13, w2, kcache, vcache, meta_L, layer, **kw)
    code, out, kv_new, _ = _launch(
        x, pos, cs, ofq_L, attn_norm, qkv, o, mlp_norm, w13, w2, kcache, vcache, meta_L,
        [int(layer)], None, None, num_q_heads, num_kv_heads, head_dim, rotary_dim,
        act_kind, norm_kind)
    _build.check(code, "fused_layer_w4")
    fused_layer_w4.launches += 1
    return out, kv_new[0, 0]


fused_model_w4.launches = 0
fused_model_w4.plain_calls = 0
fused_layer_w4.launches = 0
fused_layer_w4.plain_calls = 0
