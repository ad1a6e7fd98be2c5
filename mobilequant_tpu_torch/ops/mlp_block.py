"""The whole MLP block of one layer in one kernel:

  x (M, K) fp32 -> [fq16] -> RMS norm -> quantize -> W4 w1|w3 -> output fq
  -> gate chain (SiLU with its sigmoid fq, or gelu_tanh) -> fq -> ·g3
  -> w2-input int8 -> W4 w2 -> output fq -> resid_add_2 -> (M, K) fp32

Kernel: csrc/fused_layer.cu (mqt_fused_mlp_block), which replaces the JAX
package's mobilequant_tpu/ops/pallas_mlp.py fused_mlp_block_w4_stacked
(_w4_mlp_block_kernel, phase body _w4_mlp_phase). Bound: the bytes of the two
W4 weight matrices at decode-sized M (<= stacked_bt_max = 64 rows). Design:
one cooperative launch, two stages split by a grid barrier: every block
normalises and quantizes its chunk of up to 8 rows itself, the w13 matvec runs
over tiles that hold the w1 and w3 columns of 64 gate outputs and finishes the
gate chain in the block that completes a tile; after the barrier the w2
matvec and its epilogue write the output. The (M, F) int8 gate output is the
only intermediate that leaves the chip's caches.

meta is the JAX engine's 32-float _mlp_block_meta (engine._mlp_block_meta):
[0..1] MLP-input encoding, [2..13] the w1 / sigmoid / act / w3 fake-quant
sites, [14..15] the w2-input encoding, [16..18] the norm-input fq16, [19]
norm_eps, [20..31] the w2-output and resid_add_2 fq16 sites; a site is off
when its qmax entry is 0. site_on gives the nine sites' static enables (the
plain version skips a site that is off, as the JAX phase body does).

This module also holds the ctypes mirror of the argument block that the
fused kernels of csrc/fused_layer.cu take (FusedArgs).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from mobilequant_tpu_torch.ops import _build
from mobilequant_tpu_torch.ops.qops import quantize_act
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack, w4a8_matmul_plain
from mobilequant_tpu_torch.ops.w13_gate import _fq, w13_gate_plain

_P = ctypes.c_void_p
_I = ctypes.c_int


class StackedW4(ctypes.Structure):
    """MqtStackedW4: one layer-stacked W4 pack as the kernels read it."""
    _fields_ = [("wq", _P), ("scale", _P), ("offset", _P), ("colsum", _P),
                ("bias", _P), ("s_l", ctypes.c_longlong), ("s_c", _I),
                ("kin", _I), ("n", _I), ("pad_", _I)]


class FusedArgs(ctypes.Structure):
    """MqtFusedArgs of csrc/fused_layer.cu (field for field)."""
    _fields_ = ([(n, _P) for n in (
        "x_in", "x_out", "kv_new", "logits", "pos", "cs", "meta", "ofq", "anw",
        "anb", "mnw", "mnb", "kcache", "vcache", "hwq", "hscale", "hoffset",
        "fnw", "fnb", "yq", "resid", "a8", "act8", "ws", "bar", "trace")]
                + [(n, StackedW4) for n in ("qkv", "o", "w13", "w2")]
                + [(n, _I) for n in ("M", "K", "Hq", "Hkv", "hd", "rot", "S", "F",
                                     "Vp", "L", "l0", "l1", "gelu", "pad_")]
                + [("inv_sqrt_hd", ctypes.c_float),
                   ("mlp_meta", ctypes.c_float * 32)])


WS_COUNTERS = 8192       # tile counters at the head of the split-K workspace
BARRIER = _build.Workspace()   # per-device grid-barrier words


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def stacked_w4(pack: dict, keep: list) -> StackedW4:
    """The StackedW4 of a layer-stacked W4 pack {wq (L, kin/2, n), scale /
    offset (L, 1, n) per channel or (L,) per tensor, colsum (L, n), bias}.
    Converted operands are appended to `keep` so they outlive the launch."""
    wq = _build.aligned(pack["wq"], 16)
    L, k2, n = wq.shape
    sc = pack["scale"].to(torch.float32).contiguous()
    of = pack["offset"].to(torch.float32).contiguous()
    if sc.shape != of.shape:
        raise ValueError("scale and offset must share one layout")
    if sc.numel() == L:
        s_l, s_c = 1, 0
    elif sc.numel() == L * n:
        s_l, s_c = n, 1
    else:
        raise ValueError(f"scale of {sc.numel()} entries for L={L}, n={n}")
    cs = pack["colsum"].to(torch.float32).contiguous().reshape(L, n)
    b = pack.get("bias")
    b = None if b is None else b.to(torch.float32).contiguous().reshape(L, n)
    keep += [wq, sc, of, cs, b]
    return StackedW4(ptr(wq), ptr(sc), ptr(of), ptr(cs), ptr(b), s_l, s_c,
                     2 * k2, n, 0)


def sum_f32(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Σ over `dim` (keepdim) accumulated in fp64 and rounded once to fp32: the
    same fp32 value whatever the summation order, as the fused kernels sum."""
    return t.to(torch.float64).sum(dim, keepdim=True).to(torch.float32)


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x²) + eps), the sum of squares by sum_f32."""
    return x * (1.0 / torch.sqrt(sum_f32(x * x) / x.shape[-1] + eps))


def mlp_block_supported(K: int, F: int) -> bool:
    return K % 128 == 0 and F % 64 == 0


def fused_mlp_block_w4_plain(x: torch.Tensor, norm_w: torch.Tensor,
                             norm_b: torch.Tensor, w13: dict, w2: dict,
                             meta: Sequence[float], act_kind: str = "silu",
                             site_on: tuple = (True,) * 9) -> torch.Tensor:
    """The kernel's function in PyTorch operators, over one layer's packs and
    norm vectors (K,); the order of fp32 operations is the JAX phase body's,
    the norm's sum of squares is order-independent (sum_f32)."""
    m = [float(v) for v in meta]
    s_x16, s_w1, s_sig, s_act, s_w3, s_w2o, s_r1, s_r2, s_ro = site_on

    def fq(v, i, on):
        return _fq(v, m[i], m[i + 1], m[i + 2]) if on else v

    xf = x.to(torch.float32)
    xx = fq(xf, 16, s_x16)
    h8 = quantize_act(rms_norm(xx, m[19]) * norm_w + norm_b, m[0], m[1])
    act8 = w13_gate_plain(h8, w13, m[:16], act_kind, (s_w1, s_sig, s_act, s_w3))
    y2 = w4a8_matmul_plain(act8, w2["wq"], w2["scale"], w2["offset"], w2["colsum"],
                           w2.get("bias"), m[14], m[15])
    y2 = fq(y2, 20, s_w2o)
    xr = fq(xf, 23, s_r1)
    y2 = fq(y2, 26, s_r2)
    return fq(xr + y2, 29, s_ro)


def fused_mlp_block_w4(x: torch.Tensor, norm_w: torch.Tensor, norm_b: torch.Tensor,
                       w13: dict, w2: dict, meta: Sequence[float], layer: int,
                       act_kind: str = "silu",
                       site_on: tuple = (True,) * 9) -> torch.Tensor:
    """x (M, K) fp32 residual -> x + MLP(norm(x)) for layer `layer` of the
    stacked W4 packs (w13 wq (L, K/2, 2F), w2 wq (L, F/2, K)) and the stacked
    norm vectors (L, K). M <= 64."""
    M, K = x.shape
    L, K2, F2 = w13["wq"].shape
    F = F2 // 2
    if K2 * 2 != K or tuple(w2["wq"].shape[1:]) != (F // 2, K):
        raise NotImplementedError("the MLP-block kernel takes W4 packs")
    if not mlp_block_supported(K, F) or M > 64:
        raise NotImplementedError(f"MLP-block kernel: M={M}, K={K}, F={F}")
    if act_kind not in ("silu", "gelu_tanh"):
        raise NotImplementedError(f"MLP-block kernel: act {act_kind!r}")
    if x.device.type == "cpu":
        fused_mlp_block_w4.plain_calls += 1
        return fused_mlp_block_w4_plain(x, norm_w[layer], norm_b[layer],
                                        layer_pack(w13, layer), layer_pack(w2, layer),
                                        meta, act_kind, site_on)
    dev = _build.require_cuda(x, norm_w, norm_b, w13["wq"], w2["wq"])
    lib = _build.lib()
    keep = []
    xin = _build.aligned(x.to(torch.float32))
    nw = norm_w.to(torch.float32).contiguous()
    nb = norm_b.to(torch.float32).contiguous()
    out = torch.empty((M, K), dtype=torch.float32, device=dev)
    act8 = torch.empty((M, F), dtype=torch.int8, device=dev)
    ws = _build.WORKSPACE.get(dev, WS_COUNTERS + M * F2)
    bar = BARRIER.get(dev, 2)
    a = FusedArgs()
    a.x_in, a.x_out, a.mnw, a.mnb = ptr(xin), ptr(out), ptr(nw), ptr(nb)
    a.act8, a.ws, a.bar = ptr(act8), ptr(ws), ptr(bar)
    a.w13 = stacked_w4(w13, keep)
    a.w2 = stacked_w4(w2, keep)
    a.M, a.K, a.F, a.L, a.l0, a.l1 = M, K, F, L, int(layer), int(layer) + 1
    a.gelu = int(act_kind == "gelu_tanh")
    for i, v in enumerate(list(meta)[:32]):
        a.mlp_meta[i] = float(v)
    code = lib.mqt_fused_mlp_block(ctypes.addressof(a), _build.stream_ptr(dev))
    _build.check(code, "fused_mlp_block_w4")
    fused_mlp_block_w4.launches += 1
    return out


fused_mlp_block_w4.launches = 0
fused_mlp_block_w4.plain_calls = 0
