"""Uniform quantizer math (the port of mobilequant_tpu/quant/quantizer.py).

Pure functions over fp32 tensors; the arithmetic follows the JAX module op for
op so that packs built here are bit-identical to the JAX package's:
  * scale = alpha / q_max, clamped to [1e-5, 1e6]
  * offset = -round(beta / scale)   (round half to even, as jnp.round)
  * symmetric: alpha = max(|min|,|max|), q in [-2^(b-1), 2^(b-1)-1], offset = 0
  * asymmetric: alpha = max-min, q in [0, 2^b-1]
  * fake quant: deq = (clip(round(x/scale)+offset, qmin, qmax) - offset) * scale
  * bitwidth > 16 disables quantization
Linear weights are (in_features, out_features): per-channel statistics reduce
over axis -2; grouped (g128-style) statistics over groups of `group_size`
input rows, (..., G, 1, out).

Gradients follow jax.grad of the JAX functions: rounding passes the
gradient straight through (round_ste), the clip splits it evenly where a
value lies on a bound (jnp.clip is maximum then minimum, and both split
ties), and min / max reductions split it among equal elements (amin / amax).
LWC (learned weight clipping): the weight's min / max scaled by
sigmoid(bound factor), the factors initialised to 4.0 (sigmoid ~ 0.982).
"""

from __future__ import annotations

import dataclasses
import torch

CLIPMIN = 1e-5
CLIPMAX = 1e6
LWC_INIT = 4.0


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    bitwidth: int = 32
    group_size: int = -1
    is_symmetric: bool = False
    is_per_channel: bool = False
    is_dynamic: bool = False

    @property
    def enabled(self) -> bool:
        return self.bitwidth <= 16

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bitwidth - 1)) if self.is_symmetric else 0

    @property
    def qmax(self) -> int:
        return 2 ** (self.bitwidth - 1) - 1 if self.is_symmetric else 2 ** self.bitwidth - 1

    @classmethod
    def from_dict(cls, d: dict) -> "QuantConfig":
        """From the per-site schema of default_qcfg.json, whose booleans are
        strings ("True" / "true") or JSON booleans."""
        def b(v):
            return v in (True, "True", "true")
        return cls(bitwidth=int(d["bitwidth"]), group_size=int(d["group_size"]),
                   is_symmetric=b(d["is_symmetric"]), is_per_channel=b(d["is_per_channel"]),
                   is_dynamic=b(d["is_dynamic"]))

    def to_dict(self) -> dict:
        return {"bitwidth": str(self.bitwidth), "group_size": str(self.group_size),
                "is_symmetric": str(self.is_symmetric),
                "is_per_channel": str(self.is_per_channel),
                "is_dynamic": str(self.is_dynamic)}

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """round half to even (as jnp.round) with an identity gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _RoundSTE.apply(x)
    return torch.round(x)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """clamp(x, lo, hi); under autograd maximum then minimum, whose gradient
    splits evenly where x lies on a bound, as jnp.clip's does."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    if not isinstance(lo, torch.Tensor):
        lo = torch.full((), float(lo), dtype=x.dtype, device=x.device)
    if not isinstance(hi, torch.Tensor):
        hi = torch.full((), float(hi), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _f32(v, like=None) -> torch.Tensor:
    dev = like.device if like is not None else None
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def scale_offset_from_min_max(min_val, max_val, qcfg: QuantConfig):
    """-> (scale, offset) fp32 tensors broadcastable against the tensor."""
    min_val = _f32(min_val)
    max_val = _f32(max_val, min_val)
    if qcfg.is_symmetric:
        alpha = torch.maximum(min_val.abs(), max_val.abs())
        beta = torch.zeros_like(alpha)
    else:
        alpha = max_val - min_val
        beta = min_val
    scale = _clip(true_div(alpha, qcfg.qmax), CLIPMIN, CLIPMAX)
    offset = -torch.round(beta / scale)           # no gradient, as jnp.round's
    return scale, offset


def min_max_from_scale_offset(scale, offset, qcfg: QuantConfig):
    scale = torch.clamp(_f32(scale), CLIPMIN, CLIPMAX)
    alpha = scale * qcfg.qmax
    beta = -_f32(offset, scale) * scale
    max_val = alpha + beta
    min_val = -max_val if qcfg.is_symmetric else beta
    return min_val, max_val


_DIVISORS: dict = {}


def true_div(x: torch.Tensor, s) -> torch.Tensor:
    """x / s rounded as one true fp32 division on every device. PyTorch on the
    card divides by a host scalar as a multiply by its reciprocal, one ulp off
    the true division that the CPU and the kernels do, which moves a rounding
    at a tie by a whole quantization step; there the divisor becomes a 0-dim
    fp32 tensor on x's device, made once per value and device (and not kept
    when made inside a CUDA graph capture, which fills it only at replay)."""
    if isinstance(s, torch.Tensor) or x.device.type == "cpu":
        return x / s
    key = (float(s), x.device)
    d = _DIVISORS.get(key)
    if d is None:
        d = torch.full((), float(s), dtype=torch.float32, device=x.device)
        if not torch.cuda.is_current_stream_capturing():
            _DIVISORS[key] = d
    return x / d


def fake_quant(x: torch.Tensor, scale, offset, qcfg: QuantConfig):
    """Static-range quant -> clip -> dequant (gradients to x, scale and
    offset through round_ste)."""
    if not qcfg.enabled:
        return x
    q = round_ste(true_div(x.to(torch.float32), scale)) + offset
    q = _clip(q, qcfg.qmin, qcfg.qmax)
    return ((q - offset) * scale).to(x.dtype)


def _group_reshape(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """(..., in, out) -> (..., n_groups, gs, out); groups along the input axis."""
    *lead, d_in, d_out = w.shape
    if d_in % group_size:
        raise ValueError(f"in={d_in} not divisible by group={group_size}")
    return w.reshape(*lead, d_in // group_size, group_size, d_out)


def weight_min_max(w: torch.Tensor, qcfg: QuantConfig):
    """min/max statistics of a (..., in, out) weight (leading axes are
    independent linears): per-tensor -> scalars, per-channel -> (..., 1, out),
    per-channel grouped -> (..., G, 1, out)."""
    if qcfg.is_per_channel:
        if qcfg.group_size != -1:
            wg = _group_reshape(w, qcfg.group_size)
            return wg.amin(dim=-2, keepdim=True), wg.amax(dim=-2, keepdim=True)
        return w.amin(dim=-2, keepdim=True), w.amax(dim=-2, keepdim=True)
    return w.amin(), w.amax()


def lwc_init(w: torch.Tensor, qcfg: QuantConfig, device=None) -> dict:
    """Initial LWC bound factors {"up", "low"} (fp32, LWC_INIT) in the shape
    of weight_min_max's statistics: () per tensor, (..., 1, out) per channel,
    (..., G, 1, out) grouped."""
    if qcfg.is_per_channel:
        if qcfg.group_size != -1:
            shape = w.shape[:-2] + (w.shape[-2] // qcfg.group_size, 1, w.shape[-1])
        else:
            shape = w.shape[:-2] + (1, w.shape[-1])
    else:
        shape = ()
    dev = w.device if device is None else device
    return {k: torch.full(shape, LWC_INIT, dtype=torch.float32, device=dev)
            for k in ("up", "low")}


def _lwc_bounds(w: torch.Tensor, qcfg: QuantConfig, lwc):
    mn, mx = weight_min_max(w, qcfg)
    if lwc is not None:
        mx = torch.sigmoid(lwc["up"]) * mx
        mn = torch.sigmoid(lwc["low"]) * mn
    return mn, mx


def fake_quant_weight(w: torch.Tensor, qcfg: QuantConfig, lwc=None):
    """On-the-fly weight fake-quant from the weight's own min / max (per group
    of input rows when grouped), clipped by the learned bounds when lwc
    ({"up", "low"} bound factors) is given."""
    if not qcfg.enabled:
        return w
    wf = w.to(torch.float32)
    grouped = qcfg.is_per_channel and qcfg.group_size != -1
    x = _group_reshape(wf, qcfg.group_size) if grouped else wf
    scale, offset = scale_offset_from_min_max(*_lwc_bounds(wf, qcfg, lwc), qcfg)
    q = _clip(round_ste(x / scale) + offset, qcfg.qmin, qcfg.qmax)
    return ((q - offset) * scale).reshape(wf.shape).to(w.dtype)


def clip_weight_to_learned_bounds(w: torch.Tensor, qcfg: QuantConfig, lwc):
    """Clamp a weight into its learned LWC bounds for good (the end of
    training: the clip that fake_quant_weight(lwc=) applies online)."""
    if lwc is None or not qcfg.enabled:
        return w
    wf = w.to(torch.float32)
    grouped = qcfg.is_per_channel and qcfg.group_size != -1
    x = _group_reshape(wf, qcfg.group_size) if grouped else wf
    mn, mx = _lwc_bounds(wf, qcfg, lwc)
    return _clip(x, mn, mx).reshape(wf.shape).to(w.dtype)
