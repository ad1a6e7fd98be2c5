"""Learnable equivalent transformations (LET) and their SmoothQuant
initialization (the port of mobilequant_tpu/quant/smooth.py).

`apply_let` reparameterizes one layer's weights inside the forward (the sim's
transform_layer); `fold_let` folds LET into the stacked weights for good.
Every transform preserves the FP outputs exactly in real arithmetic:
  ln -> fcs   (scale s, shift t): ln.w /= s; ln.b = (ln.b - t) / s;
              fc.w *= s (per in-channel); fc.b += t @ fc.w
  fc1 -> fc2  (v_proj -> o_proj without GQA, w3 -> w2): fc1.w /= s (per
              out-channel), fc1.b = (b - t) / s; fc2.w *= s (per in-channel),
              fc2.b += t @ fc2.w
  q <-> k     (scale s, only when q_dim == kv_dim): q.w /= s, q.b /= s;
              k.w *= s, k.b *= s
Scales pass through truncate_scale (|s| >= 1e-2, straight-through gradient).
Weights are (in, out).
"""

from __future__ import annotations

from typing import Optional

import torch

from mobilequant_tpu_torch.models.config import ModelConfig

TRUNC_THRESHOLD = 1e-2


class _Truncate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s):
        return torch.where(s.abs() < TRUNC_THRESHOLD, torch.sign(s) * TRUNC_THRESHOLD, s)

    @staticmethod
    def backward(ctx, g):
        return g


def truncate_scale(s: torch.Tensor) -> torch.Tensor:
    """|s| < 1e-2 -> sign(s)·1e-2, with an identity gradient."""
    return _Truncate.apply(s)


# ---------------------------------------------------------------------------
# LET parameters
# ---------------------------------------------------------------------------

def has_vo_smoothing(config: ModelConfig) -> bool:
    # v_proj.out == o_proj.in, i.e. no GQA
    return config.kv_dim == config.q_dim


def has_qk_smoothing(config: ModelConfig) -> bool:
    return config.q_dim == config.kv_dim


def has_fc2_smoothing(config: ModelConfig) -> bool:
    # w3 -> w2 smoothing (MobileQuant's addition over OmniQuant)
    return config.num_linears_per_mlp == 3


def let_init(config: ModelConfig, stacked: bool = True, device="cuda") -> dict:
    """LET params with scales 1 and shifts 0, fp32 on `device`: (L, dim)
    leaves when `stacked`, else (dim,)."""
    c = config

    def mk(dim, val):
        shape = (c.num_layers, dim) if stacked else (dim,)
        return torch.full(shape, val, dtype=torch.float32, device=device)

    let = {"qkv_scale": mk(c.hidden_size, 1.0), "qkv_shift": mk(c.hidden_size, 0.0)}
    if not c.shared_attention_norm:
        let["fc1_scale"] = mk(c.hidden_size, 1.0)
        let["fc1_shift"] = mk(c.hidden_size, 0.0)
    if has_vo_smoothing(c):
        let["out_scale"] = mk(c.q_dim, 1.0)
        let["out_shift"] = mk(c.q_dim, 0.0)
    if has_fc2_smoothing(c):
        let["fc2_scale"] = mk(c.intermediate_size, 1.0)
        let["fc2_shift"] = mk(c.intermediate_size, 0.0)
    if has_qk_smoothing(c):
        let["qkt_scale"] = mk(c.q_dim, 1.0)
    return let


# ---------------------------------------------------------------------------
# The transforms (one layer)
# ---------------------------------------------------------------------------

def _smooth_ln_fcs(ln: dict, fcs: list, s, t):
    ln2 = {"w": ln["w"] / s, "b": (ln["b"] - t) / s}
    return ln2, [{"w": fc["w"] * s[:, None], "b": fc["b"] + t @ fc["w"]} for fc in fcs]


def _smooth_fc_fc(fc1: dict, fc2: dict, s, t):
    return ({"w": fc1["w"] / s[None, :], "b": (fc1["b"] - t) / s},
            {"w": fc2["w"] * s[:, None], "b": fc2["b"] + t @ fc2["w"]})


def _smooth_q_k(q: dict, k: dict, s):
    return ({"w": q["w"] / s[None, :], "b": q["b"] / s},
            {"w": k["w"] * s[None, :], "b": k["b"] * s})


def apply_let(lp: dict, let: Optional[dict], config: ModelConfig,
              truncate: bool = True) -> dict:
    """One layer's weights reparameterized by its LET params (unstacked
    leaves); the input dict is not changed."""
    if let is None:
        return lp
    c = config
    lp = dict(lp)

    def sc(name):
        return truncate_scale(let[name]) if truncate else let[name]

    # ln -> q, k, v (and w1 / w3 when the norm is shared)
    keys = ["q_proj", "k_proj", "v_proj"]
    if c.shared_attention_norm:
        keys += ["w1", "w3"] if c.num_linears_per_mlp == 3 else ["w1"]
    lp["attn_norm"], fcs = _smooth_ln_fcs(lp["attn_norm"], [lp[k] for k in keys],
                                          sc("qkv_scale"), let["qkv_shift"])
    lp.update(zip(keys, fcs))

    # ffn ln -> w1 (and w3)
    if not c.shared_attention_norm:
        keys = ["w1", "w3"] if c.num_linears_per_mlp == 3 else ["w1"]
        lp["mlp_norm"], fcs = _smooth_ln_fcs(lp["mlp_norm"], [lp[k] for k in keys],
                                             sc("fc1_scale"), let["fc1_shift"])
        lp.update(zip(keys, fcs))

    if has_vo_smoothing(c):
        lp["v_proj"], lp["o_proj"] = _smooth_fc_fc(lp["v_proj"], lp["o_proj"],
                                                   sc("out_scale"), let["out_shift"])
    if has_fc2_smoothing(c):
        lp["w3"], lp["w2"] = _smooth_fc_fc(lp["w3"], lp["w2"], sc("fc2_scale"),
                                           let["fc2_shift"])
    if has_qk_smoothing(c):
        lp["q_proj"], lp["k_proj"] = _smooth_q_k(lp["q_proj"], lp["k_proj"],
                                                 sc("qkt_scale"))
    return lp


def _stack_layers(per_layer: list):
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_layers([t[k] for t in per_layer]) for k in first}
    return torch.stack(per_layer)


def fold_let(params: dict, let: Optional[dict], config: ModelConfig) -> dict:
    """LET folded into the layer-stacked weights for good (the LET params are
    spent after it). Returns a new params dict."""
    if let is None:
        return params
    layers = params["layers"]
    folded = []
    for l in range(config.num_layers):
        lp = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in layers.items()}
        folded.append(apply_let(lp, {k: v[l] for k, v in let.items()}, config))
    return {**params, "layers": _stack_layers(folded)}


# ---------------------------------------------------------------------------
# SmoothQuant initialization
# ---------------------------------------------------------------------------

def smoothquant_scales(act_absmax, weight_absmax, alpha: float = 0.5, eps: float = 1e-5):
    """s = act^alpha / w^(1 - alpha), both clamped to >= eps, and s too."""
    a = torch.clamp(torch.as_tensor(act_absmax, dtype=torch.float32), min=eps)
    w = torch.clamp(torch.as_tensor(weight_absmax, dtype=torch.float32, device=a.device),
                    min=eps)
    return torch.clamp(torch.pow(a, alpha) / torch.pow(w, 1.0 - alpha), min=eps)


def smoothquant_let_init(config: ModelConfig, act_scales: dict, act_shifts: dict,
                         params: dict, alpha: float = 0.5, use_shift: bool = False) -> dict:
    """Initial LET params from calibration statistics (calibrate.
    smooth_calib_inputs: per-layer (L, C) input abs-max / channel midpoints
    of q_proj, w1, o_proj, w2), on the params' device. Shifts stay zero unless
    use_shift (the reference learns them from zero); the w3 -> w2 shift is
    never initialized (a shift does not commute through the gate multiply)."""
    c = config
    layers = params["layers"]
    dev = layers["q_proj"]["w"].device
    let = let_init(c, device=dev)

    def w_absmax_in(*ws):
        # per in-channel abs-max over the fan-out weights side by side
        return torch.cat([w.abs() for w in ws], dim=-1).amax(dim=-1)

    def shift(key):
        return torch.as_tensor(act_shifts[key], dtype=torch.float32, device=dev)

    let["qkv_scale"] = smoothquant_scales(
        torch.as_tensor(act_scales["q_proj"], device=dev),
        w_absmax_in(layers["q_proj"]["w"], layers["k_proj"]["w"], layers["v_proj"]["w"]),
        alpha)
    if use_shift:
        let["qkv_shift"] = shift("q_proj")
    if "fc1_scale" in let:
        fc1 = [layers["w1"]["w"]] + ([layers["w3"]["w"]] if c.num_linears_per_mlp == 3 else [])
        let["fc1_scale"] = smoothquant_scales(torch.as_tensor(act_scales["w1"], device=dev),
                                              w_absmax_in(*fc1), alpha)
        if use_shift:
            let["fc1_shift"] = shift("w1")
    if "out_scale" in let:
        let["out_scale"] = smoothquant_scales(torch.as_tensor(act_scales["o_proj"], device=dev),
                                              w_absmax_in(layers["o_proj"]["w"]), alpha)
        if use_shift:
            let["out_shift"] = shift("o_proj")
    if "fc2_scale" in let:
        let["fc2_scale"] = smoothquant_scales(torch.as_tensor(act_scales["w2"], device=dev),
                                              w_absmax_in(layers["w2"]["w"]), alpha)
    return let
