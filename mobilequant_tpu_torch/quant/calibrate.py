"""Calibration passes (the port of mobilequant_tpu/quant/calibrate.py):
activation scales / shifts for the SmoothQuant initialization and the static
activation ranges, from one collect-mode forward (quant/qmodel.py) a batch
whose per-layer statistics come back stacked over layers.

Merge rules across calibration batches (as the reference's calibration scripts):
  min / max   running min / running max
  act_scales  running max of the per-channel |x|  ("cabsmax")
  act_shifts  EMA 0.99·prev + 0.01·(cmax + cmin)/2 ("cshift")
The merged statistics are fp32 numpy arrays, merged on the host; the
derived ranges are tensors on the device asked for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant.policy import KV_CACHE_SITES, QPolicy, static_range_sites
from mobilequant_tpu_torch.quant.qmodel import qforward_hidden, ranges_from_stats
from mobilequant_tpu_torch.quant.quantizer import (
    QuantConfig, min_max_from_scale_offset, scale_offset_from_min_max)

EMA_DECAY = 0.99


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def _batches(params, tokens: np.ndarray, batch_size: int):
    dev = params["embed"]["w"].device
    for i in range(0, tokens.shape[0], batch_size):
        yield torch.as_tensor(np.asarray(tokens[i:i + batch_size]), device=dev).to(torch.long)


@torch.no_grad()
def run_calibration(params, tokens: np.ndarray, config: ModelConfig, policy: QPolicy,
                    let: Optional[dict] = None, batch_size: int = 4) -> dict:
    """The calibration sequences (N, T) through the FP model (LET-transformed
    when `let` is given), on the params' device -> merged statistics
    stats[site][role] = {"min": (L,), "max": (L,), ["cmin" / "cmax" /
    "cabsmax" / "cshift": (L, C)], ["emin" / "emax": (L, E)]}."""
    merged = None
    for batch in _batches(params, tokens, batch_size):
        _, _, st = qforward_hidden(params, {"let": let}, batch, config, policy, mode="collect")
        stats = _numpy(st)
        if merged is None:
            merged = stats
            for roles in merged.values():
                for e in roles.values():
                    if "cmin" in e:
                        e["cabsmax"] = np.maximum(np.abs(e["cmin"]), np.abs(e["cmax"]))
                        e["cshift"] = (e["cmax"] + e["cmin"]) / 2.0
            continue
        for s, roles in stats.items():
            for r, e in roles.items():
                m = merged[s][r]
                m["min"] = np.minimum(m["min"], e["min"])
                m["max"] = np.maximum(m["max"], e["max"])
                if "emin" in e:
                    m["emin"] = np.minimum(m["emin"], e["emin"])
                    m["emax"] = np.maximum(m["emax"], e["emax"])
                if "cmin" in e:
                    cab = np.maximum(np.abs(e["cmin"]), np.abs(e["cmax"]))
                    m["cabsmax"] = np.maximum(m["cabsmax"], cab)
                    mid = (e["cmax"] + e["cmin"]) / 2.0
                    m["cshift"] = EMA_DECAY * m["cshift"] + (1 - EMA_DECAY) * mid
                    m["cmin"] = np.minimum(m["cmin"], e["cmin"])
                    m["cmax"] = np.maximum(m["cmax"], e["cmax"])
    return merged


# ---------------------------------------------------------------------------
# Derivations from merged statistics
# ---------------------------------------------------------------------------

def stats_to_ranges(stats: dict, policy: QPolicy, device="cuda") -> dict:
    """Static activation ranges (the LRL-learnable scale / offset leaves) on
    `device`. MoE sites with per-expert envelopes give (L, E) leaves; an
    expert never routed in calibration takes the per-stack envelope."""
    def mnmx(e):
        mn, mx = np.asarray(e["min"]), np.asarray(e["max"])
        if "emin" in e:
            emn, emx = np.asarray(e["emin"]), np.asarray(e["emax"])
            mn = np.where(np.isfinite(emn), emn, mn[..., None])
            mx = np.where(np.isfinite(emx), emx, mx[..., None])
        return (torch.as_tensor(mn, dtype=torch.float32, device=device),
                torch.as_tensor(mx, dtype=torch.float32, device=device))

    return ranges_from_stats({s: {r: mnmx(e) for r, e in roles.items()}
                              for s, roles in stats.items()}, policy)


def ranges_for_kv_bits(ranges: dict, kv_bits: int, old_bits: int = 8) -> dict:
    """The KV-cache range entries re-derived for another cache bitwidth: the
    min / max envelope does not depend on the bitwidth, so scale / offset
    follow from it for the new qmax (policy.kv_bits_policy gives the
    matching policy)."""
    if kv_bits == old_bits:
        return ranges
    old_cfg, new_cfg = QuantConfig(bitwidth=old_bits), QuantConfig(bitwidth=kv_bits)
    out = {s: dict(roles) for s, roles in ranges.items()}
    for site, role in KV_CACHE_SITES:
        r = ranges[site][role]
        mn, mx = min_max_from_scale_offset(r["scale"], r["offset"], old_cfg)
        s, o = scale_offset_from_min_max(mn, mx, new_cfg)
        out[site] = dict(out[site])
        out[site][role] = {"scale": s, "offset": o}
    return out


def smooth_calib_inputs(stats: dict, device="cuda"):
    """(act_scales, act_shifts) for smooth.smoothquant_let_init: per-layer
    (L, C) tensors of the q_proj / w1 / o_proj / w2 inputs' abs-max and
    channel midpoints, on `device`."""
    key_map = {"q_proj": "self_attn.q_proj", "w1": "mlp.w1",
               "o_proj": "self_attn.o_proj", "w2": "mlp.w2"}
    act_scales, act_shifts = {}, {}
    for short, site in key_map.items():
        if site in stats and "input" in stats[site]:
            e = stats[site]["input"]
            act_scales[short] = torch.as_tensor(e["cabsmax"], device=device)
            act_shifts[short] = torch.as_tensor(e["cshift"], device=device)
    return act_scales, act_shifts


def stats_to_act_dict(stats: dict, config: ModelConfig) -> dict:
    """act_dict.json's schema: per-op {input / input2 / output: [min, max]}
    keyed by the full module name (per-expert sites: [[mins], [maxs]])."""
    out: dict = {}
    for site, roles in stats.items():
        for i in range(config.num_layers):
            entry = out.setdefault(f"model.layers.{i}.{site}", {})
            for role, e in roles.items():
                if "emin" in e:
                    emn, emx = np.asarray(e["emin"])[i], np.asarray(e["emax"])[i]
                    fb_n, fb_x = float(np.asarray(e["min"])[i]), float(np.asarray(e["max"])[i])
                    entry[role] = [[float(v) if np.isfinite(v) else fb_n for v in emn],
                                   [float(v) if np.isfinite(v) else fb_x for v in emx]]
                else:
                    entry[role] = [float(np.asarray(e["min"])[i]),
                                   float(np.asarray(e["max"])[i])]
    return out


def act_dict_to_stats(act_dict: dict, config: ModelConfig) -> dict:
    """Inverse of stats_to_act_dict: an act_dict into stacked min / max."""
    L = config.num_layers
    stats: dict = {}
    for name, roles in act_dict.items():
        parts = name.split(".")
        if len(parts) < 4 or parts[0] != "model" or parts[1] != "layers":
            continue
        layer, site = int(parts[2]), ".".join(parts[3:])
        for role, (mn, mx) in roles.items():
            e = stats.setdefault(site, {}).setdefault(role, {})
            if isinstance(mn, (list, tuple)):       # a per-expert entry
                e.setdefault("emin", np.zeros((L, len(mn)), np.float32))
                e.setdefault("emax", np.zeros((L, len(mn)), np.float32))
                e["emin"][layer] = mn
                e["emax"][layer] = mx
                mn, mx = min(mn), max(mx)
            e.setdefault("min", np.zeros(L, np.float32))
            e.setdefault("max", np.zeros(L, np.float32))
            e["min"][layer] = mn
            e["max"][layer] = mx
    return stats


def ranges_to_act_dict(ranges: dict, policy: QPolicy, config: ModelConfig) -> dict:
    """Learned (LRL) ranges back to act_dict.json's min / max."""
    out: dict = {}
    for site, role, cfg in static_range_sites(policy):
        r = ranges[site][role]
        mn, mx = min_max_from_scale_offset(r["scale"], r["offset"], cfg)
        mn, mx = mn.detach().cpu().numpy(), mx.detach().cpu().numpy()
        for i in range(config.num_layers):
            val = ([mn[i].tolist(), mx[i].tolist()] if mn.ndim == 2
                   else [float(mn[i]), float(mx[i])])
            out.setdefault(f"model.layers.{i}.{site}", {})[role] = val
    return out


# ---------------------------------------------------------------------------
# smooth_last: the final-norm -> lm_head SmoothQuant fold
# ---------------------------------------------------------------------------

@torch.no_grad()
def head_input_absmax(params, tokens: np.ndarray, config: ModelConfig,
                      batch_size: int = 4) -> torch.Tensor:
    """Per-channel abs-max of the final norm's output (the head's input) over
    the calibration sequences, (D,) on the params' device."""
    am = None
    for batch in _batches(params, tokens, batch_size):
        h, _, _ = M.forward_hidden(params, batch, config, apply_final_norm=True)
        cur = h.reshape(-1, h.shape[-1]).abs().amax(dim=0)
        am = cur if am is None else torch.maximum(am, cur)
    return am


def smooth_last_scales(act_absmax, head_w, alpha: float = 0.5) -> torch.Tensor:
    """s = clamp(act^alpha / w^(1 - alpha), 1e-5) per head-input channel,
    with w the (D, vocab) head's row abs-max: divided into the final norm's
    weight and bias and multiplied into the head's input rows, it moves the
    outlier channels' range into the per-channel-quantized head."""
    w_absmax = head_w.abs().amax(dim=1).to(torch.float32)
    a = torch.as_tensor(act_absmax, dtype=torch.float32, device=w_absmax.device)
    s = a ** alpha / torch.clamp(w_absmax, min=1e-8) ** (1.0 - alpha)
    return torch.clamp(s, min=1e-5)

