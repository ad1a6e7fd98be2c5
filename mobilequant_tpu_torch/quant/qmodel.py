"""The fake-quant simulation model (the port of mobilequant_tpu/quant/qmodel.py).

The FP decoder (models/model.py) runs with a `QuantOps` interceptor that, in
"sim" mode, applies fake quantization at every policy site with static
activation ranges, reparameterizes each layer's weights with LET and clips
the weights with LWC; in "collect" mode it applies nothing and records each
site's min / max (per channel at the projections' inputs, per expert over
each expert's routed tokens at the MoE sites) for calibration.

Quant state, every leaf stacked over layers and sliced per layer:
  ranges[site][role] = {"scale": (L,) or (L, E), "offset": the same}   (LRL)
  lwc[site]          = {"up": (L, ...), "low": (L, ...)}              (LWC)
  let[...]           = quant/smooth.let_init's leaves                  (LET)
"""

from __future__ import annotations

from typing import Optional

import torch

from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant import smooth
from mobilequant_tpu_torch.quant.policy import QPolicy, static_range_sites
from mobilequant_tpu_torch.quant.quantizer import (
    QuantConfig, fake_quant, fake_quant_weight, lwc_init, scale_offset_from_min_max)


# ---------------------------------------------------------------------------
# Quant state constructors
# ---------------------------------------------------------------------------

def ranges_init(policy: QPolicy, config: ModelConfig, device="cuda") -> dict:
    """Placeholder static ranges (scale 1, offset 0), replaced by calibration."""
    L = config.num_layers
    out = {}
    for site, role, _ in static_range_sites(policy):
        out.setdefault(site, {})[role] = {"scale": torch.ones(L, device=device),
                                          "offset": torch.zeros(L, device=device)}
    return out


def ranges_from_stats(stats: dict, policy: QPolicy) -> dict:
    """stats[site][role] = (min, max) tensors, (L,) or (L, E) -> scale /
    offset leaves."""
    out = {}
    for site, role, cfg in static_range_sites(policy):
        scale, offset = scale_offset_from_min_max(*stats[site][role], cfg)
        out.setdefault(site, {})[role] = {"scale": scale, "offset": offset}
    return out


SITE_TO_PARAM = {
    "self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj", "self_attn.o_proj": "o_proj",
    "mlp.w1": "w1", "mlp.w2": "w2", "mlp.w3": "w3",
    "input_layernorm": "attn_norm", "post_attention_layernorm": "mlp_norm",
}


def lwc_init_all(params: dict, policy: QPolicy) -> dict:
    """LWC bound factors of every projection site with a weight quantizer of
    at most 8 bits, stacked over layers, on the params' device (the 16-bit
    norm weight quantizers take none)."""
    out = {}
    layers = params["layers"]
    for site, sq in policy.items():
        if sq.weight is None or not sq.weight.enabled or sq.weight.bitwidth > 8:
            continue
        pkey = SITE_TO_PARAM.get(site)
        if pkey is None or pkey not in layers:
            continue
        w = layers[pkey]["w"]
        one = lwc_init(w[0], sq.weight)
        out[site] = {k: v.expand((w.shape[0],) + v.shape).clone() for k, v in one.items()}
    return out


# ---------------------------------------------------------------------------
# The interceptor
# ---------------------------------------------------------------------------

class QuantOps(M.Ops):
    """Fake-quant ("sim") or range-collection ("collect") op implementations."""

    # linear sites whose inputs get per-channel statistics (SmoothQuant init)
    PER_CHANNEL_INPUT_SITES = frozenset({
        "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
        "self_attn.o_proj", "mlp.w1", "mlp.w2", "mlp.w3",
    })

    def __init__(self, policy: QPolicy, config: ModelConfig, mode: str = "sim"):
        if mode not in ("sim", "collect"):
            raise ValueError(f"mode must be 'sim' or 'collect', got {mode!r}")
        self.policy = policy
        self.config = config
        self.mode = mode
        self.ranges = None
        self.lwc = None
        self.let = None
        self._stats: dict = {}
        self._expert_mask = None   # (B,T,E) bool, set by moe_dispatch

    def begin_layer(self, extras: Optional[dict]):
        extras = extras or {}
        self.ranges = extras.get("ranges")
        self.lwc = extras.get("lwc")
        self.let = extras.get("let")
        self._expert_mask = None

    def moe_dispatch(self, combine):
        """Remember which tokens route where: collect mode records each
        expert's statistics over its routed tokens, sim mode broadcasts
        per-expert ranges over the expert axis."""
        self._expert_mask = combine > 0

    def pop_stats(self) -> dict:
        s, self._stats = self._stats, {}
        return s

    # --- helpers ---------------------------------------------------------

    def _record(self, site, role, x):
        xf = x.detach().to(torch.float32)
        entry = {"min": xf.amin(), "max": xf.amax()}
        if role == "input" and site in self.PER_CHANNEL_INPUT_SITES:
            axes = tuple(range(x.dim() - 1))
            entry["cmin"] = xf.amin(dim=axes)
            entry["cmax"] = xf.amax(dim=axes)
        mask = self._expert_mask
        if (mask is not None and x.dim() == 4 and site.startswith("mlp.")
                and x.shape[2] == mask.shape[2]):
            # per-expert envelopes over each expert's routed tokens (an
            # unrouted expert keeps +-inf; stats_to_ranges falls back to the
            # per-stack envelope)
            mk = mask[..., None]
            entry["emin"] = torch.where(mk, xf, torch.inf).amin(dim=(0, 1, 3))
            entry["emax"] = torch.where(mk, xf, -torch.inf).amax(dim=(0, 1, 3))
        self._stats.setdefault(site, {})[role] = entry

    def _fq_act(self, site: str, role: str, x):
        if self.mode == "collect":
            # every observable tensor, also where the policy has no quantizer
            # (SmoothQuant reads the q/k/v/o/w1/w3 input statistics)
            self._record(site, role, x)
            return x
        sq = self.policy.get(site)
        if sq is None:
            return x
        cfg: Optional[QuantConfig] = getattr(sq, role)
        if cfg is None or not cfg.enabled:
            return x
        if cfg.is_dynamic:
            scale, offset = scale_offset_from_min_max(x.amin(), x.amax(), cfg)
        else:
            r = self.ranges[site][role]
            scale, offset = r["scale"], r["offset"]
        if scale.dim() == 1 and x.dim() == 4 and scale.shape[0] == x.shape[2]:
            # per-expert (E,) ranges over the (B,T,E,·) expert axis
            scale, offset = scale[:, None], offset[:, None]
        return fake_quant(x, scale, offset, cfg)

    def _fq_weight(self, site: str, w):
        sq = self.policy.get(site)
        if sq is None or sq.weight is None or not sq.weight.enabled or self.mode == "collect":
            return w
        lwc = self.lwc.get(site) if self.lwc is not None else None
        return fake_quant_weight(w, sq.weight, lwc)

    # --- op overrides ----------------------------------------------------

    def transform_layer(self, lp, config):
        return smooth.apply_let(lp, self.let, config)

    def linear(self, site, x, w, b):
        x = self._fq_act(site, "input", x)
        y = x @ self._fq_weight(site, w) + b
        return self._fq_act(site, "output", y)

    def expert_linear(self, site, x, w, b):
        """MoE expert projections: the dense site's policy, with per-expert
        activation ranges where calibration made them."""
        x = self._fq_act(site, "input", x)
        y = super().expert_linear(site, x, self._fq_weight(site, w), b)
        return self._fq_act(site, "output", y)

    def rmsnorm(self, site, x, w, b, eps):
        x = self._fq_act(site, "input", x)
        y = super().rmsnorm(site, x, self._fq_weight(site, w), b, eps)
        return self._fq_act(site, "output", y)

    def layernorm(self, site, x, w, b, eps):
        x = self._fq_act(site, "input", x)
        y = super().layernorm(site, x, self._fq_weight(site, w), b, eps)
        return self._fq_act(site, "output", y)

    def qk_matmul(self, site, q, k):
        q = self._fq_act(site, "input", q)
        k = self._fq_act(site, "input2", k)   # the K-cache encoding
        return self._fq_act(site, "output", super().qk_matmul(site, q, k))

    def pv_matmul(self, site, p, v):
        p = self._fq_act(site, "input", p)
        v = self._fq_act(site, "input2", v)   # the V-cache encoding
        return self._fq_act(site, "output", super().pv_matmul(site, p, v))

    def add(self, site, a, b):
        """The residual adds (resid_add_1 / 2): 16-bit inputs and output in
        the strict policy, off in the relaxed one."""
        a = self._fq_act(site, "input", a)
        b = self._fq_act(site, "input2", b)
        return self._fq_act(site, "output", a + b)

    def act_fn(self, site, x, kind):
        if kind == "silu":
            out = x * self._fq_act(site, "input2", torch.sigmoid(x))
        else:
            out = super().act_fn(site, x, kind)
        return self._fq_act(site, "output", out)


# ---------------------------------------------------------------------------
# Quantized forwards
# ---------------------------------------------------------------------------

def require_fp32_matmuls(device) -> None:
    """The sim and the training run in fp32: on the card, refuse TF32
    matmuls (torch.backends.cuda.matmul.allow_tf32), which round the inputs
    to 10 mantissa bits and would move the sim off the integer engine."""
    if torch.device(device).type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the fake-quant sim needs full fp32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def qforward_hidden(params, qstate, tokens, config: ModelConfig, policy: QPolicy,
                    mode: str = "sim", positions=None, kv_cache=None,
                    cache_position=None, kv_valid_len=None, apply_final_norm=True,
                    remat: bool = False):
    """The backbone with quantization. qstate = {"ranges", "lwc", "let"}
    (any may be absent or None). -> (hidden, kv, stats or None)."""
    require_fp32_matmuls(params["embed"]["w"].device)
    ops = QuantOps(policy, config, mode)
    extras = {k: v for k, v in (qstate or {}).items() if v is not None}
    return M.forward_hidden(params, tokens, config, ops, positions, kv_cache,
                            cache_position, kv_valid_len,
                            collect_stats=(mode == "collect"),
                            layer_extras=extras or None,
                            apply_final_norm=apply_final_norm, remat=remat)


def head_weight(params: dict, config: ModelConfig) -> torch.Tensor:
    """The (D, vocab) head: the embedding's transpose when tied."""
    return params["embed"]["w"].T if config.tie_word_embeddings else params["lm_head"]["w"]


def qforward(params, qstate, tokens, config: ModelConfig, policy: QPolicy,
             mode: str = "sim", positions=None, kv_cache=None,
             cache_position=None, kv_valid_len=None):
    """Quantized causal-LM forward -> (logits, kv, stats or None)."""
    x, kv, stats = qforward_hidden(params, qstate, tokens, config, policy, mode,
                                   positions, kv_cache, cache_position, kv_valid_len)
    return x @ head_weight(params, config), kv, stats
