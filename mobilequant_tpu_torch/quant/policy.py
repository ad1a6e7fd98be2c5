"""Quantizer-placement policy (the port of mobilequant_tpu/quant/policy.py).

One declarative table says which quantizer sits at which site of a decoder
layer; the engine reads placement and bitwidths from here only.

Site naming (inside one decoder layer):
  input_layernorm, post_attention_layernorm,
  self_attn.{q_proj,k_proj,v_proj,o_proj,qk_bmm,pv_bmm},
  mlp.{w1,w2,w3,act_fn}, resid_add_1, resid_add_2
The final norm and lm_head are never quantized. q/k/v/o/w1/w3 take no input
quantizer (their input is the quantized output of the op before); w2 keeps
one and gets per-channel weights with a 16-bit output; o_proj output, norm
I/O, softmax I/O and the residual adds run at 16 bits in the strict policy,
which relax_16bit turns off for serving; qk_bmm.input2 / pv_bmm.input2 are the
int8 KV-cache quantizers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.quant.quantizer import QuantConfig


@dataclasses.dataclass(frozen=True)
class SiteQuant:
    input: Optional[QuantConfig] = None
    input2: Optional[QuantConfig] = None
    weight: Optional[QuantConfig] = None
    output: Optional[QuantConfig] = None

    def roles(self):
        for r in ("input", "input2", "weight", "output"):
            if getattr(self, r) is not None:
                yield r, getattr(self, r)


QPolicy = dict  # site -> SiteQuant


def default_policy(config: ModelConfig,
                   weight_qcfg: QuantConfig = QuantConfig(bitwidth=8),
                   act_qcfg: QuantConfig = QuantConfig(bitwidth=8),
                   use_8bit_softmax_input: bool = False,
                   use_8bit_softmax_output: bool = False,
                   use_16bit_output_for_mlp: bool = False) -> QPolicy:
    """The default mixed-precision W8A8/W4A8 policy as one table."""
    a8 = act_qcfg
    # ">16 bits" disables a quantizer; keep the 16-bit exception slots disabled too
    # when the caller asks for a no-quant policy (bitwidth 32 acts/weights)
    a16 = act_qcfg if act_qcfg.bitwidth > 16 else act_qcfg.replace(bitwidth=16)
    w = weight_qcfg
    w_pc = weight_qcfg.replace(is_per_channel=True)
    # norm "weights" are quantized with a 16-bit per-tensor asymmetric quantizer
    norm_w16 = (weight_qcfg if weight_qcfg.bitwidth > 16
                else QuantConfig(bitwidth=16, is_symmetric=False, is_per_channel=False))

    qk_out = a8 if use_8bit_softmax_input else a16
    pv_in = a8 if use_8bit_softmax_output else a16
    mlp_out = a16 if use_16bit_output_for_mlp else a8

    policy = {
        "input_layernorm": SiteQuant(input=a16, weight=norm_w16, output=a8),
        "self_attn.q_proj": SiteQuant(weight=w, output=a8),
        "self_attn.k_proj": SiteQuant(weight=w, output=a8),
        "self_attn.v_proj": SiteQuant(weight=w, output=a8),
        "self_attn.qk_bmm": SiteQuant(input=a8, input2=a8, output=qk_out),
        "self_attn.pv_bmm": SiteQuant(input=pv_in, input2=a8, output=a8),
        "self_attn.o_proj": SiteQuant(weight=w, output=a16),
        # the NPU datapath quantizes the residual stream at 16 bits on both
        # inputs and the output of each skip-connection add; relax_16bit
        # disables these for serving
        "resid_add_1": SiteQuant(input=a16, input2=a16, output=a16),
        "resid_add_2": SiteQuant(input=a16, input2=a16, output=a16),
        "mlp.w1": SiteQuant(weight=w, output=mlp_out),
        "mlp.w2": SiteQuant(input=a8, weight=w_pc, output=a16),
    }
    if not config.shared_attention_norm:
        policy["post_attention_layernorm"] = SiteQuant(input=a16, weight=norm_w16, output=a8)
    if config.num_linears_per_mlp == 3:
        policy["mlp.w3"] = SiteQuant(weight=w, output=mlp_out)
    if config.hidden_act == "silu":
        policy["mlp.act_fn"] = SiteQuant(input2=a8, output=a8)
    else:  # gelu variants: output-only
        policy["mlp.act_fn"] = SiteQuant(output=a8)
    return policy


def policy_to_dict(policy: QPolicy) -> dict:
    """The policy in default_qcfg.json's per-site schema: site -> role ->
    QuantConfig.to_dict() (every value a string)."""
    return {site: {role: cfg.to_dict() for role, cfg in sq.roles()}
            for site, sq in policy.items()}


def policy_from_dict(d: dict) -> QPolicy:
    return {site: SiteQuant(**{role: QuantConfig.from_dict(cfg) for role, cfg in roles.items()})
            for site, roles in d.items()}


def relax_16bit(policy: QPolicy) -> QPolicy:
    """Disable the 16-bit exception sites (norm I/O, o_proj/w2 outputs, softmax
    I/O, residual adds). On an NPU these sites must be quantized because the
    datapath is integer end to end; on a GPU the inter-op datapath is fp32, so
    the 16-bit fake-quant only simulates an NPU constraint. Keep the strict
    policy for fidelity gating; serve with the relaxed one."""
    out = {}
    for site, sq in policy.items():
        kw = {}
        for role, cfg in sq.roles():
            kw[role] = cfg.replace(bitwidth=32) if cfg.bitwidth == 16 else cfg
        out[site] = SiteQuant(**kw)
    return out


KV_CACHE_SITES = (("self_attn.qk_bmm", "input2"),   # K cache quantizer
                  ("self_attn.pv_bmm", "input2"))   # V cache quantizer


def kv_bits_policy(policy: QPolicy, kv_bits: int) -> QPolicy:
    """Set the KV-cache quantizer bitwidth (the qk_bmm.input2 / pv_bmm.input2
    sites). kv_bits=4 makes the engine keep a nibble-packed int4 cache
    (EngineConfig.kv_bits=4; runtime/engine.py)."""
    if kv_bits == 8:
        return policy
    if kv_bits != 4:
        raise ValueError(f"kv_bits must be 4 or 8, got {kv_bits}")
    out = dict(policy)
    for site, role in KV_CACHE_SITES:
        sq = out[site]
        cfg = getattr(sq, role)
        out[site] = dataclasses.replace(
            sq, **{role: cfg.replace(bitwidth=kv_bits)})
    return out


def policy_kv_bits(policy: QPolicy) -> int:
    """The KV-cache bitwidth a policy encodes (engine paths key off this)."""
    cfg = policy["self_attn.qk_bmm"].input2
    cfg2 = policy["self_attn.pv_bmm"].input2
    if cfg.bitwidth != cfg2.bitwidth:
        raise ValueError("K and V cache bitwidths must match")
    return cfg.bitwidth


def static_range_sites(policy: QPolicy):
    """(site, role) pairs that need static activation scale/offset state —
    every activation quantizer that is enabled and not dynamic."""
    for site, sq in policy.items():
        for role, cfg in sq.roles():
            if role == "weight":
                continue
            if cfg.enabled and not cfg.is_dynamic:
                yield site, role, cfg


# Projection param keys carrying weight-only quantizers (the decoder Linears;
# norms and the lm_head stay fp unless a quantized head is asked for).
WEIGHT_ONLY_PROJ_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj", "w1", "w2", "w3")

_WEIGHT_ONLY_SITES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                      "self_attn.o_proj", "mlp.w1", "mlp.w2", "mlp.w3")


def weight_only_policy(config: ModelConfig, wcfg: QuantConfig,
                       head_bits: int = 16) -> QPolicy:
    """W4A16 / W8A16 placement: a weight quantizer on every projection and no
    activation quantizer anywhere. head_bits 8 / 4 adds the quantized lm_head
    (per-channel symmetric weights × dynamic per-token A8, engine.pack_head)."""
    sites = [s for s in _WEIGHT_ONLY_SITES
             if config.num_linears_per_mlp == 3 or not s.endswith("w3")]
    policy = {s: SiteQuant(weight=wcfg) for s in sites}
    if head_bits in (4, 8):
        policy["lm_head"] = SiteQuant(
            weight=QuantConfig(bitwidth=head_bits, is_symmetric=True, is_per_channel=True),
            input=QuantConfig(bitwidth=8, is_symmetric=True, is_dynamic=True))
    return policy
