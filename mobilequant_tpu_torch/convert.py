"""Packed models carried across from the JAX package, or made synthetically
(an HF checkpoint is read by models/convert.py).

from_jax_packed        the JAX engine's pack() output (as a tree of numpy
                       arrays) -> the port's packed dict, canonical keys only
from_jax_params        a JAX tree of numpy leaves -> the port's, the same keys
                       and shapes: the FP parameter tree (models/model), or
                       the wonly.pack_weight_only output (skeleton, packs,
                       head_q)
from_jax_qstate        a JAX quant state (the let / lwc / ranges trees of
                       quant/train.init_qstate, numpy leaves) -> the port's,
                       fp32 tensors; qstate_to_numpy carries one back
build_synthetic_packed a full-width W4A8 or W8A8 packed model with seeded
                       random weights and plausible static ranges, made on the
                       target device (real checkpoints are not in the
                       repository)
build_synthetic_wonly  a full-width weight-only (W4A16 / W8A16) packed model:
                       seeded FP params on the device, then pack_weight_only
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.ops.qops import pack_nibbles
from mobilequant_tpu_torch.quant.policy import (
    default_policy, kv_bits_policy, static_range_sites, weight_only_policy)
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import wonly as W

# TPU-layout packs of the JAX whole-layer kernels; the port reads the
# canonical qkv_proj / o_proj packs instead
_TPU_ONLY_KEYS = ("qkvp", "op", "qkv_seg", "rvec")


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":      # numpy's bf16 (ml_dtypes) has no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(a).to(device)


def from_jax_params(tree: dict, device="cuda") -> dict:
    """A JAX tree of numpy leaves (the FP parameter tree, or the weight-only
    pack {"skeleton", "packs"[, "head_q"]}) -> the port's on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def from_jax_qstate(tree: dict, device="cuda") -> dict:
    """A JAX quant state {"let", "lwc", "ranges"} (any subset; None entries
    dropped) of numpy leaves -> the port's, fp32 tensors on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax_qstate(v, device) for k, v in tree.items() if v is not None}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def qstate_to_numpy(tree: dict) -> dict:
    """The port's quant state (or any tree of tensors) -> fp32 numpy leaves,
    the JAX package's layout."""
    if isinstance(tree, dict):
        return {k: qstate_to_numpy(v) for k, v in tree.items()}
    return tree.detach().to(torch.float32).cpu().numpy()


def from_jax_packed(tree: dict, device="cuda") -> dict:
    """The JAX engine's packed dict, with numpy leaves, -> the port's packed
    dict on `device` (ranges stay on the host as fp32 numpy)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items() if k not in _TPU_ONLY_KEYS}
        return _tensor(v, device)
    out = {k: conv(v) for k, v in tree.items()
           if k not in _TPU_ONLY_KEYS and k != "ranges"}
    out["ranges"] = E.host_ranges(tree["ranges"])
    return out


def build_synthetic_packed(model_name: str = "tinyllama-1.1b", w_bits: int = 4,
                           head_bits: int = 4, max_seq_len: int = 1024,
                           seed: int = 0, device="cuda", kv_bits: int = 8):
    """-> (packed, config, policy, ecfg): a W4A8 (w_bits 4) or W8A8 (w_bits
    8) packed model at the named model's full width with random weights from
    `seed`. W4 weights are unsigned nibbles with zero-point 8 and per-channel
    scales 1/(4.6·√K); W8 weights are the JAX package's per-tensor asymmetric
    packs (qops.pack_weight): uint8 values stored as int8 − 128, one scale
    1/(74·√K) and a zero-point drawn from 112..143 per projection and layer,
    stored shifted (zp − 128, so the o_w·rowsum term is exercised), per-tensor
    (L,) for o / w2 and per column (L, 1, N) for the fused qkv / w13 packs, as
    engine.pack lays them out. Either way every projection keeps O(1)
    outputs. Static ranges span ±4 at each site's bitwidth; the head is a
    seeded N(0, 0.02²) matrix, or for a tied model (Gemma-2B, Qwen2-1.5B)
    the embedding's transpose, through pack_head (head_bits 4 or 8; the
    vocabulary padded to a multiple of 4096 as the JAX pack pads it:
    151,936 -> 155,648), or the fp head (16; a tied model reads the
    embedding). Any registry model the engine serves (the Phi family and MoE
    configurations are refused) builds at its full width: on the card a
    Llama-3-8B W4 pack is ~6 GB. Norm weights are 1 and every bias 0, except that a LayerNorm
    model (StableLM) gets norm weights 1 + N(0, 0.05²) and biases N(0,
    0.02²) (every layer's two norms and the final norm) and a model with a
    q/k/v bias one of N(0, 0.1²), drawn after the weights from a second
    generator (seed + 1), so that the other models' packs keep their bits.
    The policy is the strict default policy of the weight width (W4:
    per-channel symmetric; W8: per-tensor asymmetric, the JAX bench's W8
    policy; serve with relax_16bit), with the 4-bit KV-cache sites for
    kv_bits=4 (kv_bits_policy; their ranges then span the 4-bit bound, qmax
    15)."""
    if w_bits not in (4, 8):
        raise NotImplementedError("the port's synthetic builder makes W4 and W8 packs")
    cfg = get_config(model_name)
    E._check_config(cfg)
    wcfg = (QuantConfig(bitwidth=4, is_per_channel=True, is_symmetric=True) if w_bits == 4
            else QuantConfig(bitwidth=8, is_per_channel=False, is_symmetric=False))
    policy = kv_bits_policy(default_policy(cfg, wcfg, QuantConfig(bitwidth=8)), kv_bits)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=max_seq_len, kv_bits=kv_bits,
                          head_bits=head_bits)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def proj(din, dout):
        if w_bits == 4:
            q = torch.randint(0, 16, (L, din, dout), generator=gen, device=dev,
                              dtype=torch.int8)
            return {"wq": pack_nibbles(q),
                    "scale": torch.full((L, 1, dout), 1.0 / (4.6 * math.sqrt(din)),
                                        device=dev),
                    "offset": torch.full((L, 1, dout), 8.0, device=dev),
                    "colsum": q.to(torch.float32).sum(1),
                    "bias": torch.zeros((L, dout), device=dev)}
        q = torch.randint(-128, 128, (L, din, dout), generator=gen, device=dev,
                          dtype=torch.int8)
        zp = torch.randint(112, 144, (L,), generator=gen, device=dev).to(torch.float32)
        return {"wq": q,
                "scale": torch.full((L,), 1.0 / (74.0 * math.sqrt(din)), device=dev),
                "offset": zp - 128.0,
                "colsum": q.to(torch.float32).sum(1),
                "bias": torch.zeros((L, dout), device=dev)}

    def cat(ps):
        # the fused packs carry per-tensor scales per column (engine.pack's fuse)
        def chan(p, k):
            v = p[k]
            return v[:, None, None].expand(L, 1, p["wq"].shape[-1]) if v.dim() == 1 else v
        return {k: torch.cat([chan(p, k) for p in ps], -1).contiguous() for k in ps[0]}

    ranges = {}
    for site, role, qc in static_range_sites(policy):
        qmax = 2 ** qc.bitwidth - 1
        ranges.setdefault(site, {})[role] = {
            "scale": np.full((L,), 8.0 / qmax, np.float32),
            "offset": np.full((L,), float(qmax // 2), np.float32)}

    def fq_vec(sites, widths):
        sc = [torch.full((L, 1, w), float(ranges[s]["output"]["scale"][0]), device=dev)
              for s, w in zip(sites, widths)]
        of = [torch.full((L, 1, w), float(ranges[s]["output"]["offset"][0]), device=dev)
              for s, w in zip(sites, widths)]
        return torch.cat(sc, -1), torch.cat(of, -1)

    qkv = cat([proj(D, cfg.q_dim), proj(D, cfg.kv_dim), proj(D, cfg.kv_dim)])
    qkv["out_scale"], qkv["out_offset"] = fq_vec(
        ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"],
        [cfg.q_dim, cfg.kv_dim, cfg.kv_dim])
    w13 = cat([proj(D, F), proj(D, F)])
    w13["out_scale"], w13["out_offset"] = fq_vec(["mlp.w1", "mlp.w3"], [F, F])
    ones = {"w": torch.ones((L, D), device=dev), "b": torch.zeros((L, D), device=dev)}
    packed = {
        "embed": torch.randn((cfg.vocab_size, D), generator=gen, device=dev) * 0.02,
        "layers": {"qkv_proj": qkv, "o_proj": proj(cfg.q_dim, D), "w13_proj": w13,
                   "w2": proj(F, D), "attn_norm": dict(ones),
                   "mlp_norm": {k: v.clone() for k, v in ones.items()}},
        "ranges": ranges,
        "norm": {"w": torch.ones((D,), device=dev), "b": torch.zeros((D,), device=dev)},
    }
    # a tied head is the embedding, as the JAX pack makes it; an untied one
    # is drawn after it (the draw order that keeps the untied packs' bits)
    head_w = (packed["embed"].T if cfg.tie_word_embeddings
              else torch.randn((D, cfg.vocab_size), generator=gen, device=dev) * 0.02)
    gen2 = torch.Generator(device=dev).manual_seed(seed + 1)
    if cfg.norm_class == "layernorm":
        for norm in (packed["layers"]["attn_norm"], packed["layers"]["mlp_norm"],
                     packed["norm"]):
            shape = norm["w"].shape
            norm["w"] = 1.0 + 0.05 * torch.randn(shape, generator=gen2, device=dev)
            norm["b"] = 0.02 * torch.randn(shape, generator=gen2, device=dev)
    if cfg.has_qkv_bias:
        qkv["bias"] = 0.1 * torch.randn(qkv["bias"].shape, generator=gen2, device=dev)
    if head_bits in (4, 8):
        packed["head_q"] = E.pack_head(head_w, QuantConfig(
            bitwidth=head_bits, is_symmetric=True, is_per_channel=True))
    elif not cfg.tie_word_embeddings:
        packed["lm_head"] = {"w": head_w}
    return packed, cfg, policy, ecfg


def build_synthetic_wonly(model_name: str = "tinyllama-1.1b", w_bits: int = 4,
                          group_size: int = 128, head_bits: int = 16,
                          act_dtype=torch.bfloat16, max_seq_len: int = 1024,
                          seed: int = 0, device="cuda"):
    """-> (packed, config, policy, ecfg): the named model at full width with
    FP params drawn from `seed` on `device` (models/model.init_params:
    N(0, 0.02²) weights), packed weight-only (runtime/wonly.pack_weight_only)
    with the auto_gptq layout (per-channel asymmetric, grouped by group_size,
    -1: not grouped) at w_bits, and the fp head (head_bits 16) or the W8 / W4
    quantized head. ecfg serves it in weight-only mode (act_bits 16) with
    activations and KV cache in act_dtype."""
    cfg = get_config(model_name)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen, device=dev)
    wcfg = W.default_weight_cfg(w_bits, group_size)
    packed = W.pack_weight_only(params, cfg, wcfg, act_dtype=act_dtype, head_bits=head_bits)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=max_seq_len, head_bits=head_bits,
                          act_bits=16, act_dtype=act_dtype)
    return packed, cfg, weight_only_policy(cfg, wcfg, head_bits), ecfg
