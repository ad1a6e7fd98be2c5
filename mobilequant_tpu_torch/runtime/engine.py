"""Integer inference engine (the port of mobilequant_tpu/runtime/engine.py,
main-path slice).

  pack()            finalized weights + learned ranges -> packed model (W4/W8
                    ints, scales, zero-point corrections, frozen ranges)
  init_kv_cache()   the KV cache: int8 (L, B, Hkv, S, hd), head-major, or
                    (kv_bits = 4) nibble-packed int4 (L, B, Hkv, hd, S/2)
  forward()         prefill (T > 1) and decode (T = 1) passes; T = 1 on a
                    StagedKVCache is a chunked-staging step
  decode_loop()     greedy / temperature decode: one forward a step, staged in
                    chunks at B > 8, on the int4 cache, and wherever no
                    whole-step kernel runs

Numerics follow the JAX engine op for op: every matmul is an exact integer
dot with affine corrections; enabled fake-quant sites run in fp32. Static
activation ranges are frozen at pack time and live on the host
(`packed["ranges"]`: site -> role -> {"scale", "offset"} fp32 numpy arrays of
length L); they reach the operators and kernels as Python floats, so no step
reads a scalar back from the card.

Kernel dispatch (runtime/kernel_config.py), in the JAX engine's order:
model_kernel runs a whole T=1 step at B <= 8 (every layer and the folded W4
or W8 head) in one launch; chunk_kernel a whole staged step at B = 16..128;
layer_kernel a whole layer at B=1, T=1; otail_kernel the o-proj, resid_add_1
and the MLP block at B·T <= stacked_bt_max; stacked_mlp_kernel the whole MLP
block at B·T <= stacked_bt_max (both where the JAX engine's stacked-kernel
predicate holds: ops/mlp_block.stacked_mlp_supported); the alternate MLP
routes on W8 packs at any B·T: mlp_block_kernel the whole MLP block on the
layer's packs (ops/fused_mlp_block), mlp_kernel w13, the gate chain and the
raw w2 sums (ops/fused_mlp) with the w2 epilogue here; gate_kernel the
prefill qkv and w13+gate epilogue kernels (the qkv one on W4 packs over the
int8 cache only, as in the JAX engine), with w2fold_kernel the w13+gate+w2
kernel (ops/w13_gate_w2) where w13_gate_w2_supported holds; attn_kernel
the prefill attention kernel and, at T = 1, the decode attention kernel over
the int8 cache; kv4_attn_kernel the staged attention over the int4 cache;
w4_matmul every other W4 projection and the W4 head through the W4A8 kernel;
w8_matmul every other W8 projection of at most 32 rows through the W8A8
kernel. The whole-step, whole-layer, MLP-block and w13+gate kernels take W4
and W8 packs alike, each in the edition of the pack's bit width; a W8
projection or head that no flag routes takes the plain integer matmul, as in
the JAX engine (the qkv epilogue kernel's W8 edition is built and tested, but
no JAX route takes it, so no route here does). Routing reads static
predicates only (shapes, config, flags). With no flag set the same
function runs in PyTorch operators alone (the plain engine, the counterpart
of the JAX engine's XLA body). The whole-layer, whole-model and chunk kernels
take per-layer metas and qkv output fake-quant rows that are made on the
device once per policy and kept on the packed model (_kernel_prep).

The cache is updated in place: prefill, and a T = 1 step under attn_kernel,
write their rows into the layer slice before attention; a decode-light step
writes its rows once after the layer loop. Chunked staging (decode_loop): the
cache stays read-only for a chunk of steps, each step's rows are appended to
the staging buffers and the chunk's rows are written into the cache once at
its end.

The int4 cache (kv_bits = 4, the policy's 4-bit qk_bmm / pv_bmm input2 sites,
quant/policy.kv_bits_policy) keeps the JAX engine's nibble-packed, hd-major
layout (ops/qops.py). A prefill unpacks it once, runs the int8 program with
the K / V rows clipped at 15, and repacks it; a decode step reads it packed
(the kv4 kernel, or _kv4_decode_light_attention, its op-for-op plain twin)
and its rows are merged into it in place (qops.kv_flush_packed), once per
chunk when staged; decode_loop stages at every B on it.

forward and decode_loop take a KernelConfig or a legacy use_pallas value of
the JAX package (a bool or a mode string, KernelConfig.coerce).

Norms: RMSNorm (Llama, and Gemma's with its folded 1 + w) or LayerNorm with
a bias (StableLM): the plain path's fp32 norms, and every kernel in the
edition of the model's norm (norm_kind).

Out of this slice (NotImplementedError): MoE, parallel residual, a shared
attention norm, 2-linear MLPs (the Phi family), policies with the q/k/v or
w1/w3 output sites off, attn_kernel on the int4 cache (the JAX engine refuses
it too), and context/tensor parallelism. Weight-only mode (act_bits = 16) is
runtime/wonly.py.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.config import ModelConfig
from mobilequant_tpu_torch.ops import qops
from mobilequant_tpu_torch.ops.chunk_model import chunk_kernel_supported, fused_model_w4_chunk
from mobilequant_tpu_torch.ops.decode_attention import decode_attention
from mobilequant_tpu_torch.ops.fused_layer import (
    MAX_BATCH, fused_layer_w4, fused_model_w4, head_kernel_supported,
    layer_kernel_supported, norm_kind_of)
from mobilequant_tpu_torch.ops.kv4_attention import kv4_attn_supported, kv4_decode_attention
from mobilequant_tpu_torch.ops.fused_mlp import fused_mlp
from mobilequant_tpu_torch.ops.fused_mlp_block import fused_mlp_block
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4, stacked_mlp_supported
from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention
from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope, qkv_rope_supported
from mobilequant_tpu_torch.ops.staged_append import staged_append, staged_append_plain
from mobilequant_tpu_torch.ops.w13_gate import w13_gate, w13_gate_supported
from mobilequant_tpu_torch.ops.w13_gate_w2 import w13_gate_w2, w13_gate_w2_supported
from mobilequant_tpu_torch.ops.w4a8_matmul import (
    int_affine, layer_pack, w4a8_matmul, w4a8_matmul_stacked, weight_bits)
from mobilequant_tpu_torch.ops.w8a8_matmul import w8a8_matmul
from mobilequant_tpu_torch.quant.policy import QPolicy, policy_kv_bits
from mobilequant_tpu_torch.quant.quantizer import (
    QuantConfig, fake_quant, fake_quant_weight)
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig


class EngineKVCache(NamedTuple):
    """The KV cache: k/v (L, B, Hkv, S_max, hd) int8, shifted-uint8 domain, or
    on the int4 cache (L, B, Hkv, hd, S_max/2) nibble-packed (ops/qops.py)."""
    k: torch.Tensor
    v: torch.Tensor


class StagedKVCache(NamedTuple):
    """Chunked-staging decode cache (the JAX engine's StagedKVCache): the big
    k/v buffers stay read-only for a chunk of decode steps (they hold rows
    < the chunk-start position) while the chunk's rows collect in the staging
    buffers sk/sv (L, B, Hkv, cs, hd) (shifted 4-bit values on the int4
    cache); decode_loop writes them into k/v once per chunk. m: the number of
    staged columns so far, a host int (the step loop runs on the host, so no
    step reads it back from the card). kcs: Σ_hd k (L, B, Hkv, S) fp32, the
    stale K cache's column sums (in the shifted domain, sequence order, on the
    int4 cache), made once per chunk. pk/pv: the last step's pending rows
    (L, B, Hkv, 1, hd), which forward() returns and decode_loop appends at
    column m−1 at the top of the next step."""
    k: torch.Tensor
    v: torch.Tensor
    sk: torch.Tensor
    sv: torch.Tensor
    m: int
    kcs: Optional[torch.Tensor] = None
    pk: Optional[torch.Tensor] = None
    pv: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    model: ModelConfig
    max_seq_len: int = 1024
    kv_bits: int = 8            # 8: the int8 cache; 4: the nibble-packed
                                # int4 cache (two sequence positions a byte),
                                # which halves the KV bytes a decode step
                                # reads at serving batches; the policy carries
                                # the matching 4-bit qk / pv input2 sites
    head_bits: int = 16         # 16 = fp head; 8/4 = quantized head (pack_head)
    act_bits: int = 8           # 8: this integer engine; 16: weight-only mode
                                # (W4A16 / W8A16, runtime/wonly.py: fp
                                # activations and KV cache, packs dequantized
                                # on the fly)
    act_dtype: torch.dtype = torch.float32   # weight-only mode's activations
                                             # and KV cache
    use_pallas: object = True   # the Generator's decode kernels, in
                                # weight-only mode too: a KernelConfig, or a
                                # legacy value of the JAX package (True: the
                                # entry config; a mode string such as "mlp",
                                # "mlpblock", "mlpblockvpu", "otail"), as
                                # engine.decode_loop takes it


# ---------------------------------------------------------------------------
# Packing
# ---------------------------------------------------------------------------

_PROJ_SITES = {
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
    "w1": "mlp.w1", "w2": "mlp.w2", "w3": "mlp.w3",
}


def _t(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def host_ranges(ranges: dict) -> dict:
    """ranges tree (array leaves) -> {site: {role: {"scale", "offset"}}} of
    fp32 numpy (L,) arrays."""
    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32).reshape(-1)

    return {site: {role: {k: host(so[k]) for k in ("scale", "offset")}
                   for role, so in roles.items()}
            for site, roles in ranges.items()}


def _check_config(c: ModelConfig) -> None:
    if c.is_moe or c.parallel_residual or c.shared_attention_norm \
            or c.num_linears_per_mlp != 3 or c.hidden_act not in ("silu", "gelu_tanh"):
        raise NotImplementedError(
            "the port's engine serves dense gated (silu / gelu_tanh) decoders with "
            "sequential residuals and a norm before each block")


def _check_policy(policy: QPolicy) -> None:
    """The fused q|k|v and w1|w3 packs carry one per-channel output fake-quant
    per projection; the port applies it only in that fused form."""
    sites = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "mlp.w1", "mlp.w3")
    if policy_kv_bits(policy) not in (4, 8):
        raise NotImplementedError("the port serves int8 and int4 KV caches")
    if not all(_on(policy[s].output) for s in sites):
        raise NotImplementedError("the port needs the q/k/v and w1/w3 output "
                                  "fake-quant sites on")


@torch.no_grad()
def pack(params: dict, ranges: dict, config: ModelConfig, policy: QPolicy,
         ecfg: Optional[EngineConfig] = None, device="cuda", smooth_last=None) -> dict:
    """Finalized params (numpy or torch, layer-stacked) + learned ranges ->
    the packed model on `device`, bit-identical to the JAX engine's pack on
    its canonical keys (qkv_proj / o_proj / w13_proj / w2 / norms / head_q).

    smooth_last: an optional (D,) equalization vector for the quantized head
    (calibrate.smooth_last_scales): the packed final norm's weight and bias
    are divided by it and the head's input rows multiplied by it before the
    per-channel quantization, which keeps the FP outputs; it needs head_bits
    4 or 8 (an fp head may be the embedding table, which cannot be
    rescaled)."""
    ecfg = ecfg or EngineConfig(model=config)
    c = config
    _check_config(c)
    if smooth_last is not None and ecfg.head_bits not in (4, 8):
        raise ValueError("smooth_last requires a quantized head (head_bits 4 or 8)")
    dev = torch.device(device)
    rr = host_ranges(ranges)
    L = c.num_layers

    def pack_proj(pkey, site):
        wcfg = policy[site].weight
        entry = params["layers"][pkey]
        w = _t(entry["w"], dev)
        per = [qops.pack_weight(w[i], wcfg) for i in range(L)]
        out = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        out["bias"] = _t(entry["b"], dev).to(torch.float32)
        return out

    def fuse(entries):
        def chan(e, key):
            v = e[key]
            if v.dim() == 1:                 # per-tensor (L,) -> (L, 1, N)
                return v[:, None, None].expand(L, 1, e["wq"].shape[-1])
            return v
        return {
            "wq": torch.cat([e["wq"] for e in entries], -1),
            "scale": torch.cat([chan(e, "scale") for e in entries], -1),
            "offset": torch.cat([chan(e, "offset") for e in entries], -1),
            "colsum": torch.cat([e["colsum"] for e in entries], -1),
            "bias": torch.cat([e["bias"] for e in entries], -1),
        }

    def fq_vec(sites, widths):
        scs, ofs = [], []
        for site, w in zip(sites, widths):
            r = rr[site]["output"]
            scs.append(torch.from_numpy(r["scale"]).to(dev)[:, None, None].expand(L, 1, w))
            ofs.append(torch.from_numpy(r["offset"]).to(dev)[:, None, None].expand(L, 1, w))
        return torch.cat(scs, -1).contiguous(), torch.cat(ofs, -1).contiguous()

    layers = {k: pack_proj(k, s) for k, s in _PROJ_SITES.items()}
    widths = [layers[k]["wq"].shape[-1] for k in ("q_proj", "k_proj", "v_proj")]
    layers["qkv_proj"] = fuse([layers.pop("q_proj"), layers.pop("k_proj"),
                               layers.pop("v_proj")])
    layers["qkv_proj"]["out_scale"], layers["qkv_proj"]["out_offset"] = fq_vec(
        ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"], widths)
    widths = [layers["w1"]["wq"].shape[-1], layers["w3"]["wq"].shape[-1]]
    layers["w13_proj"] = fuse([layers.pop("w1"), layers.pop("w3")])
    layers["w13_proj"]["out_scale"], layers["w13_proj"]["out_offset"] = fq_vec(
        ["mlp.w1", "mlp.w3"], widths)

    def bake_norm(nkey, site):
        entry = params["layers"][nkey]
        ncfg = policy[site].weight
        w = _t(entry["w"], dev)
        if ncfg is not None and ncfg.enabled:
            w = torch.stack([fake_quant_weight(w[i][None, :], ncfg)[0] for i in range(L)])
        return {"w": w.to(torch.float32), "b": _t(entry["b"], dev).to(torch.float32)}

    layers["attn_norm"] = bake_norm("attn_norm", "input_layernorm")
    layers["mlp_norm"] = bake_norm("mlp_norm", "post_attention_layernorm")

    norm_w = _t(params["norm"]["w"], dev).to(torch.float32)
    norm_b = _t(params["norm"]["b"], dev).to(torch.float32)
    if smooth_last is not None:
        s_last = _t(smooth_last, dev).to(torch.float32)
        norm_w, norm_b = norm_w / s_last, norm_b / s_last
    packed = {
        "embed": _t(params["embed"]["w"], dev).to(torch.float32),
        "layers": layers,
        "ranges": rr,
        "norm": {"w": norm_w, "b": norm_b},
    }
    if ecfg.head_bits in (4, 8):
        head_w = (_t(params["embed"]["w"], dev).T if c.tie_word_embeddings
                  else _t(params["lm_head"]["w"], dev))
        if smooth_last is not None:
            head_w = head_w * s_last[:, None]
        packed["head_q"] = pack_head(head_w, QuantConfig(
            bitwidth=ecfg.head_bits, is_symmetric=True, is_per_channel=True))
    elif not c.tie_word_embeddings:
        packed["lm_head"] = {"w": _t(params["lm_head"]["w"], dev).to(torch.float32)}
    return packed


def pack_head(head_w: torch.Tensor, hcfg: QuantConfig) -> dict:
    """Per-channel symmetric W8/W4 (D, vocab) head, vocab padded to a multiple
    of 4096 (padded columns have scale 0, so their logits are 0 and sliced
    away)."""
    hq = qops.pack_weight(head_w, hcfg)
    V = head_w.shape[1]
    pad = (-V) % 4096
    if pad:
        F_ = torch.nn.functional
        hq = {"wq": F_.pad(hq["wq"], (0, pad)),
              "scale": F_.pad(hq["scale"].reshape(1, -1), (0, pad)),
              "offset": F_.pad(hq["offset"].reshape(1, -1), (0, pad)),
              "colsum": F_.pad(hq["colsum"], (0, pad))}
    return hq


def init_kv_cache(ecfg: EngineConfig, batch_size: int, device="cuda") -> EngineKVCache:
    c = ecfg.model
    if ecfg.kv_bits == 4:
        # nibble-packed along the sequence axis, hd-major (ops/qops.py)
        if ecfg.max_seq_len % 2:
            raise ValueError("the int4 cache needs an even max_seq_len")
        shape = (c.num_layers, batch_size, c.num_kv_heads, c.head_dim_, ecfg.max_seq_len // 2)
        return EngineKVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                             v=torch.zeros(shape, dtype=torch.int8, device=device))
    if ecfg.kv_bits != 8:
        raise ValueError(f"kv_bits must be 4 or 8, got {ecfg.kv_bits}")
    shape = (c.num_layers, batch_size, c.num_kv_heads, ecfg.max_seq_len, c.head_dim_)
    return EngineKVCache(k=torch.full(shape, -128, dtype=torch.int8, device=device),
                         v=torch.full(shape, -128, dtype=torch.int8, device=device))


def packed_to(packed: dict, device) -> dict:
    """The packed model with every tensor on `device` (host ranges unchanged)."""
    def mv(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, dict):
            return {k: mv(x) for k, x in v.items()}
        return v
    return {k: (v if k == "ranges" else mv(v)) for k, v in packed.items()}


# ---------------------------------------------------------------------------
# Per-layer ranges and kernel metas
# ---------------------------------------------------------------------------

def layer_ranges(rr: dict, l: int) -> dict:
    """Layer l's ranges as Python floats: site -> role -> {scale, offset}."""
    return {site: {role: {"scale": float(so["scale"][l]), "offset": float(so["offset"][l])}
                   for role, so in roles.items()}
            for site, roles in rr.items()}


def _qmax(cfg) -> float:
    """Kernel-meta encoding of a fake-quant site: its clip bound when enabled,
    0 when disabled."""
    return float(cfg.qmax) if (cfg is not None and cfg.enabled) else 0.0


def _on(cfg) -> bool:
    return bool(cfg is not None and cfg.enabled)


def _site_cfg(policy, site, role):
    sq = policy.get(site)
    return getattr(sq, role, None) if sq is not None else None


def _attn_meta(lr, policy, c) -> list:
    """The 13-float attention meta of the JAX engine."""
    qk, pv = lr["self_attn.qk_bmm"], lr["self_attn.pv_bmm"]
    qk_q = _qmax(policy["self_attn.qk_bmm"].output)
    pv_q = _qmax(policy["self_attn.pv_bmm"].input)
    return [qk["input"]["scale"], qk["input"]["offset"],
            qk["input2"]["scale"], qk["input2"]["offset"],
            pv["input2"]["scale"], pv["input2"]["offset"],
            qk["output"]["scale"] if qk_q > 0 else 1.0,
            qk["output"]["offset"] if qk_q > 0 else 0.0, qk_q,
            pv["input"]["scale"] if pv_q > 0 else 1.0,
            pv["input"]["offset"] if pv_q > 0 else 0.0, pv_q,
            float(np.float32(c.neg_inf))]


def _mlp_block_meta(lr, policy, c) -> list:
    """The 32-float MLP-block meta of the JAX engine (w13_gate reads 0..15)."""
    def qm(site, role):
        return _qmax(_site_cfg(policy, site, role))

    def rng(site, role):
        e = lr.get(site, {})
        return (e[role]["scale"], e[role]["offset"]) if role in e else (1.0, 0.0)

    ns = "post_attention_layernorm"
    return [lr[ns]["output"]["scale"], lr[ns]["output"]["offset"],
            *rng("mlp.w1", "output"), qm("mlp.w1", "output"),
            *rng("mlp.act_fn", "input2"), qm("mlp.act_fn", "input2"),
            *rng("mlp.act_fn", "output"), qm("mlp.act_fn", "output"),
            *rng("mlp.w3", "output"), qm("mlp.w3", "output"),
            lr["mlp.w2"]["input"]["scale"], lr["mlp.w2"]["input"]["offset"],
            *rng(ns, "input"), qm(ns, "input"),
            float(np.float32(c.norm_eps)),
            *rng("mlp.w2", "output"), qm("mlp.w2", "output"),
            *rng("resid_add_2", "input"), qm("resid_add_2", "input"),
            *rng("resid_add_2", "input2"), qm("resid_add_2", "input2"),
            *rng("resid_add_2", "output"), qm("resid_add_2", "output")]


def _otail_meta_ext(lr, policy) -> list:
    """The 14-float extension of _mlp_block_meta for the o-tail kernel (the
    JAX engine's): a8 encoding (pv_bmm output), o output fq, resid_add_1
    input / input2 / output fq."""
    def qm(site, role):
        return _qmax(_site_cfg(policy, site, role))

    def rng(site, role):
        e = lr.get(site, {})
        return (e[role]["scale"], e[role]["offset"]) if role in e else (1.0, 0.0)

    pv = lr["self_attn.pv_bmm"]["output"]
    return [pv["scale"], pv["offset"],
            *rng("self_attn.o_proj", "output"), qm("self_attn.o_proj", "output"),
            *rng("resid_add_1", "input"), qm("resid_add_1", "input"),
            *rng("resid_add_1", "input2"), qm("resid_add_1", "input2"),
            *rng("resid_add_1", "output"), qm("resid_add_1", "output")]


def _otail_site_on(policy) -> tuple:
    """Static enables of the o-tail kernel's optional fake-quant sites: (o_proj
    output, resid_add_1 input, input2, output)."""
    def on(site, role):
        return _on(_site_cfg(policy, site, role))
    return (on("self_attn.o_proj", "output"), on("resid_add_1", "input"),
            on("resid_add_1", "input2"), on("resid_add_1", "output"))


def _mlp_block_site_on(policy) -> tuple:
    """Static enables of the MLP block's optional fake-quant sites (JAX order)."""
    def on(site, role):
        return _on(_site_cfg(policy, site, role))
    return (on("post_attention_layernorm", "input"), on("mlp.w1", "output"),
            on("mlp.act_fn", "input2"), on("mlp.act_fn", "output"),
            on("mlp.w3", "output"), on("mlp.w2", "output"),
            on("resid_add_2", "input"), on("resid_add_2", "input2"),
            on("resid_add_2", "output"))


def _layer_meta(lr, policy, c) -> list:
    """The 65-float whole-layer meta of the JAX engine: the 33-entry attention
    section (ops/fused_layer.py), then _mlp_block_meta."""
    def qm(site, role):
        return _qmax(_site_cfg(policy, site, role))

    def rng(site, role):
        e = lr.get(site, {})
        return (e[role]["scale"], e[role]["offset"]) if role in e else (1.0, 0.0)

    qk, pv = lr["self_attn.qk_bmm"], lr["self_attn.pv_bmm"]
    ln = "input_layernorm"
    head = [*rng(ln, "input"), qm(ln, "input"), float(np.float32(c.norm_eps)),
            lr[ln]["output"]["scale"], lr[ln]["output"]["offset"],
            qk["input"]["scale"], qk["input"]["offset"],
            qk["input2"]["scale"], qk["input2"]["offset"],
            pv["input2"]["scale"], pv["input2"]["offset"],
            *rng("self_attn.qk_bmm", "output"), qm("self_attn.qk_bmm", "output"),
            *rng("self_attn.pv_bmm", "input"), qm("self_attn.pv_bmm", "input"),
            float(np.float32(c.neg_inf)),
            pv["output"]["scale"], pv["output"]["offset"],
            *rng("self_attn.o_proj", "output"), qm("self_attn.o_proj", "output")]
    for role in ("input", "input2", "output"):
        head += [*rng("resid_add_1", role), qm("resid_add_1", role)]
    return head + _mlp_block_meta(lr, policy, c)


def _kernel_prep(packed, policy, c) -> dict:
    """Device operands of the whole-layer / whole-model kernels, made once per
    policy and kept on the packed model (packed["kernel_prep"]): meta (L, 65)
    and ofq (L, 4, Nq)."""
    key = tuple(sorted(policy.items()))
    preps = packed.setdefault("kernel_prep", {})
    if key not in preps:
        rr, L = packed["ranges"], c.num_layers
        metas = [_layer_meta(layer_ranges(rr, l), policy, c) for l in range(L)]
        preps[key] = {"meta": torch.tensor(metas, dtype=torch.float32,
                                           device=packed["embed"].device),
                      "ofq": _qkv_ofq_rows(packed, policy)}
    return preps[key]


def _qkv_ofq_rows(packed, policy) -> torch.Tensor:
    """(L, 4, Nq) [scale, offset, clip max, enabled] of the qkv output
    fake-quant per column (the pack's fused per-channel vectors)."""
    qkv = packed["layers"]["qkv_proj"]
    L, _, Nq = qkv["wq"].shape
    cm = torch.full((L, 1, Nq), float(policy["self_attn.q_proj"].output.qmax),
                    device=qkv["wq"].device)
    return torch.cat([qkv["out_scale"].reshape(L, 1, Nq),
                      qkv["out_offset"].reshape(L, 1, Nq), cm, torch.ones_like(cm)],
                     1).contiguous()


def _qkv_outq_rows(rr, c, L, dev) -> torch.Tensor:
    """(L, 3, Nq) [segment quant scale, offset, rope mask]: q columns take the
    qk_bmm input encoding, k the qk_bmm input2 (K cache), v the pv_bmm input2
    (V cache); v columns do not rope."""
    qd, kvd = c.q_dim, c.kv_dim
    qk, pv = rr["self_attn.qk_bmm"], rr["self_attn.pv_bmm"]
    rows = np.zeros((L, 3, qd + 2 * kvd), np.float32)
    for i, key in enumerate(("scale", "offset")):
        rows[:, i, :qd] = qk["input"][key][:, None]
        rows[:, i, qd:qd + kvd] = qk["input2"][key][:, None]
        rows[:, i, qd + kvd:] = pv["input2"][key][:, None]
    rows[:, 2, :qd + kvd] = 1.0
    return torch.from_numpy(rows).to(dev)


def _rope_cs_rows(cos, sin, hd: int, rot: int) -> torch.Tensor:
    """(M, 2·hd) per-row [cos | sign-baked sin] for the qkv epilogue kernel
    (cos = 1 / sin = 0 past the rotary dims)."""
    rd = cos.shape[-1]
    c1 = cos.reshape(-1, rd)[:, :rot].to(torch.float32)
    s1 = sin.reshape(-1, rd)[:, :rot].to(torch.float32)
    Mr = c1.shape[0]
    sgn = torch.where(torch.arange(rot, device=cos.device) < rot // 2, -1.0, 1.0)
    s1 = s1 * sgn[None, :]
    if rot < hd:
        c1 = torch.cat([c1, torch.ones((Mr, hd - rot), device=cos.device)], 1)
        s1 = torch.cat([s1, torch.zeros((Mr, hd - rot), device=cos.device)], 1)
    return torch.cat([c1, s1], 1).contiguous()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _fq16(x, r, cfg):
    if cfg is None or not cfg.enabled:
        return x
    return fake_quant(x, r["scale"], r["offset"], cfg)


def _fq_site(x, lr, policy, site, role):
    cfg = _site_cfg(policy, site, role)
    if cfg is None or not cfg.enabled:
        return x
    return fake_quant(x, lr[site][role]["scale"], lr[site][role]["offset"], cfg)


def _resid_add(a, b, lr, policy, site):
    a = _fq_site(a, lr, policy, site, "input")
    b = _fq_site(b, lr, policy, site, "input2")
    return _fq_site(a + b, lr, policy, site, "output")


def _is_w4(pack: dict, K: int) -> bool:
    return pack["wq"].shape[-2] * 2 == K


# rows up to which kc.w8_matmul sends a W8 projection to w8a8_matmul (the
# kernel takes any M): the JAX engine's gate (mobilequant_tpu/runtime/
# engine.py _int_linear)
W8_MATMUL_ROWS = 32


def _int_linear(x_q, r, pack, l, kc: KernelConfig):
    """Integer matmul of layer l of a stacked pack, in the JAX engine's
    order: a W4 pack through the W4A8 kernel under kc.w4_matmul, a W8 pack of
    at most 32 rows through the W8A8 kernel under kc.w8_matmul, anything else
    (a W8 pack under w4_matmul among them) through the plain
    qops.int_linear."""
    K = x_q.shape[-1]
    lead = x_q.shape[:-1]
    if kc.w4_matmul and _is_w4(pack, K):
        out = w4a8_matmul_stacked(x_q.reshape(-1, K), pack, r["scale"], r["offset"], l)
        return out.reshape(*lead, out.shape[-1])
    if kc.w8_matmul and pack["wq"].shape[-2] == K and math.prod(lead) <= W8_MATMUL_ROWS:
        out = w8a8_matmul(x_q.reshape(-1, K), pack, r["scale"], r["offset"], l)
        return out.reshape(*lead, out.shape[-1])
    p = layer_pack(pack, l)
    return qops.int_linear(x_q, r["scale"], r["offset"], p, p.get("bias"))


def _rms(x, eps):
    xf = x.to(torch.float32)
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)


def _layer_norm(x, eps):
    """The JAX engine's LayerNorm in fp32: the mean, then the variance of
    x − mean, then rsqrt(var + eps)."""
    xf = x.to(torch.float32)
    d = xf - xf.mean(-1, keepdim=True)
    return d * torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)


def _norm_fn(c: ModelConfig):
    return _layer_norm if c.norm_class == "layernorm" else _rms


def _norm(x, nw, l, site, lr, policy, c):
    x = _fq16(x, lr[site].get("input"), policy[site].input)
    return _norm_fn(c)(x, c.norm_eps) * nw["w"][l] + nw["b"][l]


def _decode_light_attention(q8, k8_new, v8_new, k_cache, v_cache, lr, policy,
                            cache_position, c, B, Hkv, G, hd, ks=None, vs=None,
                            staged_len=None, k_colsum=None):
    """Scores over the stale cache (masked to positions < cache_position) plus
    the self term of the step's own K/V rows; the cache is not rewritten
    here. q8 (B,1,Hq,hd); k8_new/v8_new (B,Hkv,1,hd); caches (B,Hkv,S,hd).

    ks/vs/staged_len: chunked staging, this layer's (B,Hkv,cs,hd) staged
    columns join as a third part masked to col < staged_len (cache_position
    is then the chunk-start position); k_colsum: the chunk-constant Σ_hd of
    k_cache (B,Hkv,S). The softmax runs partwise as the JAX engine writes
    it: one shared max, per-part exp, the denominator summed
    (cache + self) + staged."""
    qk, pv = lr["self_attn.qk_bmm"], lr["self_attn.pv_bmm"]
    S = k_cache.shape[2]
    qg = q8.reshape(B, 1, Hkv, G, hd).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G, hd)
    scores_c = qops.int_matmul_qk(qg, k_cache, qk["input"]["scale"], qk["input"]["offset"],
                                  qk["input2"]["scale"], qk["input2"]["offset"],
                                  k_colsum=k_colsum)
    oqv = qops.f32(np.float32(qk["input"]["offset"]) - np.float32(128.0))
    okv = qops.f32(np.float32(qk["input2"]["offset"]) - np.float32(128.0))
    s_self = ((qg.to(torch.float32) - oqv) * (k8_new.to(torch.float32) - okv)).sum(
        -1, keepdim=True) * qops.f32(np.float32(qk["input"]["scale"])
                                     * np.float32(qk["input2"]["scale"]))
    qk_out = policy["self_attn.qk_bmm"].output
    scores_c = _fq16(scores_c, qk.get("output"), qk_out)
    s_self = _fq16(s_self, qk.get("output"), qk_out)
    inv = 1.0 / math.sqrt(hd)
    col = torch.arange(S, device=q8.device)[None, None, None, :]
    zero = torch.zeros((), device=q8.device)
    maskc = torch.where(col < cache_position[:, None, None, None], zero, c.neg_inf)
    lg_c = scores_c * inv + maskc
    lg_self = s_self * inv
    m = torch.maximum(lg_c.amax(-1), lg_self[..., 0])
    lg_st = None
    if ks is not None:
        n_st = ks.shape[2]
        scores_st = qops.int_matmul_qk(qg, ks, qk["input"]["scale"], qk["input"]["offset"],
                                       qk["input2"]["scale"], qk["input2"]["offset"])
        scores_st = _fq16(scores_st, qk.get("output"), qk_out)
        col_st = torch.arange(n_st, device=q8.device)[None, None, None, :]
        mask_st = torch.where(col_st < staged_len, zero, c.neg_inf)
        lg_st = scores_st * inv + mask_st
        m = torch.maximum(m, lg_st.amax(-1))
    m = m[..., None]
    e_c = torch.exp(lg_c - m)
    e_self = torch.exp(lg_self - m)
    denom = e_c.sum(-1, keepdim=True) + e_self
    if lg_st is not None:
        e_st = torch.exp(lg_st - m)
        denom = denom + e_st.sum(-1, keepdim=True)
    pv_in = policy["self_attn.pv_bmm"].input
    p_c = _fq16(e_c / denom, pv.get("input"), pv_in)
    p_self = _fq16(e_self / denom, pv.get("input"), pv_in)
    attn = qops.int_matmul_pv(p_c, v_cache, pv["input2"]["scale"], pv["input2"]["offset"])
    if lg_st is not None:
        p_st = _fq16(e_st / denom, pv.get("input"), pv_in)
        attn = attn + qops.int_matmul_pv(p_st, vs, pv["input2"]["scale"],
                                         pv["input2"]["offset"])
    v_new_f = (v8_new.to(torch.float32) + 128.0 - pv["input2"]["offset"]) * pv["input2"]["scale"]
    attn = attn + p_self * v_new_f
    attn = attn.reshape(B, Hkv, G, 1, hd).permute(0, 3, 1, 2, 4)
    return attn.reshape(B, 1, Hkv * G * hd)


def _kv4_decode_light_attention(q8, k8_new, v8_new, kp, vp, lr, policy, cache_position, c,
                                B, Hkv, G, hd, ks=None, vs=None, staged_len=None,
                                k_colsum=None):
    """Decode-light attention over the packed int4 cache, the JAX engine's
    op-for-op twin of the kv4 kernel (pallas_kv4._kv4_attn_kernel): four score
    parts {cache lo, cache hi, staged, self}, one shared max, per-part exp, the
    denominator summed (lo + hi) + staged + self, and P·V in the raw 4-bit V
    domain. kp / vp: one layer (B, Hkv, hd, S/2) packed; k8_new / v8_new
    (B, Hkv, 1, hd) shifted rows; ks / vs (B, Hkv, cs, hd) shifted staged
    rows, staged_len of them valid; k_colsum (B, Hkv, S) shifted K column
    sums (qops.kv_colsums_packed), computed here when None. The nibbles are
    unpacked into PyTorch tensors here (the plain path)."""
    qk, pv = lr["self_attn.qk_bmm"], lr["self_attn.pv_bmm"]
    S2 = kp.shape[3]
    qi = q8.reshape(B, 1, Hkv, G, hd).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G, hd)
    qf = qi.to(torch.float32)
    qs = qf.sum(-1, keepdim=True)                                  # (B, Hkv, G, 1)
    sq, skk = qk["input"]["scale"], qk["input2"]["scale"]
    oqs = qops.f32(np.float32(qk["input"]["offset"]) - np.float32(128.0))
    ok = qops.f32(qk["input2"]["offset"])
    oks = qops.f32(np.float32(ok) - np.float32(128.0))
    sv_, ov = pv["input2"]["scale"], pv["input2"]["offset"]
    inv = qops.f32(1.0 / math.sqrt(hd))
    qk_out, pv_in = policy["self_attn.qk_bmm"].output, policy["self_attn.pv_bmm"].input
    sqk = qops.f32(np.float32(sq) * np.float32(skk))
    cf = sqk if _on(qk_out) else qops.f32(np.float32(sqk) * np.float32(inv))
    hdo = np.float32(hd) * np.float32(oqs)
    if k_colsum is None:
        k_colsum = qops.kv_colsums_packed(kp)
    dev = q8.device
    zero = torch.zeros((), device=dev)

    def part_raw(k4, ksum_sh):
        acc = qops.int_dot(qi, k4)                                 # (B, Hkv, G, S2)
        sc = (acc - ok * qs - oqs * (ksum_sh[:, :, None, :] + 128.0 * hd)
              + qops.f32(hdo * np.float32(ok))) * cf
        if _on(qk_out):
            sc = _fq16(sc, qk["output"], qk_out) * inv
        return sc

    col = torch.arange(S2, device=dev)[None, None, None, :]
    posb = cache_position.to(torch.int64)[:, None, None, None]
    lg_lo = part_raw(kp & 0x0F, k_colsum[..., :S2]) + torch.where(col < posb, zero, c.neg_inf)
    lg_hi = part_raw((kp >> 4) & 0x0F, k_colsum[..., S2:]) \
        + torch.where(S2 + col < posb, zero, c.neg_inf)
    lg_st = None
    if ks is not None:
        kss = qops.rowsum_i8(ks)[..., 0]                            # (B, Hkv, cs)
        acc_st = qops.int_dot(qi, ks.transpose(-1, -2))
        sc_st = (acc_st - oks * qs - oqs * kss[:, :, None, :]
                 + qops.f32(hdo * np.float32(oks))) * cf
        if _on(qk_out):
            sc_st = _fq16(sc_st, qk["output"], qk_out) * inv
        col2 = torch.arange(ks.shape[2], device=dev)[None, None, None, :]
        lg_st = sc_st + torch.where(col2 < staged_len, zero, c.neg_inf)
    kn = k8_new.to(torch.float32)                                  # (B, Hkv, 1, hd)
    s_self = ((qf - oqs) * (kn - oks)).sum(-1, keepdim=True) * sqk
    s_self = _fq16(s_self, qk.get("output"), qk_out)
    lg_self = s_self * inv                                         # (B, Hkv, G, 1)

    mx = torch.maximum(lg_lo.amax(-1, keepdim=True), lg_hi.amax(-1, keepdim=True))
    if lg_st is not None:
        mx = torch.maximum(mx, lg_st.amax(-1, keepdim=True))
    mx = torch.maximum(mx, lg_self)
    e_lo, e_hi, e_self = torch.exp(lg_lo - mx), torch.exp(lg_hi - mx), torch.exp(lg_self - mx)
    e_st = torch.exp(lg_st - mx) if lg_st is not None else None
    den = e_lo.sum(-1, keepdim=True) + e_hi.sum(-1, keepdim=True)
    if e_st is not None:
        den = den + e_st.sum(-1, keepdim=True)
    den = den + e_self
    v_lo = (vp & 0x0F).to(torch.float32).transpose(-1, -2)        # (B, Hkv, S2, hd)
    v_hi = ((vp >> 4) & 0x0F).to(torch.float32).transpose(-1, -2)
    vst = (vs & 0x0F).to(torch.float32) if vs is not None else None
    vn = (v8_new & 0x0F).to(torch.float32)                         # (B, Hkv, 1, hd)
    if _on(pv_in):
        p_lo = _fq16(e_lo / den, pv["input"], pv_in)
        p_hi = _fq16(e_hi / den, pv["input"], pv_in)
        p_self = _fq16(e_self / den, pv["input"], pv_in)
        psum = p_lo.sum(-1, keepdim=True) + p_hi.sum(-1, keepdim=True)
        A = torch.matmul(p_lo, v_lo) + torch.matmul(p_hi, v_hi)
        if e_st is not None:
            p_st = _fq16(e_st / den, pv["input"], pv_in)
            psum = psum + p_st.sum(-1, keepdim=True)
            A = A + torch.matmul(p_st, vst)
        psum = psum + p_self
        attn = (A + p_self * vn - ov * psum) * sv_
    else:
        A = torch.matmul(e_lo, v_lo) + torch.matmul(e_hi, v_hi)
        if e_st is not None:
            A = A + torch.matmul(e_st, vst)
        A = A + e_self * vn
        attn = (A / den - ov) * sv_
    attn = attn.reshape(B, Hkv, G, 1, hd).permute(0, 3, 1, 2, 4)
    return attn.reshape(B, 1, Hkv * G * hd)


def _layer_forward(packed, l, lr, x, cos, sin, mask, cache, cache_position,
                   c: ModelConfig, policy: QPolicy, kc: KernelConfig,
                   kv_valid_len, positions, prep, decode_light, st=None,
                   staged_len=None, k_colsum=None, kv_bits: int = 8):
    """One decoder layer on packed ints -> (hidden, new K/V rows or None).
    st = (sk, sv) of this layer, staged_len and k_colsum: a chunked-staging
    step (see _decode_light_attention). kv_bits 4: the K / V rows are 4-bit
    cache values, and a decode-light step reads the packed cache."""
    ly = packed["layers"]
    B, T, D = x.shape
    hd, Hq, Hkv = c.head_dim_, c.num_heads, c.num_kv_heads
    G = Hq // Hkv
    qd, kvd = Hq * hd, Hkv * hd
    qk, pv = lr["self_attn.qk_bmm"], lr["self_attn.pv_bmm"]

    def out_q8(y, site):
        r = lr[site]["output"]
        return qops.quantize_act(y, r["scale"], r["offset"]), r

    if decode_light and kc.layer_kernel and "layer" in prep:
        # the whole layer in one launch (B = 1, T = 1)
        out, kvn = fused_layer_w4(
            x.reshape(1, D), cache_position, prep["cs"], prep["layer"]["ofq"],
            ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"],
            ly["w13_proj"], ly["w2"], cache.k, cache.v, prep["layer"]["meta"], l,
            num_q_heads=Hq, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
            act_kind=c.hidden_act, norm_kind=norm_kind_of(c))
        return out.reshape(B, T, D), (kvn[:Hkv].reshape(1, Hkv, 1, hd),
                                      kvn[Hkv:].reshape(1, Hkv, 1, hd))

    # --- attention ---
    h = _norm(x, ly["attn_norm"], l, "input_layernorm", lr, policy, c)
    h8, hr = out_q8(h, "input_layernorm")
    qkvp = ly["qkv_proj"]
    if (kc.gate_kernel and T > 1 and kv_bits == 8 and _is_w4(qkvp, D)
            and qkv_rope_supported(qkvp["wq"].shape[-1], hd, c.rotary_dim,
                                   qkvp["wq"].shape[-2])):
        # (the epilogue kernel clips every row at 255: on the int4 cache the
        # K / V rows take the per-segment 15 of the plain path below; W4 packs
        # only, as in the JAX engine, which measured its W8 edition negative;
        # elsewhere the JAX gate's shapes fall back to the plain path, as there)
        # stacked W4 qkv matmul + output fq + RoPE + segment quantization
        q8kv = qkv_rope(h8.reshape(B * T, D), qkvp, prep["ofq"][l], prep["outq"][l],
                        prep["cs"], hr["scale"], hr["offset"], l, hd, c.rotary_dim)
        q8 = q8kv[:, :qd].reshape(B, T, Hq, hd)
        k8_new = q8kv[:, qd:qd + kvd].reshape(B, T, Hkv, hd).transpose(1, 2)
        v8_new = q8kv[:, qd + kvd:].reshape(B, T, Hkv, hd).transpose(1, 2)
    else:
        qkv = _int_linear(h8, hr, qkvp, l, kc)
        # one per-channel fq (segment-constant scales) == three per-tensor fqs
        qkv = fake_quant(qkv, qkvp["out_scale"][l][0], qkvp["out_offset"][l][0],
                         policy["self_attn.q_proj"].output)
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
        qk_cat = torch.cat([q.reshape(B, T, Hq, hd), k.reshape(B, T, Hkv, hd)], 2)
        qk_cat = M.apply_rope(qk_cat, cos, sin, c.rotary_dim)
        # the JAX engine's joint per-segment quantization, segment by segment;
        # K / V rows clip at the cache's bound (15 on the int4 cache)
        kv_max = 15.0 if kv_bits == 4 else 255.0
        q8 = qops.quantize_act(qk_cat[:, :, :Hq], qk["input"]["scale"], qk["input"]["offset"])
        k8_new = qops.quantize_act(qk_cat[:, :, Hq:], qk["input2"]["scale"],
                                   qk["input2"]["offset"], kv_max).transpose(1, 2)
        v8_new = qops.quantize_act(v.reshape(B, T, Hkv, hd), pv["input2"]["scale"],
                                   pv["input2"]["offset"], kv_max).transpose(1, 2)

    rows = None
    if decode_light:
        ks, vs = st if st is not None else (None, None)
        if kv_bits == 4 and "kv4" in prep:
            # the kv4 kernel over the layer-stacked packed cache
            p4 = prep["kv4"]
            att = kv4_decode_attention(
                q8.reshape(B * Hkv, G, hd), p4["kp"], p4["vp"], p4["kcs"], p4["sk"], p4["sv"],
                k8_new.reshape(B * Hkv, hd), v8_new.reshape(B * Hkv, hd),
                _attn_meta(lr, policy, c), cache_position, staged_len, l,
                qk_fq_on=_on(policy["self_attn.qk_bmm"].output),
                pv_fq_on=_on(policy["self_attn.pv_bmm"].input))
            attn = att.reshape(B, 1, qd)
        else:
            light = _kv4_decode_light_attention if kv_bits == 4 else _decode_light_attention
            attn = light(q8, k8_new, v8_new, cache.k[l], cache.v[l], lr, policy,
                         cache_position, c, B, Hkv, G, hd, ks=ks, vs=vs,
                         staged_len=staged_len, k_colsum=k_colsum)
        rows = (k8_new, v8_new)
    else:
        # prefill, or a T = 1 step under attn_kernel: write the rows into this
        # layer's cache slice, then attend over it
        k_all, v_all = cache.k[l], cache.v[l]
        bi = torch.arange(B, device=x.device)[:, None]
        si = cache_position[:, None].to(torch.long) + torch.arange(T, device=x.device)[None]
        k_all[bi, :, si] = k8_new.transpose(1, 2)
        v_all[bi, :, si] = v8_new.transpose(1, 2)
        S = k_all.shape[2]
        qk_on = _on(policy["self_attn.qk_bmm"].output)
        pv_on = _on(policy["self_attn.pv_bmm"].input)
        if kc.attn_kernel and T == 1:
            # the decode attention kernel over the rows < kv_valid_len
            valid = kv_valid_len if kv_valid_len is not None else positions[:, -1] + 1
            qg = q8.reshape(B, Hkv, G, hd)
            attn = decode_attention(qg, k_all, v_all, _attn_meta(lr, policy, c), valid)
            attn = attn.reshape(B, 1, qd)
        elif kc.attn_kernel:
            valid = kv_valid_len if kv_valid_len is not None else \
                torch.full((B,), S, dtype=torch.int32, device=x.device)
            qg = q8.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4)
            attn = prefill_attention(qg, k_all, v_all, _attn_meta(lr, policy, c),
                                     positions, valid, qk_fq=qk_on, pv_fq=pv_on)
            attn = attn.permute(0, 3, 1, 2, 4).reshape(B, T, qd)
        else:
            qg = q8.reshape(B, T, Hkv, G, hd).permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * T, hd)
            scores = qops.int_matmul_qk(qg, k_all, qk["input"]["scale"], qk["input"]["offset"],
                                        qk["input2"]["scale"], qk["input2"]["offset"])
            scores = _fq16(scores.reshape(B, Hkv, G, T, S), qk.get("output"),
                           policy["self_attn.qk_bmm"].output)
            scores = scores / math.sqrt(hd) + mask[:, :, None]
            probs = torch.softmax(scores, dim=-1)
            probs = _fq16(probs, pv.get("input"), policy["self_attn.pv_bmm"].input)
            attn = qops.int_matmul_pv(probs.reshape(B, Hkv, G * T, S), v_all,
                                      pv["input2"]["scale"], pv["input2"]["offset"])
            attn = attn.reshape(B, Hkv, G, T, hd).permute(0, 3, 1, 2, 4).reshape(B, T, qd)
    a8, ar = out_q8(attn, "self_attn.pv_bmm")
    w13, w2 = ly["w13_proj"], ly["w2"]
    F = w13["wq"].shape[-1] // 2
    wb = weight_bits(w13["wq"], D)
    if kc.otail_kernel and B * T <= kc.stacked_bt_max and stacked_mlp_supported(D, F, wb):
        # o-proj -> o fq -> resid_add_1 -> the whole MLP block in one launch
        out = fused_otail_block_w4(a8.reshape(B * T, qd), x.reshape(B * T, D), ly["o_proj"],
                                   ly["mlp_norm"]["w"], ly["mlp_norm"]["b"], w13, w2,
                                   _mlp_block_meta(lr, policy, c) + _otail_meta_ext(lr, policy),
                                   l, c.hidden_act, _mlp_block_site_on(policy),
                                   _otail_site_on(policy), norm_kind_of(c))
        return out.reshape(B, T, D), rows
    o = _int_linear(a8, ar, ly["o_proj"], l, kc)
    o = _fq16(o, lr["self_attn.o_proj"].get("output"), policy["self_attn.o_proj"].output)
    resid = _resid_add(x, o, lr, policy, "resid_add_1")

    # --- mlp ---
    if (kc.stacked_mlp_kernel and B * T <= kc.stacked_bt_max
            and stacked_mlp_supported(D, F, wb)):
        # the whole MLP block (norm -> w13 -> gate -> w2 -> resid_add_2) in one
        # launch, checked before the split path as in the JAX engine
        out = fused_mlp_block_w4(resid.reshape(B * T, D), ly["mlp_norm"]["w"],
                                 ly["mlp_norm"]["b"], w13, w2,
                                 _mlp_block_meta(lr, policy, c), l, c.hidden_act,
                                 _mlp_block_site_on(policy), norm_kind_of(c))
        return out.reshape(B, T, D), rows
    if kc.mlp_block_kernel and wb == 8:
        # the whole MLP block on the layer's W8 packs in one launch, any B·T
        mm_kind = "vpu" if (kc.vpu_matvec and B * T == 1) else "mxu"
        out = fused_mlp_block(resid.reshape(B * T, D), ly["mlp_norm"]["w"][l],
                              ly["mlp_norm"]["b"][l], layer_pack(w13, l), layer_pack(w2, l),
                              _mlp_block_meta(lr, policy, c), c.hidden_act, norm_kind_of(c),
                              mm_kind)
        return out.reshape(B, T, D), rows
    h2 = _norm(resid, ly["mlp_norm"], l, "post_attention_layernorm", lr, policy, c)
    h28, h2r = out_q8(h2, "post_attention_layernorm")
    w2in = lr["mlp.w2"]["input"]
    if kc.mlp_kernel and wb == 8:
        # w13, the gate chain and the raw w2 sums in one launch (any B·T); the
        # w2 affine epilogue here, as in the JAX engine
        w2l = layer_pack(w2, l)
        acc, rsum = fused_mlp(h28.reshape(B * T, D), layer_pack(w13, l), w2l,
                              _mlp_block_meta(lr, policy, c)[:16], c.hidden_act)
        y = int_affine(acc, rsum, w2l["scale"], w2l["offset"], w2l["colsum"], w2l.get("bias"),
                       w2in["scale"], w2in["offset"], F).reshape(B, T, D)
        y = _fq16(y, lr["mlp.w2"].get("output"), policy["mlp.w2"].output)
        return _resid_add(resid, y, lr, policy, "resid_add_2"), rows
    if (kc.gate_kernel and kc.w2fold_kernel and T > 1
            and w13_gate_w2_supported(B * T, D, F, wb)):
        # w13, the gate chain, w2 and its epilogue in one launch (the JAX
        # engine's w2-folded prefill route)
        y = w13_gate_w2(h28.reshape(B * T, D), w13, w2, _mlp_block_meta(lr, policy, c), l,
                        c.hidden_act, _mlp_block_site_on(policy)[1:5]).reshape(B, T, D)
        y = _fq16(y, lr["mlp.w2"].get("output"), policy["mlp.w2"].output)
        return _resid_add(resid, y, lr, policy, "resid_add_2"), rows
    if kc.gate_kernel and T > 1:
        if not w13_gate_supported(D, F, wb):
            raise NotImplementedError("the w13+gate kernel takes K % 64 == 0, F % 64 == 0")
        act8 = w13_gate(h28.reshape(B * T, D), w13, _mlp_block_meta(lr, policy, c), l,
                        c.hidden_act, site_on=_mlp_block_site_on(policy)[1:5])
        act8 = act8.reshape(B, T, F)
    else:
        g13 = _int_linear(h28, h2r, w13, l, kc)
        g13 = fake_quant(g13, w13["out_scale"][l][0], w13["out_offset"][l][0],
                         policy["mlp.w1"].output)
        g1, g3 = g13[..., :F], g13[..., F:]
        if c.hidden_act == "silu":
            sig = torch.sigmoid(g1)
            af = lr["mlp.act_fn"]
            if "input2" in af:
                sig = _fq16(sig, af["input2"], policy["mlp.act_fn"].input2)
            act = g1 * sig
        else:
            act = torch.nn.functional.gelu(g1, approximate="tanh")
        act = _fq16(act, lr["mlp.act_fn"].get("output"), policy["mlp.act_fn"].output)
        act = act * g3
        act8 = qops.quantize_act(act, w2in["scale"], w2in["offset"])
    y = _int_linear(act8, w2in, w2, l, kc)
    y = _fq16(y, lr["mlp.w2"].get("output"), policy["mlp.w2"].output)
    return _resid_add(resid, y, lr, policy, "resid_add_2"), rows


def forward(packed: dict, tokens, config: ModelConfig, policy: QPolicy,
            positions=None, kv_cache: Optional[EngineKVCache] = None,
            cache_position=None, kv_valid_len=None,
            kc=KernelConfig(), logits_at=None):
    """Packed-int forward -> (logits, kv_cache), on the device of the packed
    model. T > 1 is a prefill (rows written into the cache in place), T = 1
    with a cache the decode-light step (under attn_kernel: the row written
    into the cache, then the decode attention kernel). With a StagedKVCache
    (T = 1 only) the step is a chunked-staging step: cache_position is the
    chunk-start position, the caches are read, not written, and the returned
    StagedKVCache carries the step's rows as pending (pk/pv) with m + 1.
    On the int4 cache (the policy's KV bitwidth 4) a prefill unpacks the
    cache once and repacks it in place; a decode step reads it packed.
    logits_at: optional (B,) row index, to run the final norm and head on
    that single position ((B, 1, V)). kc: a KernelConfig or a legacy
    use_pallas value (KernelConfig.coerce)."""
    c = config
    kc = KernelConfig.coerce(kc)
    _check_config(c)
    _check_policy(policy)
    dev = packed["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).to(torch.long)
    B, T = tokens.shape
    kv_bits = policy_kv_bits(policy)
    staging = None
    if isinstance(kv_cache, StagedKVCache):
        if T != 1 or kc.attn_kernel:
            raise ValueError("a StagedKVCache takes T = 1 decode-light steps "
                             "(no attn_kernel)")
        staging = kv_cache
        kv_cache = EngineKVCache(staging.k, staging.v)
    kv_packed = False          # this pass reads the int4 cache packed
    packed_cache = None        # a prefill's int4 cache, repacked at the end
    if kv_bits == 4 and kv_cache is not None:
        if T > 1:
            # unpack once, run the int8 program as it is, repack in place
            packed_cache = kv_cache
            kv_cache = EngineKVCache(qops.unpack_kv_s(kv_cache.k), qops.unpack_kv_s(kv_cache.v))
        elif kc.attn_kernel:
            raise NotImplementedError("int4 KV decode: the attention kernels read int8 "
                                      "caches (the JAX engine refuses this too)")
        else:
            kv_packed = True
    if positions is None:
        positions = torch.arange(T, device=dev)[None].expand(B, T)
    positions = torch.as_tensor(positions, device=dev).to(torch.int32)
    if kv_valid_len is not None:
        kv_valid_len = torch.as_tensor(kv_valid_len, device=dev).to(torch.int32)
    x = packed["embed"][tokens].to(torch.float32)
    if c.normalize_embed:
        x = x * math.sqrt(c.hidden_size)
    cos, sin = M.rope_cos_sin(positions, c)

    has_cache = kv_cache is not None
    if kv_cache is None:
        # no cache object: keys/values come from the segment itself
        shape = (c.num_layers, B, c.num_kv_heads, T, c.head_dim_)
        kv_cache = EngineKVCache(torch.zeros(shape, dtype=torch.int8, device=dev),
                                 torch.zeros(shape, dtype=torch.int8, device=dev))
        cache_position = torch.zeros((B,), dtype=torch.int32, device=dev)
    cache_position = torch.as_tensor(cache_position, device=dev).to(torch.int32)
    S = kv_cache.k.shape[4] * 2 if kv_packed else kv_cache.k.shape[3]
    decode_light = T == 1 and not kc.attn_kernel
    mask = None
    if not decode_light and not kc.attn_kernel:
        mask = M.causal_mask(positions, S, c.neg_inf, kv_valid_len)

    rr = packed["ranges"]
    L = c.num_layers
    prep = {}
    if kc.gate_kernel and T > 1:
        prep["ofq"] = _qkv_ofq_rows(packed, policy)
        prep["outq"] = _qkv_outq_rows(rr, c, L, dev)
        prep["cs"] = _rope_cs_rows(cos, sin, c.head_dim_, c.rotary_dim)

    # the whole-step and whole-layer kernels read int8 caches
    fused = (decode_light and has_cache and staging is None and kv_bits == 8
             and (kc.model_kernel or kc.layer_kernel) and layer_kernel_supported(c, S))
    ly = packed["layers"]
    Hkv, hd = c.num_kv_heads, c.head_dim_
    if (kv_packed and staging is not None and staging.kcs is not None and kc.kv4_attn_kernel
            and kv4_attn_supported(Hkv, S, hd, B)):
        # the kv4 kernel reads the layer-stacked packed cache, staging buffers
        # and K column sums by layer index, flattened to (L, B·Hkv, ...) views
        BH, cs = B * Hkv, staging.sk.shape[3]
        prep["kv4"] = {"kp": kv_cache.k.reshape(L, BH, hd, S // 2),
                       "vp": kv_cache.v.reshape(L, BH, hd, S // 2),
                       "kcs": staging.kcs.reshape(L, BH, S),
                       "sk": staging.sk.reshape(L, BH, cs, hd),
                       "sv": staging.sv.reshape(L, BH, cs, hd)}
    logits = None
    if (staging is not None and kc.chunk_kernel and kv_bits == 8
            and chunk_kernel_supported(c, S, B)):
        # the whole staged step in one launch (B = 16..128), with the W4 / W8 head
        # folded when it fits
        kp = _kernel_prep(packed, policy, c)
        fold = "head_q" in packed and head_kernel_supported(packed["head_q"], c.hidden_size)
        kcs = staging.kcs if staging.kcs is not None else kv_colsums(kv_cache.k)
        res = fused_model_w4_chunk(
            x.reshape(B, -1), cache_position,
            _rope_cs_rows(cos, sin, hd, c.rotary_dim).reshape(B, 2, hd), kp["ofq"],
            ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"],
            ly["w13_proj"], ly["w2"], kv_cache.k, kv_cache.v, kcs, staging.sk,
            staging.sv, staging.m, kp["meta"],
            packed["head_q"] if fold else None, packed["norm"] if fold else None,
            num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd,
            rotary_dim=c.rotary_dim, act_kind=c.hidden_act, norm_kind=norm_kind_of(c),
            qk_fq_on=_on(policy["self_attn.qk_bmm"].output),
            pv_fq_on=_on(policy["self_attn.pv_bmm"].input))
        h = res[0].reshape(B, T, -1)
        k_rows, v_rows = res[1][:, :, :Hkv], res[1][:, :, Hkv:]
        if fold:
            logits = res[2][:, :c.vocab_size].reshape(B, T, c.vocab_size)
    elif fused and kc.model_kernel and B <= MAX_BATCH:
        # the whole step in one launch, with the W4 / W8 head folded when it fits
        kp = _kernel_prep(packed, policy, c)
        fold = "head_q" in packed and head_kernel_supported(packed["head_q"], c.hidden_size)
        res = fused_model_w4(
            x.reshape(B, -1), cache_position,
            _rope_cs_rows(cos, sin, hd, c.rotary_dim).reshape(B, 2, hd), kp["ofq"],
            ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"],
            ly["w13_proj"], ly["w2"], kv_cache.k, kv_cache.v, kp["meta"],
            packed["head_q"] if fold else None, packed["norm"] if fold else None,
            num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd,
            rotary_dim=c.rotary_dim, act_kind=c.hidden_act, norm_kind=norm_kind_of(c))
        h = res[0].reshape(B, T, -1)
        k_rows, v_rows = res[1][:, :, :Hkv], res[1][:, :, Hkv:]
        if fold:
            logits = res[2][:, :c.vocab_size].reshape(B, T, c.vocab_size)
    else:
        if fused and kc.layer_kernel and B == 1:
            prep["layer"] = _kernel_prep(packed, policy, c)
            prep["cs"] = _rope_cs_rows(cos, sin, hd, c.rotary_dim).reshape(B, 2, hd)
        h = x
        rows_k, rows_v = [], []
        for l in range(L):
            st = None if staging is None else (staging.sk[l], staging.sv[l])
            h, rows = _layer_forward(
                packed, l, layer_ranges(rr, l), h, cos, sin, mask, kv_cache,
                cache_position, c, policy, kc, kv_valid_len, positions, prep, decode_light,
                st=st, staged_len=None if staging is None else staging.m,
                k_colsum=None if staging is None or staging.kcs is None else staging.kcs[l],
                kv_bits=kv_bits)
            if rows is not None:
                rows_k.append(rows[0][:, :, 0])
                rows_v.append(rows[1][:, :, 0])
        if decode_light:
            k_rows, v_rows = torch.stack(rows_k), torch.stack(rows_v)
    if staging is not None:
        # the step's rows (L, B, Hkv, 1, hd) come back pending; decode_loop
        # appends them to the staging buffers at the top of the next step
        kv_cache = staging._replace(m=staging.m + 1, pk=k_rows[:, :, :, None],
                                    pv=v_rows[:, :, :, None])
    elif decode_light and kv_packed:
        # the step's rows merged into the packed cache (a one-column flush)
        qops.kv_flush_packed(kv_cache.k, k_rows[:, :, :, None], cache_position)
        qops.kv_flush_packed(kv_cache.v, v_rows[:, :, :, None], cache_position)
    elif decode_light:
        # one write of the step's rows (L, B, Hkv, hd) per cache after the layers
        bi = torch.arange(B, device=dev)
        pi = cache_position.to(torch.long)
        kv_cache.k[:, bi, :, pi] = k_rows.transpose(0, 1)
        kv_cache.v[:, bi, :, pi] = v_rows.transpose(0, 1)
    if packed_cache is not None:
        packed_cache.k.copy_(qops.pack_kv_s(kv_cache.k))
        packed_cache.v.copy_(qops.pack_kv_s(kv_cache.v))
        kv_cache = packed_cache
    if logits is not None:
        return logits, kv_cache

    if logits_at is not None and T > 1:
        idx = torch.as_tensor(logits_at, device=dev).to(torch.long)
        h = h[torch.arange(B, device=dev), idx][:, None]

    y = _norm_fn(c)(h, c.norm_eps) * packed["norm"]["w"] + packed["norm"]["b"]
    if "head_q" in packed:
        logits = quantized_head_logits(y, packed["head_q"], c.vocab_size,
                                       use_kernel=kc.any_kernel)
    else:
        head = packed["embed"].T if c.tie_word_embeddings else packed["lm_head"]["w"]
        logits = torch.matmul(y, head.to(torch.float32))
    return logits, kv_cache


def quantized_head_logits(y: torch.Tensor, hq: dict, vocab_size: int,
                          use_kernel: bool) -> torch.Tensor:
    """Dynamic per-token A8 × the per-channel symmetric head pack -> fp32
    logits (B, T, vocab). use_kernel: decode-sized rows (B·T <= 64) of a W4
    head go through the W4A8 kernel with x_scale 1 / x_offset 128, the per-row
    dynamic scales multiplied after (exact: the acts are symmetric and the
    head has no bias), as in the JAX engine; a W8 head, or more rows, the
    plain int head (a W8 head runs in a kernel only where the whole-model or
    chunk kernel folds it)."""
    B, T, D = y.shape
    w4 = hq["wq"].shape[0] * 2 == D
    if use_kernel and w4 and B * T <= 64:
        x_q, sx = qops.dynamic_quantize_act(y.reshape(B * T, D))
        logits = w4a8_matmul(x_q, hq, 1.0, 128.0) * sx
        return logits[:, :vocab_size].reshape(B, T, vocab_size)
    return qops.int_head_linear(y, hq)[..., :vocab_size]


def kv_colsums(k: torch.Tensor) -> torch.Tensor:
    """Σ_hd of an int8 K cache (L, B, Hkv, S, hd) -> (L, B, Hkv, S) fp32."""
    return torch.sum(k, dim=-1, dtype=torch.int32).to(torch.float32)


def _stage_pending(st: StagedKVCache, kc: KernelConfig) -> StagedKVCache:
    """Append the last step's pending rows at column m − 1 (in place): the
    staged_append kernel under any kernel flag, else its plain version."""
    if st.pk is None:
        return st
    append = staged_append if kc.any_kernel else staged_append_plain
    append(st.sk, st.sv, st.pk, st.pv, st.m - 1)
    return st._replace(pk=None, pv=None)


def _flush(cache: torch.Tensor, staged: torch.Tensor, pos0: torch.Tensor) -> None:
    """Write the chunk's staged columns (L, B, Hkv, cs, hd) into the cache at
    each sequence's chunk-start position (in place)."""
    B, cs = staged.shape[1], staged.shape[3]
    bi = torch.arange(B, device=cache.device)[:, None]
    si = pos0.to(torch.long)[:, None] + torch.arange(cs, device=cache.device)[None]
    cache[:, bi, :, si] = staged.permute(1, 3, 0, 2, 4)


def decode_loop(packed: dict, first_token: torch.Tensor, kv_cache: EngineKVCache,
                start_pos: torch.Tensor, n_steps: int, config: ModelConfig,
                policy: QPolicy, kc=None,
                temperature=0.0, generator: Optional[torch.Generator] = None,
                staging_chunk: int = 32, max_start: Optional[int] = None):
    """n_steps of decode, one T=1 forward per step. first_token (B, 1),
    start_pos (B,) -> (tokens (B, n_steps), cache, last logits (B, V)).

    kc takes what the JAX decode_loop's use_pallas takes: an explicit
    KernelConfig is used as it is; a legacy value (a bool or a mode string;
    None is True, the entry point's) is coerced and then, as the JAX
    decode_loop does, gets stacked_bt_max raised to 128 and the chunk kernel
    beside the whole-model kernel for W8 packs at 8 < B <= 48
    (KernelConfig.serving). On the int8 cache at B <= 8 with a whole-step or
    whole-layer kernel, or under attn_kernel, each step writes its rows into
    the cache (one whole-model launch a step under KernelConfig.decode()).
    Otherwise (B > 8, the int4 cache, or no such kernel) the loop runs in
    chunked staging, as the JAX engine's: chunks of staging_chunk steps
    (n_steps when it is not a larger multiple); within a chunk the cache is
    read-only, the K column sums are made once, each step first appends the
    previous step's rows to the staging buffers, and after the chunk they
    are written into the cache at the chunk-start positions (on the int4
    cache, merged into its nibbles by qops.kv_flush_packed). The chunk's
    rows must fit the cache: start_pos + n_steps <= max_seq_len, checked once
    per call against max_start, the caller's host copy of start_pos.max()
    (a continuous batcher knows it); without it start_pos.max() is read back
    to the host: one synchronisation per call, before the first step.

    temperature: a float (0 = greedy) or a per-row (B,) tensor, where rows
    at 0 take the argmax and the others draw from `generator`
    (sampling.loop_next_token)."""
    from mobilequant_tpu_torch.runtime.sampling import loop_next_token
    B = first_token.shape[0]
    if not isinstance(kc, KernelConfig):
        kc = KernelConfig.serving(config, packed, B, True if kc is None else kc)
    kv4 = policy_kv_bits(policy) == 4
    if kv4 and kc.attn_kernel:
        raise NotImplementedError("int4 KV decode: the attention kernels read int8 caches "
                                  "(the JAX engine refuses this too)")
    use_staging = not kc.attn_kernel and (kv4 or B > 8
                                          or not (kc.layer_kernel or kc.model_kernel))
    token, pos, cache = first_token, start_pos, kv_cache
    toks, last = [], None
    if not use_staging:
        for _ in range(n_steps):
            logits, cache = forward(packed, token, config, policy, positions=pos[:, None],
                                    kv_cache=cache, cache_position=pos,
                                    kv_valid_len=pos + 1, kc=kc)
            last = logits[:, -1]
            token = loop_next_token(last, temperature, generator)[:, None]
            toks.append(token)
            pos = pos + 1
        return torch.cat(toks, 1), cache, last

    if kv4:
        L, _, Hkv, hd, S2 = cache.k.shape
        S = 2 * S2
    else:
        L, _, Hkv, S, hd = cache.k.shape
    colsums = qops.kv_colsums_packed if kv4 else kv_colsums
    cs = staging_chunk if (n_steps > staging_chunk and n_steps % staging_chunk == 0) \
        else n_steps
    end = (int(start_pos.max()) if max_start is None else int(max_start)) + n_steps
    if end > S:
        raise ValueError(f"decode_loop: {n_steps} steps from position "
                         f"{end - n_steps} pass the cache's {S} rows")
    for _ in range(n_steps // cs):
        pos0 = pos
        shape = (L, B, Hkv, cs, hd)
        st = StagedKVCache(cache.k, cache.v, torch.zeros(shape, dtype=cache.k.dtype,
                                                         device=cache.k.device),
                           torch.zeros(shape, dtype=cache.v.dtype, device=cache.v.device),
                           0, colsums(cache.k))
        for _ in range(cs):
            st = _stage_pending(st, kc)
            logits, st = forward(packed, token, config, policy, positions=pos[:, None],
                                 kv_cache=st, cache_position=pos0, kv_valid_len=pos + 1,
                                 kc=kc)
            last = logits[:, -1]
            token = loop_next_token(last, temperature, generator)[:, None]
            toks.append(token)
            pos = pos + 1
        st = _stage_pending(st, kc)
        flush = qops.kv_flush_packed if kv4 else _flush
        flush(cache.k, st.sk, pos0)
        flush(cache.v, st.sv, pos0)
    return torch.cat(toks, 1), cache, last
