"""The functional FP decoder (the port of mobilequant_tpu/models/model.py).

The model is a function over a parameter tree of plain dictionaries with
layer-stacked leaves (every per-layer leaf has a leading L axis); the layer
loop is a Python loop that hands each layer its slice. Weights are stored
(in_features, out_features), so the hot op is `x @ w`. Biases are always
present (zeros where the architecture has none).

Quantization attaches through an `Ops` object: every quantizable op site
(linear, norm, the two attention matmuls, softmax, act, mul, add, the MoE
expert projections) goes through `ops.<op>(site, ...)`. `Ops` is plain FP
math; the weight-only mode (runtime/wonly.py) overrides `linear` and
`expert_linear` to run each projection against its integer pack, and the
fake-quant sim (quant/qmodel.py) every site, `transform_layer` (LET) and
`pop_stats` (calibration statistics).

Behaviour kept from the JAX model, so that the same inputs give the same
numbers: the additive causal mask value neg_inf = -40000; qk_matmul takes
unscaled q / k and the 1/sqrt(head_dim) comes after; the softmax runs in
fp32; the KV cache holds num_kv_heads (pre-GQA) K / V; partial rotary rotates
the first rotary_dim dims; Gemma scales embeddings by sqrt(hidden). Attention
is written with the JAX model's einsums (GQA inside the einsum), not with a
fused attention call, whose numerics would differ.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from mobilequant_tpu_torch.models.config import ModelConfig

Params = dict


# ---------------------------------------------------------------------------
# Op interception (quantization attachment points)
# ---------------------------------------------------------------------------

class Ops:
    """Plain-FP implementations of every quantizable op site.

    `site` is the op's name inside one decoder layer (e.g.
    "self_attn.q_proj"). Subclasses override these; `begin_layer(extras)` is
    called with the layer's slice of `layer_extras` before each layer runs,
    `transform_layer` reparameterizes the layer's weights, and `pop_stats`
    hands over what the layer recorded."""

    def begin_layer(self, extras) -> None:
        pass

    def transform_layer(self, lp: Params, config: ModelConfig) -> Params:
        return lp

    def pop_stats(self) -> dict:
        return {}

    def linear(self, site: str, x, w, b):
        return x @ w + b

    def rmsnorm(self, site: str, x, w, b, eps: float):
        xf = x.to(torch.float32)
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        return (y * w + b).to(x.dtype)

    def layernorm(self, site: str, x, w, b, eps: float):
        xf = x.to(torch.float32)
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * w + b).to(x.dtype)

    def qk_matmul(self, site: str, q, k):
        """q (B,T,Hkv,G,hd), k (B,S,Hkv,hd) -> scores (B,Hkv,G,T,S)."""
        return torch.einsum("btkgh,bskh->bkgts", q, k)

    def pv_matmul(self, site: str, p, v):
        """p (B,Hkv,G,T,S), v (B,S,Hkv,hd) -> (B,T,Hkv,G,hd)."""
        return torch.einsum("bkgts,bskh->btkgh", p, v)

    def softmax(self, site: str, x, dtype):
        return torch.softmax(x.to(torch.float32), dim=-1).to(dtype)

    def act_fn(self, site: str, x, kind: str):
        if kind == "silu":
            return x * torch.sigmoid(x)
        if kind == "gelu_tanh":
            return torch.nn.functional.gelu(x, approximate="tanh")
        if kind == "gelu":
            return torch.nn.functional.gelu(x)
        raise ValueError(f"unknown activation {kind!r}")

    def mul(self, site: str, a, b):
        return a * b

    def add(self, site: str, a, b):
        return a + b

    def expert_linear(self, site: str, x, w, b):
        """MoE projection over stacked experts: x (B,T,D) with w (E,D,F) ->
        (B,T,E,F); x (B,T,E,F) with w (E,F,D) -> (B,T,E,D)."""
        if x.dim() == 3:
            return torch.einsum("btd,edf->btef", x, w) + b
        return torch.einsum("btef,efd->bted", x, w) + b

    def moe_dispatch(self, combine):
        """Hook: the (B,T,E) combine weights of the current MoE block, called
        before its expert sites run; plain-FP ops ignore it."""


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(config: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device=None) -> Params:
    """Random-init parameter tree with layer-stacked leaves, made on `device`
    from `generator`: the JAX model's distributions (dense weights and the
    embedding N(0, 0.02²), norm weights 1, biases 0), not its numbers."""
    c = config
    dev = torch.device(device) if device is not None else generator.device
    qd, kvd = c.q_dim, c.kv_dim
    L, D, F = c.num_layers, c.hidden_size, c.intermediate_size

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * 0.02).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    layers = {
        "attn_norm": {"w": ones(L, D), "b": zeros(L, D)},
        "q_proj": {"w": normal(L, D, qd), "b": zeros(L, qd)},
        "k_proj": {"w": normal(L, D, kvd), "b": zeros(L, kvd)},
        "v_proj": {"w": normal(L, D, kvd), "b": zeros(L, kvd)},
        "o_proj": {"w": normal(L, qd, D), "b": zeros(L, D)},
    }
    if c.is_moe:
        E = c.num_local_experts
        layers["router"] = {"w": normal(L, D, E)}
        layers["w1"] = {"w": normal(L, E, D, F), "b": zeros(L, E, F)}
        layers["w2"] = {"w": normal(L, E, F, D), "b": zeros(L, E, D)}
        if c.num_linears_per_mlp == 3:
            layers["w3"] = {"w": normal(L, E, D, F), "b": zeros(L, E, F)}
    else:
        layers["w1"] = {"w": normal(L, D, F), "b": zeros(L, F)}
        layers["w2"] = {"w": normal(L, F, D), "b": zeros(L, D)}
        if c.num_linears_per_mlp == 3:
            layers["w3"] = {"w": normal(L, D, F), "b": zeros(L, F)}
    if not c.shared_attention_norm:
        layers["mlp_norm"] = {"w": ones(L, D), "b": zeros(L, D)}
    params = {"embed": {"w": normal(c.vocab_size, D)}, "layers": layers,
              "norm": {"w": ones(D), "b": zeros(D)}}
    if not c.tie_word_embeddings:
        params["lm_head"] = {"w": normal(D, c.vocab_size)}
    return params


# ---------------------------------------------------------------------------
# RoPE and the mask
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, config: ModelConfig, dtype=torch.float32):
    """cos/sin tables for given positions: (..., T, rotary_dim), computed in
    fp32 and cast to `dtype`.

    HF "rotate_half" convention: freqs duplicated [f, f] along the last axis."""
    rd = config.rotary_dim
    ar = torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (config.rope_theta ** (ar / rd))
    freqs = positions.to(torch.float32)[..., None] * inv_freq   # (..., T, rd/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int):
    """x: (B,T,H,hd); cos/sin: (B,T,rd). Rotates the first rotary_dim dims only."""
    if rotary_dim == x.shape[-1]:
        xr, x_pass = x, None
    else:
        xr, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    xr = xr * c + _rotate_half(xr) * s
    if x_pass is None:
        return xr
    return torch.cat([xr, x_pass], dim=-1)


def causal_mask(q_positions: torch.Tensor, kv_len: int, neg_inf: float,
                kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Additive mask (B, 1, T, S): 0 where kv_pos <= q_pos (and the kv slot is
    valid), else neg_inf."""
    kv_pos = torch.arange(kv_len, device=q_positions.device)[None, None, :]
    q_pos = q_positions[:, :, None]
    ok = kv_pos <= q_pos
    if kv_valid_len is not None:
        ok = ok & (kv_pos < kv_valid_len[:, None, None])
    zero = torch.zeros((), dtype=torch.float32, device=q_positions.device)
    return torch.where(ok, zero, neg_inf)[:, None, :, :]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Stacked float KV cache: k/v (L, B, S_max, Hkv, hd)."""
    k: torch.Tensor
    v: torch.Tensor


def _write_rows(cache: torch.Tensor, new: torch.Tensor, start: torch.Tensor) -> None:
    """cache (B,S,Hkv,hd) <- new (B,T,Hkv,hd) at each sequence's start, in
    place (start clamped to S − T, as a dynamic update slice clamps it)."""
    B, T = new.shape[:2]
    st = torch.clamp(start.to(torch.long), 0, cache.shape[1] - T)
    bi = torch.arange(B, device=cache.device)[:, None]
    si = st[:, None] + torch.arange(T, device=cache.device)[None]
    cache[bi, si] = new.to(cache.dtype)


def attention(ops: Ops, lp: Params, x: torch.Tensor, cos, sin, mask,
              config: ModelConfig, kv: Optional[tuple] = None,
              cache_position: Optional[torch.Tensor] = None):
    """Self-attention of one layer. x (B,T,D). kv: optional (k_cache, v_cache)
    of this layer, each (B,S_max,Hkv,hd), written in place at cache_position;
    without it keys and values come from the segment itself.
    -> (attn_out (B,T,D), (k, v) of the layer: the caches, or the segment's)."""
    c = config
    B, T, _ = x.shape
    hd, Hq, Hkv = c.head_dim_, c.num_heads, c.num_kv_heads
    G = Hq // Hkv

    q = ops.linear("self_attn.q_proj", x, lp["q_proj"]["w"], lp["q_proj"]["b"])
    k = ops.linear("self_attn.k_proj", x, lp["k_proj"]["w"], lp["k_proj"]["b"])
    v = ops.linear("self_attn.v_proj", x, lp["v_proj"]["w"], lp["v_proj"]["b"])
    q = apply_rope(q.reshape(B, T, Hq, hd), cos, sin, c.rotary_dim)
    k = apply_rope(k.reshape(B, T, Hkv, hd), cos, sin, c.rotary_dim)
    v = v.reshape(B, T, Hkv, hd)

    if kv is not None:
        k_use, v_use = kv
        _write_rows(k_use, k, cache_position)
        _write_rows(v_use, v, cache_position)
    else:
        k_use, v_use = k, v

    scores = ops.qk_matmul("self_attn.qk_bmm", q.reshape(B, T, Hkv, G, hd), k_use)
    scores = scores / math.sqrt(hd)
    scores = scores + mask[:, :, None, :, :]                      # (B,1,1,T,S)
    probs = ops.softmax("self_attn.softmax", scores, x.dtype)
    out = ops.pv_matmul("self_attn.pv_bmm", probs, v_use)         # (B,T,Hkv,G,hd)
    out = ops.linear("self_attn.o_proj", out.reshape(B, T, Hq * hd),
                     lp["o_proj"]["w"], lp["o_proj"]["b"])
    return out, (k_use, v_use)


def mlp(ops: Ops, lp: Params, x: torch.Tensor, config: ModelConfig):
    if config.is_moe:
        return moe_block(ops, lp, x, config)
    h = ops.linear("mlp.w1", x, lp["w1"]["w"], lp["w1"]["b"])
    h = ops.act_fn("mlp.act_fn", h, config.hidden_act)
    if config.num_linears_per_mlp == 3:
        g = ops.linear("mlp.w3", x, lp["w3"]["w"], lp["w3"]["b"])
        h = ops.mul("mlp.gate_mul", h, g)
    return ops.linear("mlp.w2", h, lp["w2"]["w"], lp["w2"]["b"])


def moe_block(ops: Ops, lp: Params, x: torch.Tensor, config: ModelConfig):
    """Mixtral-style top-k MoE in the dense formulation: every expert runs,
    and a (B,T,E) combine tensor (zero outside the top-k) mixes them."""
    c = config
    logits = x @ lp["router"]["w"]                                # (B,T,E)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_vals, top_idx = torch.topk(probs, c.num_experts_per_tok, dim=-1)
    top_vals = top_vals / top_vals.sum(-1, keepdim=True)
    onehot = torch.nn.functional.one_hot(top_idx, c.num_local_experts).to(top_vals.dtype)
    combine = (onehot * top_vals[..., None]).sum(-2).to(x.dtype)  # (B,T,E)
    ops.moe_dispatch(combine)

    h = ops.expert_linear("mlp.w1", x, lp["w1"]["w"], lp["w1"]["b"])   # (B,T,E,F)
    h = ops.act_fn("mlp.act_fn", h, c.hidden_act)
    if c.num_linears_per_mlp == 3:
        g = ops.expert_linear("mlp.w3", x, lp["w3"]["w"], lp["w3"]["b"])
        h = ops.mul("mlp.gate_mul", h, g)
    y = ops.expert_linear("mlp.w2", h, lp["w2"]["w"], lp["w2"]["b"])   # (B,T,E,D)
    return torch.einsum("bted,bte->btd", y, combine)


def decoder_layer(ops: Ops, lp: Params, x: torch.Tensor, cos, sin, mask,
                  config: ModelConfig, kv=None, cache_position=None):
    """One pre-norm decoder layer -> (out, (k, v))."""
    c = config
    lp = ops.transform_layer(lp, c)
    norm_fn = ops.layernorm if c.norm_class == "layernorm" else ops.rmsnorm
    h = norm_fn("input_layernorm", x, lp["attn_norm"]["w"], lp["attn_norm"]["b"], c.norm_eps)
    attn_out, kv_new = attention(ops, lp, h, cos, sin, mask, c, kv, cache_position)
    residual = ops.add("resid_add_1", x, attn_out)
    # parallel residual: the MLP takes the normed pre-attention stream
    hidden = h if c.parallel_residual else residual
    if not c.shared_attention_norm:
        hidden = norm_fn("post_attention_layernorm", hidden,
                         lp["mlp_norm"]["w"], lp["mlp_norm"]["b"], c.norm_eps)
    out = ops.add("resid_add_2", residual, mlp(ops, lp, hidden, c))
    return out, kv_new


def _layer_slice(tree, l: int):
    """A tree's leaves (tensors, arrays, sequences) indexed at layer l."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, l) for k, v in tree.items()}
    return tree[l]


def _stack_stats(per_layer: list):
    """[layer stats trees] -> one tree whose leaves are stacked over layers."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack_stats([t[k] for t in per_layer]) for k in first}
    return torch.stack(per_layer)


def forward_hidden(params: Params, tokens: torch.Tensor, config: ModelConfig,
                   ops: Optional[Ops] = None, positions=None,
                   kv_cache: Optional[KVCache] = None, cache_position=None,
                   kv_valid_len=None, collect_stats: bool = False, layer_extras=None,
                   apply_final_norm: bool = True, remat: bool = False):
    """Backbone forward. tokens (B,T) on the params' device. layer_extras: an
    optional tree of layer-stacked leaves; each layer's slice goes to
    ops.begin_layer before the layer runs. kv_cache: written in place at
    cache_position. collect_stats: gather each layer's ops.pop_stats() and
    stack them over layers. apply_final_norm: False returns the residual
    stream before the final norm. remat: recompute each layer on the backward
    pass (torch.utils.checkpoint), keeping only the layer boundaries.
    -> (hidden (B,T,D), the cache, or the segment's K / V stacks
    (L,B,T,Hkv,hd) without one, the stacked stats or None)."""
    c = config
    ops = ops or Ops()
    embed = params["embed"]["w"]
    tokens = torch.as_tensor(tokens, device=embed.device).to(torch.long)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=embed.device)[None].expand(B, T)
    positions = torch.as_tensor(positions, device=embed.device)
    if kv_valid_len is not None:
        kv_valid_len = torch.as_tensor(kv_valid_len, device=embed.device)
    if cache_position is not None:
        cache_position = torch.as_tensor(cache_position, device=embed.device)

    x = embed[tokens]
    if c.normalize_embed:
        x = x * torch.tensor(math.sqrt(c.hidden_size), dtype=x.dtype)
    cos, sin = rope_cos_sin(positions, c, x.dtype)
    S = kv_cache.k.shape[2] if kv_cache is not None else T
    mask = causal_mask(positions, S, c.neg_inf, kv_valid_len).to(x.dtype)

    def layer(x, lp, extras, kv):
        # begin_layer inside the layer, so that a recomputation under remat
        # sees this layer's extras
        ops.begin_layer(extras)
        return decoder_layer(ops, lp, x, cos, sin, mask, c, kv, cache_position)

    ks, vs, stats = [], [], []
    for l in range(c.num_layers):
        lp = _layer_slice(params["layers"], l)
        extras = _layer_slice(layer_extras, l) if layer_extras is not None else None
        kv = (kv_cache.k[l], kv_cache.v[l]) if kv_cache is not None else None
        if remat:
            x, (k_l, v_l) = torch.utils.checkpoint.checkpoint(
                layer, x, lp, extras, kv, use_reentrant=False)
        else:
            x, (k_l, v_l) = layer(x, lp, extras, kv)
        if collect_stats:
            stats.append(ops.pop_stats())
        if kv_cache is None:
            ks.append(k_l)
            vs.append(v_l)
    new_cache = kv_cache if kv_cache is not None else KVCache(torch.stack(ks), torch.stack(vs))

    # the final norm and head are never quantized: plain ops
    if apply_final_norm:
        plain = Ops()
        nf = plain.layernorm if c.norm_class == "layernorm" else plain.rmsnorm
        x = nf("norm", x, params["norm"]["w"], params["norm"]["b"], c.norm_eps)
    return x, new_cache, (_stack_stats(stats) if collect_stats else None)


def forward(params: Params, tokens, config: ModelConfig, ops: Optional[Ops] = None,
            positions=None, kv_cache: Optional[KVCache] = None,
            cache_position=None, kv_valid_len=None):
    """Full causal-LM forward -> (logits (B,T,V), the cache or segment K / V)."""
    x, new_cache, _ = forward_hidden(params, tokens, config, ops, positions,
                                     kv_cache, cache_position, kv_valid_len)
    head_w = params["embed"]["w"].T if config.tie_word_embeddings else params["lm_head"]["w"]
    return x @ head_w, new_cache
