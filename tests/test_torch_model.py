"""The port's FP model (mobilequant_tpu_torch/models/model.py) held against
the JAX package's (mobilequant_tpu/models/model.py).

The JAX model's seeded parameters are carried across as numpy
(convert.from_jax_params); the same numpy tokens go through both forwards in
fp32 on the CPU. Tolerance: logits rtol 1e-5 / atol 1e-4 (the same fp32
arithmetic, summed in other orders by XLA and PyTorch); a cached decode
chain against the full forward rtol 1e-4 / atol 1e-4 (attention over the
cache's masked slots instead of the segment).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import model as JM
from mobilequant_tpu.models.registry import MODEL_CONFIGS as J_CONFIGS

from mobilequant_tpu_torch.convert import from_jax_params
from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.models.registry import MODEL_CONFIGS

MODELS = ["test-llama", "test-gemma", "test-stablelm", "test-mixtral"]


def _params(name, seed=0):
    jcfg = J_CONFIGS[name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def test_port_configs_are_the_jax_ones():
    for name in MODELS + ["tinyllama-1.1b"]:
        assert dataclasses.asdict(MODEL_CONFIGS[name]) == dataclasses.asdict(J_CONFIGS[name])


@pytest.mark.parametrize("name", MODELS)
def test_forward_matches_jax(name):
    jcfg, jp, tp = _params(name)
    cfg = MODEL_CONFIGS[name]
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jkv = JM.forward(jp, jnp.asarray(toks), jcfg)
    tl, tkv = M.forward(tp, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-4)
    # no cache: the segment's K / V stacks (L, B, T, Hkv, hd)
    for t, j in ((tkv.k, jkv.k), (tkv.v, jkv.v)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_cached_decode_chain_matches_full_forward(name):
    """Prefill T0 tokens into a cache, then one token a step with per-sequence
    positions and kv_valid_len: each step's logits equal the full forward's
    row, and the JAX model's cached chain."""
    jcfg, jp, tp = _params(name, 1)
    cfg = MODEL_CONFIGS[name]
    B, T, T0, S = 2, 10, 6, 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    full, _ = M.forward(tp, torch.from_numpy(toks), cfg)
    shape = (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.head_dim_)
    cache = M.KVCache(torch.zeros(shape), torch.zeros(shape))
    jcache = JM.KVCache(jnp.zeros(shape), jnp.zeros(shape))
    pos0 = torch.arange(T0)[None].expand(B, T0)
    lg, cache = M.forward(tp, torch.from_numpy(toks[:, :T0]), cfg, positions=pos0,
                          kv_cache=cache, cache_position=torch.zeros(B, dtype=torch.int32),
                          kv_valid_len=torch.full((B,), T0))
    jl, jcache = JM.forward(jp, jnp.asarray(toks[:, :T0]), jcfg,
                            positions=jnp.asarray(pos0.numpy()), kv_cache=jcache,
                            cache_position=jnp.zeros((B,), jnp.int32),
                            kv_valid_len=jnp.full((B,), T0, jnp.int32))
    outs, jouts = [lg[:, -1]], [jl[:, -1]]
    for t in range(T0, T - 1):
        pos = torch.full((B,), t, dtype=torch.int32)
        lg, cache2 = M.forward(tp, torch.from_numpy(toks[:, t:t + 1]), cfg,
                               positions=pos[:, None], kv_cache=cache, cache_position=pos,
                               kv_valid_len=pos + 1)
        assert cache2.k is cache.k                       # written in place
        jl, jcache = JM.forward(jp, jnp.asarray(toks[:, t:t + 1]), jcfg,
                                positions=jnp.asarray(pos.numpy())[:, None], kv_cache=jcache,
                                cache_position=jnp.asarray(pos.numpy()),
                                kv_valid_len=jnp.asarray(pos.numpy()) + 1)
        outs.append(lg[:, 0])
        jouts.append(jl[:, 0])
    chain = torch.stack(outs, 1).numpy()
    np.testing.assert_allclose(chain, full[:, T0 - 1:T - 1].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(chain, np.stack([np.asarray(j) for j in jouts], 1),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_init_params_has_the_jax_tree(name):
    """init_params draws on an explicit torch.Generator and device: the JAX
    tree's keys, shapes and dtypes, the same distributions (not the same
    numbers), and the same draws from the same seed."""
    cfg = MODEL_CONFIGS[name]
    _, jp, _ = _params(name)
    tp = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat_t = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat_t[path + (k,)] = v
    walk(tp, ())
    assert {tuple(p.key for p in k) for k in flat_j} == set(flat_t)
    for k, v in flat_j.items():
        t = flat_t[tuple(p.key for p in k)]
        assert tuple(t.shape) == v.shape and t.dtype == torch.float32
        if k[-1].key == "w" and k[-2].key not in ("attn_norm", "mlp_norm", "norm"):
            assert abs(float(t.std()) - float(np.std(np.asarray(v)))) < 2e-3
    again = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"]["w"], tp["embed"]["w"])


def test_ops_sites_and_layer_extras_follow_jax():
    """The interception protocol: the same op sites in the same order as the
    JAX model's Ops, and each layer's slice of layer_extras handed to
    begin_layer before that layer runs."""
    name = "test-mixtral"
    jcfg, jp, tp = _params(name)
    cfg = MODEL_CONFIGS[name]
    toks = np.zeros((1, 3), np.int32)

    def recorder(base):
        class Rec(base):
            def __init__(self):
                self.sites, self.extras = [], []

            def begin_layer(self, extras):
                self.extras.append(extras)

        for op in ("linear", "qk_matmul", "pv_matmul", "softmax", "act_fn", "mul", "add",
                   "expert_linear", "rmsnorm", "layernorm"):
            def make(op):
                def fn(self, site, *a, **k):
                    self.sites.append(site)
                    return getattr(base, op)(self, site, *a, **k)
                return fn
            setattr(Rec, op, make(op))
        return Rec()

    jops, tops = recorder(JM.Ops), recorder(M.Ops)
    JM.forward_hidden(jp, jnp.asarray(toks), jcfg, jops)          # the scan traces one layer
    extras = {"li": torch.arange(cfg.num_layers), "v": {"a": torch.arange(2 * cfg.num_layers)
                                                             .reshape(cfg.num_layers, 2)}}
    M.forward_hidden(tp, torch.from_numpy(toks), cfg, tops, layer_extras=extras)
    per_layer = len(tops.sites) // cfg.num_layers
    assert tops.sites[:per_layer] == jops.sites
    assert tops.sites == jops.sites * cfg.num_layers
    assert [int(e["li"]) for e in tops.extras] == list(range(cfg.num_layers))
    assert [e["v"]["a"].tolist() for e in tops.extras] == [[2 * l, 2 * l + 1]
                                                           for l in range(cfg.num_layers)]
