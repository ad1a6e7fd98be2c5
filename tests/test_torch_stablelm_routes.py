"""StableLM's decode routes on the port's engine (the LayerNorm kernel
editions' plain versions on the CPU) held against the JAX engine's routes,
whose kernels run in interpret mode.

Model: the stablelm_mha64_partial shape, W4A8/h4, of
tests/test_torch_stablelm_kernels.py (norm vectors and q/k/v biases redrawn
from a seed). Routes: at B=1 the whole-model kernel (KernelConfig.decode()
against use_pallas=True) and the whole-layer kernel (decode_per_layer()
against "w4nomodelk"), three steps through the int8 cache; at B=16 the
entry config's staged route (the MLP-block kernel), the chunk kernel and
the o-tail kernel, four staged steps in chunks of two. Tolerances as
tests/test_torch_fused_model.py and test_torch_staged.py: greedy tokens
equal, logits rel <= 2e-3, or 2e-2 on a step or chain whose written K/V
bytes differ by a quantization step somewhere (XLA's CPU rsqrt / exp / sin
are not correctly rounded), such bytes on at most 0.1% of the cache.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.ops import pallas_chunk as PC
from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.kernel_config import KernelConfig as JKC

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_stablelm_kernels import _int8_close, _rel, built, policies


def _interpreted(names):
    """Patch the JAX kernels [(module, attr)] to interpret mode; returns the
    originals for the restore."""
    orig = [(mod, attr, getattr(mod, attr)) for mod, attr in names]
    for mod, attr, fn in orig:
        setattr(mod, attr, functools.partial(fn, interpret=True))
    return orig


def _restore(orig):
    for mod, attr, fn in orig:
        setattr(mod, attr, fn)
    jax.clear_caches()


# route -> (the JAX use_pallas, the port's kc, {wrapper: plain calls a step})
# (the per-layer route runs the unfolded W4 head through w4a8_matmul)
B1_ROUTES = {"decode": (True, KernelConfig.decode(), {"fused_model_w4": 1}),
             "per_layer": ("w4nomodelk", KernelConfig.decode_per_layer(),
                           {"fused_layer_w4": 2, "w4a8_matmul": 1})}


@pytest.mark.parametrize("route", list(B1_ROUTES))
def test_stablelm_b1_decode_route_matches_jax(route):
    """Three T=1 steps from the JAX prefill's cache: one whole-model call a
    step (KernelConfig.decode()) against use_pallas=True, or one whole-layer
    call a layer (decode_per_layer()) against "w4nomodelk"."""
    b = built(4)
    jpol, pol = policies(b, False)
    c = b["cfg"]
    toks = np.random.default_rng(5).integers(0, c.vocab_size, (1, 8)).astype(np.int32)
    Tp = 5
    jmode, kc, per_step = B1_ROUTES[route]
    orig = _interpreted([(PL, "fused_layer_w4_stacked"), (PL, "fused_model_w4_stacked"),
                         (PM, "int_linear_pallas_stacked"),
                         (PMLP, "fused_mlp_block_w4_stacked"), (PM, "w4a8_matmul")])
    try:
        routes = ((route, jmode, kc),)
        jcache = JE.init_kv_cache(b["jecfg"], 1)
        _, jcache = JE.forward(b["jpacked"], jnp.asarray(toks[:, :Tp]), b["jcfg"], jpol,
                               kv_cache=jcache, cache_position=jnp.zeros((1,), jnp.int32))
        caches = {name: E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                        torch.from_numpy(np.array(jcache.v)))
                  for name, _, _ in routes}
        jcaches = {name: jcache for name, _, _ in routes}
        T_ops.reset_counts()
        for i in range(3):
            p = Tp + i
            tok = toks[:, p:p + 1]
            for name, mode, kc in routes:
                jpos = jnp.full((1,), p, jnp.int32)
                jl, jcaches[name] = JE.forward(
                    b["jpacked"], jnp.asarray(tok), b["jcfg"], jpol, positions=jpos[:, None],
                    kv_cache=jcaches[name], cache_position=jpos, kv_valid_len=jpos + 1,
                    use_pallas=mode)
                pos = torch.full((1,), p, dtype=torch.int32)
                tl, caches[name] = E.forward(
                    b["packed"], torch.from_numpy(tok), c, pol, positions=pos[:, None],
                    kv_cache=caches[name], cache_position=pos, kv_valid_len=pos + 1, kc=kc)
                rows_equal = all(
                    np.array_equal(t.numpy()[:, :, :, p], np.asarray(j)[:, :, :, p])
                    for t, j in ((caches[name].k, jcaches[name].k),
                                 (caches[name].v, jcaches[name].v)))
                assert _rel(tl.numpy(), jl) < (2e-3 if rows_equal else 2e-2), (name, i)
        plain = T_ops.counts("plain_calls")
        assert {k: v for k, v in plain.items() if v} == {k: 3 * v for k, v in per_step.items()}
        for name, _, _ in routes:
            _int8_close(caches[name].k.numpy(), np.asarray(jcaches[name].k))
            _int8_close(caches[name].v.numpy(), np.asarray(jcaches[name].v))
    finally:
        _restore(orig)


STAGED_ROUTES = {"serving": (True, None, "fused_mlp_block_w4"),
                 "chunk": (JKC(chunk_kernel=True), KernelConfig(chunk_kernel=True),
                           "fused_model_w4_chunk"),
                 "otail": ("otail", KernelConfig.otail(), "fused_otail_block_w4")}


@pytest.mark.parametrize("route", list(STAGED_ROUTES))
def test_stablelm_staged_decode_chain_matches_jax_route(route):
    """A staged decode chain at B = 16 (staging_chunk 2, 4 steps: two chunks,
    a flush between them) against the JAX engine's on the same route: the
    entry config (decode_loop kc=None) vs decode_loop(use_pallas=True), the
    chunk kernel vs KernelConfig(chunk_kernel=True), or the o-tail kernel vs
    "otail". Tokens, flushed caches and the last logits are compared."""
    b = built(4)
    jpol, pol = policies(b, False)
    c = b["cfg"]
    B, Tp, n = 16, 5, 4
    toks = np.random.default_rng(7).integers(0, c.vocab_size, (2, Tp)).astype(np.int32)
    prompt = np.tile(toks, (B // 2, 1))
    orig = _interpreted([(PM, "int_linear_pallas_stacked"), (PM, "w4a8_matmul"),
                         (PMLP, "fused_mlp_block_w4_stacked"),
                         (PMLP, "fused_otail_block_stacked"), (PC, "fused_model_w4_chunk")])
    try:
        jcache = JE.init_kv_cache(b["jecfg"], B)
        lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                                kv_valid_len=jnp.full((B,), Tp, jnp.int32))
        first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        for name, (jmode, kc, kernel) in ((route, STAGED_ROUTES[route]),):
            jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first),
                                        JE.EngineKVCache(jcache.k, jcache.v),
                                        jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                        use_pallas=jmode, staging_chunk=2)
            cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                    torch.from_numpy(np.array(jcache.v)))
            T_ops.reset_counts()
            tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                          torch.full((B,), Tp, dtype=torch.int32), n, c,
                                          pol, kc=kc, staging_chunk=2)
            plain = T_ops.counts("plain_calls")
            per_step = 1 if kernel == "fused_model_w4_chunk" else c.num_layers
            assert plain[kernel] == n * per_step, (name, plain)
            assert plain["staged_append"] == n, (name, plain)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
            rows = slice(Tp, Tp + n)
            equal = all(np.array_equal(t.numpy()[:, :, :, rows], np.asarray(j)[:, :, :, rows])
                        for t, j in ((cache.k, jc.k), (cache.v, jc.v)))
            assert _rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2), name
            _int8_close(cache.k.numpy(), np.asarray(jc.k))
            _int8_close(cache.v.numpy(), np.asarray(jc.v))
    finally:
        _restore(orig)
