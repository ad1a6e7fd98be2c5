"""Gemma's head-dim-256 attention shape through the port's engine routes
(plain versions on the CPU) held against the JAX engine, whose kernels run in
interpret mode: the repair of the W4 prefill's qkv gate (ROADMAP §3, fault 1),
the entry point `Generator.generate_fast`, the B <= 8 decode routes of the
whole-model and whole-layer kernels, and a B = 16 staged chain on the W4
entry config, where neither engine takes its chunk kernel (the chains on
the chunk kernel's hd-256 edition are in tests/test_torch_gemma256_chunk.py).

Model: the gemma_mqa256 pack of tests/test_torch_gemma256_kernels.py (W4A8/h4
and W8A8/h8, calibrated and packed by the JAX package). Tolerances as
tests/test_torch_stablelm_routes.py: greedy tokens equal; logits rel <= 2e-3
with the K/V caches bit-equal on a prefill, and on a decode chain rel <= 2e-3,
or 2e-2 where a written K/V byte differs by a quantization step (XLA's CPU
rsqrt / exp / sin are not correctly rounded), such bytes on at most 0.1% of
the cache.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.ops import pallas_chunk as PC
from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import pallas_prefill_attention as PPA
from mobilequant_tpu.ops import pallas_qkv as PQ
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.generate import Generator as JGenerator
from mobilequant_tpu.runtime.sampling import SamplerConfig

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_gemma256_kernels import built, int8_close, policies, rel


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


def test_gemma_2b_registry_entry_is_the_jax_one():
    assert dataclasses.asdict(get_config("gemma-2b")) == \
        dataclasses.asdict(j_get_config("gemma-2b"))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_w4_prefill_under_prefill_set_matches_jax(strict):
    """Fault 1's witness: a B=1, T=8 W4 prefill under KernelConfig.prefill()
    (the Generator's prefill set) raised NotImplementedError in qkv_rope; it
    now takes the qkv epilogue kernel, as the JAX forward(use_pallas=
    "w4_attn_gatek") does, with its qkv, w13-gate, MLP-block, prefill
    attention and W4 matmul kernels interpreted."""
    b = built(4)
    jpol, pol = policies(b, strict)
    c, L, T_ = b["cfg"], b["cfg"].num_layers, 8
    t = b["tokens"][:1, :T_]
    orig = _interpreted([(PQ, "qkv_rope_stacked"), (PMLP, "w13_gate_stacked"),
                         (PMLP, "fused_mlp_block_w4_stacked"), (PM, "w4a8_matmul_stacked"),
                         (PM, "int_linear_pallas_stacked"), (PPA, "prefill_attention"),
                         (PM, "w4a8_matmul")])
    try:
        ref, jc = JE.forward(b["jpacked"], jnp.asarray(t), b["jcfg"], jpol,
                             use_pallas="w4_attn_gatek", kv_cache=JE.init_kv_cache(b["jecfg"], 1),
                             cache_position=jnp.zeros((1,), jnp.int32),
                             kv_valid_len=jnp.full((1,), T_, jnp.int32))
    finally:
        _restore(orig)
    T_ops.reset_counts()
    out, cache = E.forward(b["packed"], torch.from_numpy(t), c, pol, kc=KernelConfig.prefill(),
                           kv_cache=E.init_kv_cache(b["ecfg"], 1, device="cpu"),
                           cache_position=torch.zeros(1, dtype=torch.int32),
                           kv_valid_len=torch.full((1,), T_, dtype=torch.int32))
    plain = T_ops.counts("plain_calls")
    assert plain["qkv_rope"] == L and plain["prefill_attention"] == L, plain
    assert rel(out.numpy(), ref) <= 2e-3
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("wb", [4, 8], ids=["w4h4", "w8h8"])
def test_gemma256_generate_fast_matches_jax_generator(wb):
    """The slice's entry point at B = 1: the prefill kernels (the qkv
    epilogue kernel at hd 256 on W4, the prefill attention, the MLP block),
    then one whole-model call a token, against the JAX Generator's greedy
    tokens."""
    b = built(wb)
    jpol, pol = policies(b, False)
    c, L = b["cfg"], b["cfg"].num_layers
    prompt = np.random.default_rng(60 + wb).integers(0, c.vocab_size, (1, 12)).astype(np.int32)
    ref = JGenerator(b["jpacked"], b["jcfg"], jpol, b["jecfg"]).generate(
        prompt, 6, SamplerConfig(greedy=True))
    gen = Generator(b["packed"], c, pol, b["ecfg"], device="cpu")
    T_ops.reset_counts()
    np.testing.assert_array_equal(gen.generate_fast(prompt, 6, chunk=3), ref)
    plain = T_ops.counts("plain_calls")
    assert plain["qkv_rope"] == (L if wb == 4 else 0) and plain["prefill_attention"] == L
    assert plain["fused_mlp_block_w4"] == L and plain["fused_model_w4"] == 5, plain


# route -> (the JAX use_pallas, the port's kc, batch, {wrapper: plain calls a step})
# (the per-layer route runs the unfolded head through w4a8_matmul on W4)
B8_ROUTES = {"decode_b3": (True, KernelConfig.decode(), 3, {"fused_model_w4": 1}),
             "per_layer_b1": ("w4nomodelk", KernelConfig.decode_per_layer(), 1,
                              {"fused_layer_w4": 2, "w4a8_matmul": 1})}


@pytest.mark.parametrize("route", list(B8_ROUTES))
def test_gemma256_b8_decode_loop_matches_jax_route(route):
    """decode_loop on the whole-model kernel (B = 3) or the whole-layer kernel
    (B = 1), four steps through the int8 cache from the JAX prefill's cache,
    against the JAX decode_loop on the same route with its layer kernels
    interpreted."""
    b = built(4)
    jpol, pol = policies(b, False)
    c = b["cfg"]
    jmode, kc, B, per_step = B8_ROUTES[route]
    Tp, n = 5, 4
    prompt = np.random.default_rng(70 + B).integers(0, c.vocab_size, (B, Tp)).astype(np.int32)
    orig = _interpreted([(PL, "fused_layer_w4_stacked"), (PL, "fused_model_w4_stacked"),
                         (PM, "int_linear_pallas_stacked"),
                         (PMLP, "fused_mlp_block_w4_stacked"), (PM, "w4a8_matmul")])
    try:
        jcache = JE.init_kv_cache(b["jecfg"], B)
        lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                                kv_valid_len=jnp.full((B,), Tp, jnp.int32))
        first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                torch.from_numpy(np.array(jcache.v)))
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache,
                                    jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                    use_pallas=jmode)
    finally:
        _restore(orig)
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, c, pol, kc=kc)
    plain = T_ops.counts("plain_calls")
    assert {k: v for k, v in plain.items() if v} == {k: n * v for k, v in per_step.items()}
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    rows = slice(Tp, Tp + n)
    equal = all(np.array_equal(t.numpy()[:, :, :, rows], np.asarray(j)[:, :, :, rows])
                for t, j in ((cache.k, jc.k), (cache.v, jc.v)))
    int8_close(cache.k.numpy(), np.asarray(jc.k))
    int8_close(cache.v.numpy(), np.asarray(jc.v))
    assert rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)


def test_gemma256_b16_staged_chain_runs_no_chunk_kernel():
    """A B = 16 staged chain (staging_chunk 2, 4 steps) on the W4 entry
    config (decode_loop kc=None against use_pallas=True): the chunk kernel's
    W8 auto-enable does not cover W4 packs, so both engines run the staged
    MLP-block route: no chunk call, the same greedy tokens and caches as the
    JAX engine (its MLP-block kernel interpreted)."""
    wb = 4
    b = built(wb)
    jpol, pol = policies(b, False)
    c, L = b["cfg"], b["cfg"].num_layers
    B, Tp, n = 16, 5, 4
    jmode, kc = True, None
    toks = np.random.default_rng(80 + wb).integers(0, c.vocab_size, (2, Tp)).astype(np.int32)
    prompt = np.tile(toks, (B // 2, 1))
    orig = _interpreted([(PM, "int_linear_pallas_stacked"), (PM, "w4a8_matmul"),
                         (PMLP, "fused_mlp_block_w4_stacked"), (PC, "fused_model_w4_chunk")])
    try:
        jcache = JE.init_kv_cache(b["jecfg"], B)
        lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                                kv_valid_len=jnp.full((B,), Tp, jnp.int32))
        first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                torch.from_numpy(np.array(jcache.v)))
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache,
                                    jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                    use_pallas=jmode, staging_chunk=2)
    finally:
        _restore(orig)
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, c, pol, kc=kc,
                                  staging_chunk=2)
    plain = T_ops.counts("plain_calls")
    assert plain["fused_model_w4_chunk"] == 0, plain
    assert plain["fused_mlp_block_w4"] == n * L and plain["staged_append"] == n, plain
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    rows = slice(Tp, Tp + n)
    equal = all(np.array_equal(t.numpy()[:, :, :, rows], np.asarray(j)[:, :, :, rows])
                for t, j in ((cache.k, jc.k), (cache.v, jc.v)))
    int8_close(cache.k.numpy(), np.asarray(jc.k))
    int8_close(cache.v.numpy(), np.asarray(jc.v))
    assert rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)
