"""The port's whole-model decode kernel (plain version on the CPU) held
against the JAX package's fused_model_w4_stacked in interpret mode, and the
port's decode routes against the JAX engine's over a decode chain.

Same model and tolerances as tests/test_torch_fused.py; logits are held to
rel <= 2e-3 (the engine<->sim tolerance of tests/test_engine.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch.ops.fused_layer import fused_layer_w4, fused_model_w4
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_fused import S_MAX, _built, _int8_close, _jlr, _policies, _rope_cs


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("B", [1, 4])
def test_fused_model_plain_matches_pallas(B, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd = c.num_layers, c.num_kv_heads, c.head_dim_
    rng = np.random.default_rng(B + 2 * strict)
    x = rng.normal(size=(B, 256)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([4, 3, 2, 4][:B], np.int32)
    cs = _rope_cs(b, pos, c.rotary_dim)
    jmeta = jnp.stack([JE._layer_meta(_jlr(b, l), jpol, b["jcfg"]) for l in range(L)])
    rx, rkv, rlg = PL.fused_model_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"]),
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), jmeta, b["jpacked"]["head_q"],
        b["jpacked"]["norm"]["w"], b["jpacked"]["norm"]["b"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_model_w4.plain_calls
    ox, okv, olg = fused_model_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"],
        b["packed"]["head_q"], b["packed"]["norm"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim)
    assert fused_model_w4.plain_calls == before + 1
    assert okv.shape == (L, B, 2 * Hkv, hd) and olg.shape == tuple(rlg.shape)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    _int8_close(okv.numpy(), np.asarray(rkv))
    assert _rel(olg.numpy(), rlg) <= 2e-3


def test_decode_chain_matches_jax_kernel_routes():
    """Three T=1 steps through the int8 cache: the port's decode() (one
    whole-model call a step) against the JAX engine's use_pallas=True, and
    decode_per_layer() (one whole-layer call per layer) against "w4nomodelk",
    the JAX kernels in interpret mode. XLA's CPU rsqrt / exp / sin are not
    correctly rounded, so a written K/V byte may sit one quantization step
    away: steps whose rows are equal are held to rel <= 2e-3, a step with
    such a byte to rel <= 2e-2 (test_torch_engine.test_decode_steps_match_jax
    measures one step of a self-term K byte at about 1% of these logits)."""
    b = _built()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    L = c.num_layers
    toks = np.random.default_rng(5).integers(0, c.vocab_size, (1, 8)).astype(np.int32)
    Tp = 5
    orig = (PL.fused_layer_w4_stacked, PL.fused_model_w4_stacked,
            PM.int_linear_pallas_stacked, PMLP.fused_mlp_block_w4_stacked, PM.w4a8_matmul)
    jcalls = {"layer": 0, "model": 0}

    def counted(fn, key):
        def run(*a, **k):
            jcalls[key] += 1
            return fn(*a, interpret=True, **k)
        return run

    PL.fused_layer_w4_stacked = counted(orig[0], "layer")
    PL.fused_model_w4_stacked = counted(orig[1], "model")
    PM.int_linear_pallas_stacked = functools.partial(orig[2], interpret=True)
    PMLP.fused_mlp_block_w4_stacked = functools.partial(orig[3], interpret=True)
    PM.w4a8_matmul = functools.partial(orig[4], interpret=True)
    try:
        routes = (("decode", True, KernelConfig.decode()),
                  ("per_layer", "w4nomodelk", KernelConfig.decode_per_layer()))
        jcache = JE.init_kv_cache(b["jecfg"], 1)
        _, jcache = JE.forward(b["jpacked"], jnp.asarray(toks[:, :Tp]), b["jcfg"], jpol,
                               kv_cache=jcache, cache_position=jnp.zeros((1,), jnp.int32))
        # both sides decode from the JAX prefill's cache (a prefill byte may
        # differ by one step across frameworks; the decode routes are the point)
        caches = {name: E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                        torch.from_numpy(np.array(jcache.v)))
                  for name, _, _ in routes}
        jcaches = {name: jcache for name, _, _ in routes}
        calls = (fused_model_w4.plain_calls, fused_layer_w4.plain_calls)
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
        # the JAX layer kernel is traced once per step inside its layer scan
        assert jcalls == {"layer": 3, "model": 3}
        assert fused_model_w4.plain_calls == calls[0] + 3
        assert fused_layer_w4.plain_calls == calls[1] + 3 * L
        for name, _, _ in routes:
            _int8_close(caches[name].k.numpy(), np.asarray(jcaches[name].k))
            _int8_close(caches[name].v.numpy(), np.asarray(jcaches[name].v))
    finally:
        (PL.fused_layer_w4_stacked, PL.fused_model_w4_stacked, PM.int_linear_pallas_stacked,
         PMLP.fused_mlp_block_w4_stacked, PM.w4a8_matmul) = orig
        jax.clear_caches()
