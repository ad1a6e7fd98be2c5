"""The port's int8-KV decode attention kernel (plain version on the CPU) and
the T = 1 attn_kernel route (KernelConfig.attn()) held against the JAX
package: pallas_attention.decode_attention in interpret mode, and the JAX
engine's decode_loop(use_pallas="attn").

Model: the llama_gqa64 pack of tests/test_torch_fused.py. Tolerances: the
kernel's plain version (fp64 sums) against the JAX kernel rtol = atol = 2e-4;
the decode chain: tokens equal, caches within one quantization step on at
most 0.1% of the bytes, the last logits rel <= 2e-3 (2e-2 where a written
byte differs by a step: XLA's CPU rsqrt / exp / sin are not correctly
rounded).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.ops import pallas_attention as PA
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.ops.decode_attention import decode_attention
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_fused import S_MAX, _built, _int8_close, _jlr, _policies
from test_torch_staged import _jax_interpret, _rel


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("valid", [[1, 40, 128], [7, 64, 65]], ids=["short_full", "mid"])
def test_decode_attention_plain_matches_pallas(valid, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c = b["cfg"]
    Hkv, hd, G, B, l = c.num_kv_heads, c.head_dim_, c.num_heads // c.num_kv_heads, 3, 1
    rng = np.random.default_rng(sum(valid) + strict)
    q8 = rng.integers(-128, 128, (B, Hkv, G, hd)).astype(np.int8)
    k8 = rng.integers(-128, 128, (B, Hkv, S_MAX, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (B, Hkv, S_MAX, hd)).astype(np.int8)
    vl = np.asarray(valid, np.int32)
    jmeta = JE._attn_meta(_jlr(b, l), jpol, b["jcfg"])
    meta = E._attn_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c)
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    assert (meta[8] > 0.5) == (meta[11] > 0.5) == strict
    ref = PA.decode_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jmeta,
                              jnp.asarray(vl), interpret=True)
    before = decode_attention.plain_calls
    out = decode_attention(torch.from_numpy(q8), torch.from_numpy(k8), torch.from_numpy(v8),
                           meta, torch.from_numpy(vl))
    assert decode_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_attn_decode_chain_matches_jax():
    """A B = 2 decode chain on the attn() route (each T = 1 step writes its row
    into the cache, then one decode attention launch per layer) against the
    JAX engine's decode_loop(use_pallas="attn"), from the same prefill cache."""
    b = _built()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    L, B, Tp, n = c.num_layers, 2, 5, 4
    prompt = np.random.default_rng(11).integers(0, c.vocab_size, (B, Tp)).astype(np.int32)
    orig = _jax_interpret([(PM, "int_linear_pallas_stacked"), (PM, "w4a8_matmul"),
                           (PMLP, "fused_mlp_block_w4_stacked"), (PA, "decode_attention")])
    try:
        jcache = JE.init_kv_cache(b["jecfg"], B)
        lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                                kv_valid_len=jnp.full((B,), Tp, jnp.int32))
        first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        start = np.asarray([Tp, Tp + 2], np.int32)
        cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                torch.from_numpy(np.array(jcache.v)))
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache,
                                    jnp.asarray(start), n, b["jcfg"], jpol, use_pallas="attn")
        T_ops.reset_counts()
        tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                      torch.from_numpy(start), n, c, pol, kc=KernelConfig.attn())
        calls = T_ops.counts("plain_calls")
    finally:
        for mod, attr, fn in orig:
            setattr(mod, attr, fn)
        jax.clear_caches()
    assert calls["decode_attention"] == n * L and calls["staged_append"] == 0, calls
    assert calls["fused_model_w4"] == calls["fused_layer_w4"] == 0, calls
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    equal = all(np.array_equal(t.numpy(), np.asarray(j)) for t, j in ((cache.k, jc.k),
                                                                     (cache.v, jc.v)))
    assert _rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)
    _int8_close(cache.k.numpy(), np.asarray(jc.k))
    _int8_close(cache.v.numpy(), np.asarray(jc.v))
