"""The port's engine held against the JAX engine on the CPU.

A calibrated W4A8 test-llama at the kernels' narrowest widths (hidden 256,
head_dim 64, 4 q / 2 kv heads, F 512, 2 layers) is packed by the JAX package;
the port reads that pack (convert.from_jax_packed) and also packs the same
params itself. The JAX side runs its XLA engine (use_pallas=False), the port
its kernel configurations, whose wrappers run the plain versions on the CPU.
Logits agree to the engine<->sim tolerance of tests/test_engine.py
(rel <= 2e-3); the int8 KV caches a prefill writes must be equal (decode
steps: see test_decode_steps_match_jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.generate import Generator as JGenerator
from mobilequant_tpu.runtime.sampling import SamplerConfig

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

S_MAX = 64


def _jcfg():
    return dataclasses.replace(j_get_config("test-llama"), hidden_size=256,
                               intermediate_size=512, num_heads=4, num_kv_heads=2,
                               head_dim=64, num_layers=2)


def _build(head_bits):
    jcfg = _jcfg()
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    wq = JQC(bitwidth=4, is_per_channel=True, is_symmetric=True)
    jpol = j_default_policy(jcfg, wq, JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=4, head_bits=head_bits)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-llama-256")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = default_policy(cfg, QuantConfig(bitwidth=4, is_per_channel=True, is_symmetric=True),
                         QuantConfig(bitwidth=8))
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=head_bits)
    return dict(jcfg=jcfg, params=params, ranges=ranges, jpol=jpol, jecfg=jecfg,
                jpacked=jpacked, cfg=cfg, pol=pol, ecfg=ecfg,
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


@pytest.fixture(scope="module", params=[4, 16], ids=["head4", "head16"])
def built(request):
    return _build(request.param)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _prompt(T=37, B=2):
    return np.random.default_rng(1).integers(0, 256, (B, T)).astype(np.int32)


def _jax_prefill(b, pol, prompt):
    B, T = prompt.shape
    cache = JE.init_kv_cache(b["jecfg"], B)
    return JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], pol,
                      positions=jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                      kv_cache=cache, cache_position=jnp.zeros((B,), jnp.int32),
                      kv_valid_len=jnp.full((B,), T, jnp.int32), use_pallas=False,
                      logits_at=jnp.full((B,), T - 1, jnp.int32))


def _port_prefill(b, pol, prompt, kc):
    B, T = prompt.shape
    cache = E.init_kv_cache(b["ecfg"], B, device="cpu")
    return E.forward(b["packed"], torch.from_numpy(prompt), b["cfg"], pol,
                     kv_cache=cache, cache_position=torch.zeros(B, dtype=torch.int32),
                     kv_valid_len=torch.full((B,), T, dtype=torch.int32), kc=kc,
                     logits_at=torch.full((B,), T - 1, dtype=torch.int32))


def test_port_pack_bit_exact_with_jax(built):
    b = built
    mine = E.pack(jax.tree.map(np.asarray, b["params"]), jax.tree.map(np.asarray, b["ranges"]),
                  b["cfg"], b["pol"], b["ecfg"], device="cpu")
    ref = b["packed"]
    for name in ("qkv_proj", "o_proj", "w13_proj", "w2", "attn_norm", "mlp_norm"):
        for k, v in ref["layers"][name].items():
            np.testing.assert_array_equal(mine["layers"][name][k].numpy(), v.numpy(),
                                          err_msg=f"{name}.{k}")
    for k in ("head_q", "lm_head", "norm"):
        if k in ref:
            for kk, v in ref[k].items():
                np.testing.assert_array_equal(mine[k][kk].numpy(), v.numpy(), err_msg=k)
    np.testing.assert_array_equal(mine["embed"].numpy(), ref["embed"].numpy())


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_prefill_forward_matches_jax(built, strict):
    b = built
    jpol = b["jpol"] if strict else j_relax(b["jpol"])
    pol = b["pol"] if strict else relax_16bit(b["pol"])
    prompt = _prompt()
    ref, jcache = _jax_prefill(b, jpol, prompt)
    for kc in (KernelConfig.prefill(), KernelConfig.none()):
        out, cache = _port_prefill(b, pol, prompt, kc)
        assert out.shape == tuple(ref.shape)
        assert _rel(out.numpy(), ref) < 2e-3, kc
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
        np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))


def test_decode_steps_match_jax(built):
    """T=1 decode-light steps through the int8 cache. XLA's CPU rsqrt, exp and
    sin/cos are not correctly rounded (on random fp32 inputs a third of the
    rsqrt and a tenth of the exp results differ from PyTorch's by an ulp), so
    now and then a value sits on a rounding boundary and a written K/V byte
    differs by one quantization step. Steps whose written rows equal the JAX
    engine's are held to rel <= 2e-3; a step with such a byte (at most 0.1%
    of the cache, counted) to the effect of that one step: one quantization
    step of a self-term K byte moves this 2-layer random model's logits by
    about 1% (0.7% and 1.03% measured on these inputs), so rel <= 2e-2."""
    b = built
    jpol, pol = j_relax(b["jpol"]), relax_16bit(b["pol"])
    prompt = _prompt(T=20)
    B, T = prompt.shape
    _, jcache = _jax_prefill(b, jpol, prompt)
    _, cache = _port_prefill(b, pol, prompt, KernelConfig.prefill())
    toks = np.random.default_rng(2).integers(0, 256, (B, 5)).astype(np.int32)
    for i in range(toks.shape[1]):
        p = T + i
        jl, jcache = JE.forward(b["jpacked"], jnp.asarray(toks[:, i:i + 1]), b["jcfg"], jpol,
                                positions=jnp.full((B, 1), p, jnp.int32), kv_cache=jcache,
                                cache_position=jnp.full((B,), p, jnp.int32),
                                kv_valid_len=jnp.full((B,), p + 1, jnp.int32))
        pos = torch.full((B,), p, dtype=torch.int32)
        tl, cache = E.forward(b["packed"], torch.from_numpy(toks[:, i:i + 1]), b["cfg"], pol,
                              positions=pos[:, None], kv_cache=cache, cache_position=pos,
                              kv_valid_len=pos + 1, kc=KernelConfig.decode())
        rows_equal = all(np.array_equal(c.numpy()[:, :, :, p], np.asarray(jc)[:, :, :, p])
                         for c, jc in ((cache.k, jcache.k), (cache.v, jcache.v)))
        assert _rel(tl.numpy(), jl) < (2e-3 if rows_equal else 2e-2), i
    for c, jc in ((cache.k, jcache.k), (cache.v, jcache.v)):
        d = np.abs(c.numpy().astype(np.int32) - np.asarray(jc).astype(np.int32))
        assert d.max() <= 1 and (d > 0).sum() <= 1e-3 * d.size


def test_generate_fast_matches_jax_generator(built):
    b = built
    jpol, pol = j_relax(b["jpol"]), relax_16bit(b["pol"])
    prompt = _prompt(T=12, B=1)
    ref = JGenerator(b["jpacked"], b["jcfg"], jpol, b["jecfg"]).generate(
        prompt, 10, SamplerConfig(greedy=True))
    gen = Generator(b["packed"], b["cfg"], pol, b["ecfg"], device="cpu")
    np.testing.assert_array_equal(gen.generate_fast(prompt, 10, chunk=4), ref)
    np.testing.assert_array_equal(gen.generate(prompt, 10), ref)


def test_slice_reaches_every_kernel_plain_version(built):
    """Each route reaches its kernels: a <= 64-row prefill takes the MLP-block
    kernel in every layer, a longer one the split w13+gate path; a decode step
    at B <= 8 is one whole-model call (with the W4 head folded), and
    KernelConfig.decode_per_layer() one whole-layer call per layer."""
    b = built
    gen = Generator(b["packed"], b["cfg"], relax_16bit(b["pol"]), b["ecfg"], device="cpu")
    L = b["cfg"].num_layers
    head = 1 if "head_q" in b["packed"] else 0
    T_ops.reset_counts()
    gen.generate_fast(_prompt(T=10, B=1), 3)
    plain = T_ops.counts("plain_calls")
    assert plain["qkv_rope"] == L and plain["prefill_attention"] == L
    assert plain["fused_mlp_block_w4"] == L and plain["w13_gate"] == 0
    # prefill: o per layer (+ the W4 head); the 2 decode steps: one whole-model
    # call each, nothing else
    assert plain["w4a8_matmul_stacked"] == L and plain["w4a8_matmul"] == head
    assert plain["fused_model_w4"] == 2 and plain["fused_layer_w4"] == 0
    T_ops.reset_counts()
    gen.prefill(torch.from_numpy(_prompt(T=40, B=2)), E.init_kv_cache(b["ecfg"], 2, device="cpu"))
    plain = T_ops.counts("plain_calls")
    assert plain["w13_gate"] == L and plain["fused_mlp_block_w4"] == 0
    assert plain["w4a8_matmul_stacked"] == 2 * L           # o and w2
    assert plain["w4a8_matmul"] == head                    # the head
    T_ops.reset_counts()
    gen = Generator(b["packed"], b["cfg"], relax_16bit(b["pol"]),
                    dataclasses.replace(b["ecfg"], use_pallas=KernelConfig.decode_per_layer()),
                    device="cpu")
    gen.generate_fast(_prompt(T=10, B=1), 3)
    plain = T_ops.counts("plain_calls")
    assert plain["fused_layer_w4"] == 2 * L and plain["fused_model_w4"] == 0
    assert plain["w4a8_matmul_stacked"] == L
    assert plain["w4a8_matmul"] == 3 * head                 # + the unfolded head
    assert all(v == 0 for v in T_ops.counts().values())


def test_temperature_sampling_is_seeded(built):
    b = built
    gen = Generator(b["packed"], b["cfg"], relax_16bit(b["pol"]), b["ecfg"], device="cpu")
    prompt = _prompt(T=8, B=2)
    a = gen.generate_fast(prompt, 6, temperature=1.0, seed=3, chunk=2)
    c = gen.generate_fast(prompt, 6, temperature=1.0, seed=3, chunk=4)
    assert a.shape == (2, 6) and np.array_equal(a, c)
