"""StableLM on the port's integer engine held against the JAX engine: the
plain path (LayerNorm with a bias, rotary on a quarter of each head, a bias
on q/k/v only) and Generator.generate_fast.

Models: test-stablelm (hidden 64, 4 heads of head_dim 16, 2 layers) packed
W8A8 (the JAX bench's per-tensor asymmetric W8) and W4A8 (per-channel
symmetric) with the fp head, for the plain path; the stablelm_mha64_partial
shape of tests/test_torch_stablelm_kernels.py (W4A8/h4, W8A8/h8) for
generate_fast. The JAX model's norm vectors and q/k/v biases are redrawn from
a numpy seed first (redraw_norms_and_biases), so every bias term is
exercised; the JAX package calibrates and packs, the port reads the pack
with convert.from_jax_packed (and packs the same params itself, bit for bit).
Tolerances as tests/test_torch_engine.py: logits rel <= 2e-3 and equal
caches after a prefill; a decode step whose written K/V rows equal the JAX
engine's rel <= 2e-3, a step with a byte one quantization step away (XLA's
CPU rsqrt / exp / sin are not correctly rounded) rel <= 2e-2, such bytes on
at most 0.1% of the cache; greedy tokens equal.
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.generate import Generator as JGenerator
from mobilequant_tpu.runtime.sampling import SamplerConfig

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import build_synthetic_packed, from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.quant.policy import default_policy
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_stablelm_kernels import (
    _int8_close, _rel, built, policies, redraw_norms_and_biases, wcfg)

S_SMALL = 64


@functools.lru_cache(maxsize=2)
def small(wb: int):
    """test-stablelm packed W{wb}A8 with the fp head by the JAX package."""
    jcfg = j_get_config("test-stablelm")
    params = redraw_norms_and_biases(JM.init_params(jcfg, jax.random.PRNGKey(0)), 2)
    jpol = j_default_policy(jcfg, JQC(**wcfg(wb)), JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_SMALL, weight_bits=wb)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-stablelm")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = default_policy(cfg, QuantConfig(**wcfg(wb)), QuantConfig(bitwidth=8))
    return dict(jcfg=jcfg, params=params, ranges=ranges, jpol=jpol, jecfg=jecfg,
                jpacked=jpacked, cfg=cfg, pol=pol,
                ecfg=E.EngineConfig(model=cfg, max_seq_len=S_SMALL),
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


@pytest.mark.parametrize("wb", [8, 4], ids=["w8", "w4"])
def test_port_pack_of_stablelm_is_the_jax_pack(wb):
    b = small(wb)
    mine = E.pack(jax.tree.map(np.asarray, b["params"]), jax.tree.map(np.asarray, b["ranges"]),
                  b["cfg"], b["pol"], b["ecfg"], device="cpu")
    for name in ("qkv_proj", "o_proj", "w13_proj", "w2", "attn_norm", "mlp_norm"):
        for k, v in b["packed"]["layers"][name].items():
            np.testing.assert_array_equal(mine["layers"][name][k].numpy(), v.numpy(),
                                          err_msg=f"{name}.{k}")
    for k in ("w", "b"):
        np.testing.assert_array_equal(mine["norm"][k].numpy(), b["packed"]["norm"][k].numpy())
    assert mine["layers"]["qkv_proj"]["bias"].abs().min() > 0


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("wb", [8, 4], ids=["w8", "w4"])
def test_stablelm_forward_matches_jax(wb, strict):
    """A B=2, T=20 prefill and five decode steps on the plain path against the
    JAX engine's E.forward (use_pallas=False)."""
    b = small(wb)
    jpol, pol = policies(b, strict)
    c = b["cfg"]
    prompt = np.random.default_rng(3 + wb).integers(0, c.vocab_size, (2, 20)).astype(np.int32)
    B, T = prompt.shape
    jl, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                            kv_cache=JE.init_kv_cache(b["jecfg"], B),
                            cache_position=jnp.zeros((B,), jnp.int32),
                            kv_valid_len=jnp.full((B,), T, jnp.int32), use_pallas=False)
    T_ops.reset_counts()
    tl, cache = E.forward(b["packed"], torch.from_numpy(prompt), c, pol,
                          kv_cache=E.init_kv_cache(b["ecfg"], B, device="cpu"),
                          cache_position=torch.zeros(B, dtype=torch.int32),
                          kv_valid_len=torch.full((B,), T, dtype=torch.int32),
                          kc=KernelConfig.none())
    assert _rel(tl.numpy(), jl) < 2e-3
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    np.testing.assert_array_equal(cache.v.numpy(), np.asarray(jcache.v))
    toks = np.random.default_rng(4).integers(0, c.vocab_size, (B, 5)).astype(np.int32)
    for i in range(toks.shape[1]):
        p = T + i
        jl, jcache = JE.forward(b["jpacked"], jnp.asarray(toks[:, i:i + 1]), b["jcfg"], jpol,
                                positions=jnp.full((B, 1), p, jnp.int32), kv_cache=jcache,
                                cache_position=jnp.full((B,), p, jnp.int32),
                                kv_valid_len=jnp.full((B,), p + 1, jnp.int32),
                                use_pallas=False)
        pos = torch.full((B,), p, dtype=torch.int32)
        tl, cache = E.forward(b["packed"], torch.from_numpy(toks[:, i:i + 1]), c, pol,
                              positions=pos[:, None], kv_cache=cache, cache_position=pos,
                              kv_valid_len=pos + 1, kc=KernelConfig.none())
        rows_equal = all(np.array_equal(x.numpy()[:, :, :, p], np.asarray(j)[:, :, :, p])
                         for x, j in ((cache.k, jcache.k), (cache.v, jcache.v)))
        assert _rel(tl.numpy(), jl) < (2e-3 if rows_equal else 2e-2), i
    _int8_close(cache.k.numpy(), np.asarray(jcache.k))
    _int8_close(cache.v.numpy(), np.asarray(jcache.v))
    assert not any(T_ops.counts("plain_calls").values())


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4h4", "w8h8"])
def test_stablelm_generate_fast_matches_jax_generator(wb, B):
    """The slice's entry point on the stablelm_mha64_partial shape: the
    prefill kernels (the qkv epilogue kernel with partial rotary and the q/k/v
    bias on W4; the MLP block at <= 64 rows, the w13+gate kernel above), then
    one whole-model call a token at B=1 and one chunk call a step at B=16 on
    W8 (the entry config's W8 chunk gate; W4 takes the staged route with the
    MLP-block kernel), against the JAX Generator's greedy tokens."""
    b = built(wb)
    jpol, pol = policies(b, False)
    c, L = b["cfg"], b["cfg"].num_layers
    prompt = np.random.default_rng(50 + B + wb).integers(0, c.vocab_size, (B, 12)).astype(np.int32)
    ref = JGenerator(b["jpacked"], b["jcfg"], jpol, b["jecfg"]).generate(
        prompt, 6, SamplerConfig(greedy=True))
    gen = Generator(b["packed"], c, pol, b["ecfg"], device="cpu")
    T_ops.reset_counts()
    np.testing.assert_array_equal(gen.generate_fast(prompt, 6, chunk=3), ref)
    plain = T_ops.counts("plain_calls")
    assert plain["qkv_rope"] == (L if wb == 4 else 0) and plain["prefill_attention"] == L
    if B == 1:
        assert plain["fused_mlp_block_w4"] == L and plain["fused_model_w4"] == 5
    elif wb == 8:
        assert plain["w13_gate"] == L and plain["fused_model_w4_chunk"] == 5
    else:
        assert plain["w13_gate"] == L and plain["fused_mlp_block_w4"] == 5 * L
        assert plain["staged_append"] == 5


def test_synthetic_stablelm_pack_draws_norms_and_biases_apart():
    """convert.build_synthetic_packed on StableLM: LayerNorm weights near 1,
    biases near 0 and a nonzero q/k/v bias, drawn from a second generator, so
    that a RMSNorm model's pack from the same seed keeps its bits."""
    packed, cfg, policy, ecfg = build_synthetic_packed("test-stablelm", w_bits=8, head_bits=8,
                                                       max_seq_len=32, device="cpu")
    ly = packed["layers"]
    for norm in (ly["attn_norm"], ly["mlp_norm"], packed["norm"]):
        assert 0 < (norm["w"] - 1).abs().max() < 0.5 and 0 < norm["b"].abs().max() < 0.2
    assert ly["qkv_proj"]["bias"].abs().min() > 0
    assert not ly["o_proj"]["bias"].any() and not ly["w2"]["bias"].any()
    # a RMSNorm model's packs: the bits build_synthetic_packed gave before these draws
    for wb, want in ((4, "6219e12d20037d2a"), (8, "febd3ef850c2365e")):
        p, _, _, _ = build_synthetic_packed("test-llama-256", w_bits=wb, head_bits=wb,
                                            max_seq_len=32, device="cpu")
        assert not p["layers"]["qkv_proj"]["bias"].any()
        assert bool((p["layers"]["attn_norm"]["w"] == 1).all())
        assert _digest(p) == want, wb


def _digest(packed: dict) -> str:
    """sha256 (16 hex digits) of every tensor of a packed model, keys sorted."""
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, dict):
            for k in sorted(v):
                if k != "ranges":
                    walk(v[k])
        elif isinstance(v, torch.Tensor):
            h.update(v.contiguous().numpy().tobytes())
    walk(packed)
    return h.hexdigest()[:16]
