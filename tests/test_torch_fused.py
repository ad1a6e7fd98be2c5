"""The port's whole-MLP-block and whole-layer kernels (plain versions on the
CPU) held against the JAX package's Pallas kernels in interpret mode.

The model is the llama_gqa64 shape of tests/test_kernels.py (hidden 256, 8 q /
4 kv heads, head_dim 64, F 512, 2 layers, max_seq_len 128), calibrated and
packed W4A8 by the JAX package; the port reads that pack with
convert.from_jax_packed. The JAX whole-layer kernel is fed its own
TPU-permuted qkvp / op packs, the port the canonical qkv_proj / o_proj ones;
both return canonical outputs. Inputs come from numpy seeds. Float outputs
agree to fp32 rounding (the integer dots are exact; only the order of fp32
sums differs), rtol = atol = 2e-4; int8 K/V rows may differ by one
quantization step on at most 0.1% of the bytes, where exp, rsqrt or a sum
order moves a value across a rounding boundary.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops.fused_layer import fused_layer_w4, layer_kernel_supported
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E

S_MAX = 128


def _int8_close(a, b, max_frac=1e-3):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1, f"max int8 difference {d.max()}"
    assert (d > 0).sum() <= max_frac * d.size, f"{(d > 0).sum()} of {d.size} differ"


@functools.lru_cache(maxsize=1)
def _built():
    jcfg = dataclasses.replace(j_get_config("test-llama"), hidden_size=256,
                               intermediate_size=512, num_heads=8, num_kv_heads=4,
                               head_dim=64, num_layers=2)
    assert PL.layer_kernel_supported(jcfg, S_MAX)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpol = j_default_policy(jcfg, JQC(bitwidth=4, is_per_channel=True, is_symmetric=True),
                            JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=4, head_bits=4)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    assert "qkvp" in jpacked["layers"]
    cfg = get_config("test-llama-256").replace(num_heads=8, num_kv_heads=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert layer_kernel_supported(cfg, S_MAX)
    pol = default_policy(cfg, QuantConfig(bitwidth=4, is_per_channel=True, is_symmetric=True),
                         QuantConfig(bitwidth=8))
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, cfg=cfg, pol=pol, jecfg=jecfg,
                params=params, ranges=ranges,
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


def _policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def _jlr(b, l):
    return jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"])


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_layer_meta_equals_jax(strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    for l in range(b["cfg"].num_layers):
        ref = np.asarray(JE._layer_meta(_jlr(b, l), jpol, b["jcfg"]))
        mine = np.asarray(E._layer_meta(E.layer_ranges(b["packed"]["ranges"], l), pol,
                                        b["cfg"]), np.float32)
        assert ref.dtype == np.float32 and ref.shape == (65,)
        np.testing.assert_array_equal(mine, ref)
        prep = E._kernel_prep(b["packed"], pol, b["cfg"])
        np.testing.assert_array_equal(prep["meta"][l].numpy(), ref)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("M_", [1, 8, 48])
def test_fused_mlp_block_plain_matches_pallas(M_, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    l = 1
    jly, ly = b["jpacked"]["layers"], b["packed"]["layers"]
    x = np.random.default_rng(M_ + 10 * strict).normal(size=(M_, 256)).astype(np.float32)
    jmeta = JE._mlp_block_meta(_jlr(b, l), jpol, b["jcfg"])
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, b["cfg"])
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    site_on = E._mlp_block_site_on(pol)
    assert site_on == JE._mlp_block_site_on(jpol)
    ref = PMLP.fused_mlp_block_w4_stacked(
        jnp.asarray(x), jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"],
        jly["w2"], jmeta, l, "silu", "rmsnorm", site_on=site_on, interpret=True)
    before = fused_mlp_block_w4.plain_calls
    out = fused_mlp_block_w4(torch.from_numpy(x), ly["mlp_norm"]["w"], ly["mlp_norm"]["b"],
                             ly["w13_proj"], ly["w2"], meta, l, "silu", site_on)
    assert fused_mlp_block_w4.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def _rope_cs(b, pos, rot):
    cos, sin = JM.rope_cos_sin(jnp.asarray(pos)[:, None], b["jcfg"], jnp.float32)
    return np.array(JE._rope_cs_vec(cos, sin, b["jcfg"].head_dim_, rot))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("rot", [64, 16], ids=["full_rotary", "partial_rotary"])
def test_fused_layer_plain_matches_pallas(rot, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd = c.num_layers, c.num_kv_heads, c.head_dim_
    rng = np.random.default_rng(rot + strict)
    x = rng.normal(size=(1, 256)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([37], np.int32)
    cs = _rope_cs(b, pos, rot)
    l = 1
    jofq = JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"])[l]
    jmeta = JE._layer_meta(_jlr(b, l), jpol, b["jcfg"])
    rx, rkv = PL.fused_layer_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs[0]), jofq,
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), jmeta, l, num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=rot, interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_layer_w4.plain_calls
    ox, okv = fused_layer_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"], l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=rot)
    assert fused_layer_w4.plain_calls == before + 1
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    assert okv.shape == (2 * Hkv, hd)
    _int8_close(okv.numpy(), np.asarray(rkv))
