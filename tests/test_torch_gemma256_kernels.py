"""The head-dim-256 editions of the port's kernels (plain versions on the
CPU) held against the JAX package's Pallas kernels in interpret mode, on
Gemma's attention shape: rows 3 (qkv_rope), 4 (prefill_attention, relaxed
and strict), 15 (decode_attention), 6 (fused_model_w4, with the folded head)
and 7 (fused_layer_w4).

Model: the gemma_mqa256 shape (test-gemma at hidden 512, F 1024, 8 q heads
over one kv head of head_dim 256, full rotary, 2 layers, max_seq_len 128:
RMSNorm on (1 + w), gelu_tanh, the embedding scaled by sqrt(hidden), the head
tied to the embedding), calibrated and packed by the JAX package W4A8 (per-
channel symmetric) with a W4 head (h4), or W8A8 (per-channel asymmetric) with
a W8 head (h8), as tests/test_torch_gemma_routes.py builds its pack; the port
reads each pack with convert.from_jax_packed. Tolerances are those of the
head-dim-64 editions' tests (tests/test_torch_kernels.py,
test_torch_decode_attention.py, test_torch_stablelm_kernels.py): int8
outputs bit-exact (qkv_rope), or within one quantization step on at most 0.1%
of the bytes where an exp / rsqrt of the step moves a value across a rounding
boundary (the K/V rows of rows 6 / 7); fp32 outputs rtol = atol = 1e-4
(prefill attention) or 2e-4 (decode attention, layer outputs); logits rel
<= 2e-3.
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
from mobilequant_tpu.ops import pallas_attention as PA
from mobilequant_tpu.ops import pallas_chunk as PC
from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_prefill_attention as PP
from mobilequant_tpu.ops import pallas_qkv as PQ
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops.chunk_model import chunk_kernel_supported
from mobilequant_tpu_torch.ops.decode_attention import decode_attention
from mobilequant_tpu_torch.ops.fused_layer import (
    fused_layer_w4, fused_model_w4, layer_kernel_supported)
from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention
from mobilequant_tpu_torch.ops.qkv_rope import (
    pick_block_tn, qkv_rope, qkv_rope_kernel_takes, qkv_rope_supported)
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E

S_MAX = 128
SHAPE = dict(hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=1,
             head_dim=256, num_layers=2)


def wcfg(wb: int) -> dict:
    """W4: per-channel symmetric; W8: per-channel asymmetric."""
    return dict(bitwidth=wb, is_per_channel=True, is_symmetric=wb == 4)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def int8_close(a, b, max_frac=1e-3):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert d.max() <= 1, f"max int8 difference {d.max()}"
    assert (d > 0).sum() <= max_frac * d.size, f"{(d > 0).sum()} of {d.size} differ"


@functools.lru_cache(maxsize=2)
def built(wb: int = 4):
    """Gemma at the gemma_mqa256 shape, packed W4A8/h4 (wb 4) or W8A8/h8 (wb
    8) by the JAX package and read by the port."""
    jcfg = dataclasses.replace(j_get_config("test-gemma"), **SHAPE)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpol = j_default_policy(jcfg, JQC(**wcfg(wb)), JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=wb, head_bits=wb)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-gemma").replace(**SHAPE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.tie_word_embeddings and cfg.normalize_embed and cfg.rotary_dim == 256
    pol = default_policy(cfg, QuantConfig(**wcfg(wb)), QuantConfig(bitwidth=8))
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=wb)
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, jecfg=jecfg, cfg=cfg, pol=pol,
                ecfg=ecfg, tokens=tokens,
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


def policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def jlr(b, l):
    return jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"])


def rope_cs(b, pos):
    cos, sin = JM.rope_cos_sin(jnp.asarray(pos)[:, None], b["jcfg"], jnp.float32)
    return np.array(JE._rope_cs_vec(cos, sin, b["jcfg"].head_dim_, b["jcfg"].rotary_dim))


def jmeta_L(b, jpol):
    return jnp.stack([JE._layer_meta(jlr(b, l), jpol, b["jcfg"])
                      for l in range(b["cfg"].num_layers)])


@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_gates_take_the_shape_as_the_jax_engine(wb):
    """Fault 1: the qkv epilogue gate is the JAX one (hd 256 passes, where
    the port's old 128 % hd rule refused it); the whole-layer gate takes hd
    256 as the JAX one does, and so does the chunk gate (the chunk kernel's
    hd-256 edition)."""
    b = built(wb)
    c, jc = b["cfg"], b["jcfg"]
    wq = b["packed"]["layers"]["qkv_proj"]["wq"]
    _, K2w, Nq = wq.shape
    assert qkv_rope_supported(Nq, c.head_dim_, c.rotary_dim, K2w) == \
        PQ.qkv_kernel_supported(jc, Nq, K2w) is True
    for k2w, nq, hd in ((1024, 2560, 256), (256, 1536, 64), (4096, 1536, 64), (256, 640, 128),
                        (256, 384, 256), (1 << 22, 2560, 256)):
        assert pick_block_tn(k2w, nq, hd) == PQ._pick_block_tn(k2w, nq, hd)
    assert qkv_rope_kernel_takes(256, 256) and not qkv_rope_kernel_takes(256, 128)
    assert layer_kernel_supported(c, S_MAX) and PL.layer_kernel_supported(jc, S_MAX)
    assert PC.chunk_kernel_supported(jc, S_MAX, 16) and chunk_kernel_supported(c, S_MAX, 16)


@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_qkv_rope_hd256_plain_matches_pallas(wb):
    """Row 3 at hd 256: Nq = 10 heads of 256, full rotary."""
    b = built(wb)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    pol = relax_16bit(b["pol"])
    l, M_, hd = 1, 24, c.head_dim_
    h8 = np.random.default_rng(3 + wb).integers(-128, 128, (M_, c.hidden_size)).astype(np.int8)
    ofq = E._qkv_ofq_rows(b["packed"], pol)[l].numpy()
    outq = E._qkv_outq_rows(b["packed"]["ranges"], c, c.num_layers, "cpu")[l].numpy()
    cs = rope_cs(b, np.arange(M_)).reshape(M_, 2 * hd)
    hr = E.layer_ranges(b["packed"]["ranges"], l)["input_layernorm"]["output"]
    ref = PQ.qkv_rope_stacked(jnp.asarray(h8), jly["qkv_proj"], jnp.asarray(ofq),
                              jnp.asarray(outq), jnp.asarray(cs),
                              jnp.asarray([hr["scale"], hr["offset"]], jnp.float32), l,
                              head_dim=hd, rotary_dim=c.rotary_dim, interpret=True)
    before = qkv_rope.plain_calls
    out = qkv_rope(torch.from_numpy(h8), ly["qkv_proj"], torch.from_numpy(ofq),
                   torch.from_numpy(outq), torch.from_numpy(cs), hr["scale"], hr["offset"],
                   l, hd, c.rotary_dim)
    assert qkv_rope.plain_calls == before + 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_prefill_attention_hd256_plain_matches_pallas(strict):
    """Row 4 at hd 256, G 8, on the layer's attention meta: T = 20 query
    positions into a 48-row cache, a valid length below T on sequence 0."""
    b = built(4)
    jpol, pol = policies(b, strict)
    c, l = b["cfg"], 1
    B, Hkv, G, T_, S, hd = 2, 1, 8, 20, 48, c.head_dim_
    rng = np.random.default_rng(11 + strict)
    q8 = rng.integers(-128, 128, (B, Hkv, G, T_, hd)).astype(np.int8)
    k8 = rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8)
    jmeta = JE._attn_meta(jlr(b, l), jpol, b["jcfg"])
    meta = E._attn_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c)
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    positions = np.stack([np.arange(T_), np.arange(T_) + 9]).astype(np.int32)
    valid = np.asarray([T_ - 4, T_ + 9], np.int32)
    ref = PP.prefill_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jmeta,
                               jnp.asarray(positions), jnp.asarray(valid), qk_fq=strict,
                               pv_fq=strict, interpret=True)
    before = prefill_attention.plain_calls
    out = prefill_attention(torch.from_numpy(q8), torch.from_numpy(k8), torch.from_numpy(v8),
                            meta, torch.from_numpy(positions), torch.from_numpy(valid),
                            qk_fq=strict, pv_fq=strict)
    assert prefill_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("valid", [[1, 40, 128], [7, 64, 65]], ids=["short_full", "mid"])
def test_decode_attention_hd256_plain_matches_pallas(valid, strict):
    """Row 15 at hd 256, G 8, one kv head."""
    b = built(4)
    jpol, pol = policies(b, strict)
    c, l = b["cfg"], 1
    Hkv, hd, G, B = c.num_kv_heads, c.head_dim_, c.num_heads // c.num_kv_heads, 3
    rng = np.random.default_rng(sum(valid) + strict)
    q8 = rng.integers(-128, 128, (B, Hkv, G, hd)).astype(np.int8)
    k8 = rng.integers(-128, 128, (B, Hkv, S_MAX, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (B, Hkv, S_MAX, hd)).astype(np.int8)
    vl = np.asarray(valid, np.int32)
    jmeta = JE._attn_meta(jlr(b, l), jpol, b["jcfg"])
    meta = E._attn_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c)
    assert (meta[8] > 0.5) == (meta[11] > 0.5) == strict
    ref = PA.decode_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jmeta,
                              jnp.asarray(vl), interpret=True)
    before = decode_attention.plain_calls
    out = decode_attention(torch.from_numpy(q8), torch.from_numpy(k8), torch.from_numpy(v8),
                           meta, torch.from_numpy(vl))
    assert decode_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4h4", "w8h8"])
def test_fused_model_hd256_plain_matches_pallas(wb, B, strict):
    """Row 6 at hd 256: the whole step with the folded (tied) head."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd = c.num_layers, c.num_kv_heads, c.head_dim_
    rng = np.random.default_rng(B + 2 * strict + 4 * wb)
    x = rng.normal(size=(B, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([37, 30, 21][:B], np.int32)
    cs = rope_cs(b, pos)
    rx, rkv, rlg = PL.fused_model_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"]),
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), jmeta_L(b, jpol), b["jpacked"]["head_q"],
        b["jpacked"]["norm"]["w"], b["jpacked"]["norm"]["b"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, act_kind=c.hidden_act,
        interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_model_w4.plain_calls
    ox, okv, olg = fused_model_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"],
        b["packed"]["head_q"], b["packed"]["norm"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, act_kind=c.hidden_act)
    assert fused_model_w4.plain_calls == before + 1
    assert okv.shape == (L, B, 2 * Hkv, hd) and olg.shape == tuple(rlg.shape)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    int8_close(okv.numpy(), np.asarray(rkv))
    assert rel(olg.numpy(), rlg) <= 2e-3


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_fused_layer_hd256_plain_matches_pallas(wb, strict):
    """Row 7 at hd 256: one layer at B = 1."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd, l = c.num_layers, c.num_kv_heads, c.head_dim_, 1
    rng = np.random.default_rng(20 + strict + 2 * wb)
    x = rng.normal(size=(1, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([41], np.int32)
    cs = rope_cs(b, pos)
    rx, rkv = PL.fused_layer_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs[0]),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"])[l],
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), JE._layer_meta(jlr(b, l), jpol, b["jcfg"]), l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        act_kind=c.hidden_act, interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_layer_w4.plain_calls
    ox, okv = fused_layer_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"], l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        act_kind=c.hidden_act)
    assert fused_layer_w4.plain_calls == before + 1
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    assert okv.shape == (2 * Hkv, hd)
    int8_close(okv.numpy(), np.asarray(rkv))
