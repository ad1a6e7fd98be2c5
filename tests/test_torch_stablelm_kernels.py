"""The LayerNorm editions of the port's whole-model, whole-layer, MLP-block,
chunk and o-tail kernels (plain versions on the CPU) held against the JAX
package's Pallas kernels in interpret mode, on StableLM.

Model: the stablelm_mha64_partial shape of tests/test_kernels.py
(test-stablelm at hidden 256, F 512, 8 q heads over 8 kv heads of head_dim
64, rotary on 16 of them, LayerNorm with a bias, a bias on q/k/v only, 2
layers, max_seq_len 128). The JAX model's norm weights, norm biases and q/k/v
biases, all ones or zeros at init, are redrawn from a numpy seed (weights 1 +
N(0, 0.05²), biases N(0, 0.02²) and N(0, 0.1²)) so that every bias term is
exercised; then it is calibrated and packed by the JAX package W4A8 with a W4
head (h4) or W8A8 (the JAX bench's per-tensor asymmetric W8) with a W8 head
(h8), and the port reads each pack with convert.from_jax_packed. Tolerances
are those of the RMSNorm editions' tests (tests/test_torch_fused.py,
test_torch_fused_model.py, test_torch_staged.py, test_torch_w8.py): fp32
outputs rtol = atol = 2e-4 (the integer dots are exact, fp32 sums are taken
in other orders), int8 rows within one quantization step on at most 0.1% of
the bytes, logits rel <= 2e-3.
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
from mobilequant_tpu.ops import pallas_chunk as PC
from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops import mlp_block as MB
from mobilequant_tpu_torch.ops import otail as OT
from mobilequant_tpu_torch.ops.chunk_model import chunk_kernel_supported, fused_model_w4_chunk
from mobilequant_tpu_torch.ops.fused_layer import (
    fused_layer_w4, fused_model_w4, layer_kernel_supported, norm_kind_of)
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4
from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
from mobilequant_tpu_torch.ops.qops import quantize_act
from mobilequant_tpu_torch.ops.w13_gate import _fq, w13_gate_plain
from mobilequant_tpu_torch.ops.w4a8_matmul import w4a8_matmul_plain
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E

S_MAX = 128
SHAPE = dict(hidden_size=256, intermediate_size=512, num_heads=8, num_kv_heads=8,
             head_dim=64, num_layers=2)


def wcfg(wb: int) -> dict:
    """W4: per-channel symmetric; W8: the JAX bench's per-tensor asymmetric."""
    return dict(bitwidth=wb, is_per_channel=wb == 4, is_symmetric=wb == 4)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _int8_close(a, b, max_frac=1e-3):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert d.max() <= 1, f"max int8 difference {d.max()}"
    assert (d > 0).sum() <= max_frac * d.size, f"{(d > 0).sum()} of {d.size} differ"


def redraw_norms_and_biases(params: dict, seed: int) -> dict:
    """The JAX params with their LayerNorm weights / biases (every layer's two
    norms and the final norm) and q/k/v biases drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    ly = params["layers"]

    def draw(like, std, mean=0.0):
        return jnp.asarray(mean + std * rng.normal(size=like.shape).astype(np.float32))

    for norm in (ly["attn_norm"], ly["mlp_norm"], params["norm"]):
        norm["w"] = draw(norm["w"], 0.05, 1.0)
        norm["b"] = draw(norm["b"], 0.02)
    for key in ("q_proj", "k_proj", "v_proj"):
        ly[key]["b"] = draw(ly[key]["b"], 0.1)
    return params


@functools.lru_cache(maxsize=2)
def built(wb: int = 4):
    """StableLM at the stablelm_mha64_partial shape, packed W4A8/h4 (wb 4) or
    W8A8/h8 (wb 8) by the JAX package and read by the port."""
    jcfg = dataclasses.replace(j_get_config("test-stablelm"), **SHAPE)
    assert PL.layer_kernel_supported(jcfg, S_MAX)
    params = redraw_norms_and_biases(JM.init_params(jcfg, jax.random.PRNGKey(0)), 1)
    jpol = j_default_policy(jcfg, JQC(**wcfg(wb)), JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=wb, head_bits=wb)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    assert "qkvp" in jpacked["layers"]
    cfg = get_config("test-stablelm-256")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert norm_kind_of(cfg) == "layernorm" and cfg.rotary_dim == 16 and cfg.has_qkv_bias
    assert layer_kernel_supported(cfg, S_MAX)
    pol = default_policy(cfg, QuantConfig(**wcfg(wb)), QuantConfig(bitwidth=8))
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=wb)
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, jecfg=jecfg, cfg=cfg, pol=pol,
                ecfg=ecfg, tokens=tokens,
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


def policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def _jlr(b, l):
    return jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"])


def _rope_cs(b, pos):
    cos, sin = JM.rope_cos_sin(jnp.asarray(pos)[:, None], b["jcfg"], jnp.float32)
    return np.array(JE._rope_cs_vec(cos, sin, b["jcfg"].head_dim_, b["jcfg"].rotary_dim))


def _jmeta_L(b, jpol):
    return jnp.stack([JE._layer_meta(_jlr(b, l), jpol, b["jcfg"])
                      for l in range(b["cfg"].num_layers)])


@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_stablelm_pack_carries_the_norms_and_biases(wb):
    """The port reads the JAX pack's LayerNorm vectors and q/k/v bias bit for
    bit, and its metas equal the JAX engine's."""
    b = built(wb)
    jly, ly, c = b["jpacked"]["layers"], b["packed"]["layers"], b["cfg"]
    for key in ("attn_norm", "mlp_norm"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(ly[key][k].numpy(), np.asarray(jly[key][k]))
    assert ly["attn_norm"]["b"].abs().min() > 0 and ly["qkv_proj"]["bias"].abs().min() > 0
    np.testing.assert_array_equal(ly["qkv_proj"]["bias"].numpy(),
                                  np.asarray(jly["qkv_proj"]["bias"]))
    assert not ly["o_proj"]["bias"].any() and not ly["w2"]["bias"].any()
    jpol, pol = policies(b, False)
    for l in range(c.num_layers):
        np.testing.assert_array_equal(
            np.asarray(E._layer_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c),
                       np.float32),
            np.asarray(JE._layer_meta(_jlr(b, l), jpol, b["jcfg"])))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4h4", "w8h8"])
def test_fused_model_ln_plain_matches_pallas(wb, B, strict):
    """Row 6's LayerNorm edition: the whole step with the folded head."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd = c.num_layers, c.num_kv_heads, c.head_dim_
    rng = np.random.default_rng(B + 2 * strict + 4 * wb)
    x = rng.normal(size=(B, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([37, 30, 21, 37][:B], np.int32)
    cs = _rope_cs(b, pos)
    rx, rkv, rlg = PL.fused_model_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"]),
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), _jmeta_L(b, jpol), b["jpacked"]["head_q"],
        b["jpacked"]["norm"]["w"], b["jpacked"]["norm"]["b"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, norm_kind="layernorm",
        interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_model_w4.plain_calls
    ox, okv, olg = fused_model_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"],
        b["packed"]["head_q"], b["packed"]["norm"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, norm_kind="layernorm")
    assert fused_model_w4.plain_calls == before + 1
    assert okv.shape == (L, B, 2 * Hkv, hd) and olg.shape == tuple(rlg.shape)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    _int8_close(okv.numpy(), np.asarray(rkv))
    assert _rel(olg.numpy(), rlg) <= 2e-3


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_fused_layer_ln_plain_matches_pallas(wb, strict):
    """Row 7's LayerNorm edition: one layer at B = 1."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd, l = c.num_layers, c.num_kv_heads, c.head_dim_, 1
    rng = np.random.default_rng(20 + strict + 2 * wb)
    x = rng.normal(size=(1, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([41], np.int32)
    cs = _rope_cs(b, pos)
    rx, rkv = PL.fused_layer_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs[0]),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"])[l],
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), JE._layer_meta(_jlr(b, l), jpol, b["jcfg"]), l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        norm_kind="layernorm", interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_layer_w4.plain_calls
    ox, okv = fused_layer_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"], l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        norm_kind="layernorm")
    assert fused_layer_w4.plain_calls == before + 1
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    assert okv.shape == (2 * Hkv, hd)
    _int8_close(okv.numpy(), np.asarray(rkv))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("M_", [1, 8, 128])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_mlp_block_ln_plain_matches_pallas(wb, M_, strict):
    """Row 8's LayerNorm edition at the dp4a kernel's (M = 1) and the row
    kernel's row counts."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    jly, ly, c = b["jpacked"]["layers"], b["packed"]["layers"], b["cfg"]
    l = 1
    x = np.random.default_rng(M_ + 10 * strict + wb).normal(
        size=(M_, c.hidden_size)).astype(np.float32)
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c)
    site_on = E._mlp_block_site_on(pol)
    ref = PMLP.fused_mlp_block_w4_stacked(
        jnp.asarray(x), jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"],
        jly["w2"], JE._mlp_block_meta(_jlr(b, l), jpol, b["jcfg"]), l, "silu", "layernorm",
        site_on=site_on, interpret=True)
    before = fused_mlp_block_w4.plain_calls
    out = fused_mlp_block_w4(torch.from_numpy(x), ly["mlp_norm"]["w"], ly["mlp_norm"]["b"],
                             ly["w13_proj"], ly["w2"], meta, l, "silu", site_on, "layernorm")
    assert fused_mlp_block_w4.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@jax.jit
def _xla_norm_stage(x, nw, nb, eps, s, o):
    """The JAX kernels' LayerNorm stage (pallas_mlp._w4_mlp_phase: the fp32
    mean, the variance of x − mean, rsqrt, ·w + b, the shifted int8
    quantization), as XLA compiles it."""
    mu = jnp.mean(x, axis=1, keepdims=True)
    var = jnp.mean(jnp.square(x - mu), axis=1, keepdims=True)
    y = (x - mu) * jax.lax.rsqrt(var + eps) * nw + nb
    return PMLP._quant_u8s(y, s, o)


def _norm_stage_bytes(x, nw, nb, m, xla):
    """The MLP block's norm stage on its input x (M, K) -> (M, K) int8: the
    port's plain version's, or (xla) the JAX kernels' under XLA."""
    if xla:
        out = _xla_norm_stage(jnp.asarray(x.numpy()), jnp.asarray(nw.numpy()),
                              jnp.asarray(nb.numpy()), np.float32(m[19]), np.float32(m[0]),
                              np.float32(m[1]))
        return torch.from_numpy(np.array(out))
    return quantize_act(MB.layer_norm(x, m[19]) * nw + nb, m[0], m[1])


def _mlp_block_on_xla_norm(x, norm_w, norm_b, w13, w2, meta, act_kind="silu",
                           site_on=(True,) * 9, norm_kind="layernorm"):
    """The MLP block's plain version with its norm stage taken from XLA
    (_norm_stage_bytes): the witness that a gap to the JAX kernel is that
    stage's fp32 rounding."""
    m = [float(v) for v in meta]
    s_x16, s_w1, s_sig, s_act, s_w3, s_w2o, s_r1, s_r2, s_ro = site_on

    def fq(v, i, on):
        return _fq(v, m[i], m[i + 1], m[i + 2]) if on else v

    h8 = _norm_stage_bytes(fq(x, 16, s_x16), norm_w, norm_b, m, xla=True)
    act8 = w13_gate_plain(h8, w13, m[:16], act_kind, (s_w1, s_sig, s_act, s_w3))
    y2 = w4a8_matmul_plain(act8, w2["wq"], w2["scale"], w2["offset"], w2["colsum"],
                           w2.get("bias"), m[14], m[15])
    y2 = fq(fq(y2, 20, s_w2o), 26, s_r2)
    return fq(fq(x, 23, s_r1) + y2, 29, s_ro)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_otail_ln_plain_matches_pallas(wb, strict):
    """Row 18's LayerNorm edition at M = 32. On W4 strict one byte of the MLP
    block's norm stage lands on the other side of a rounding boundary under
    XLA than in the port's plain version (row 20; the stage's fp32 rounding
    under XLA's compilation, not the norm's sums: ROADMAP §3), and that row's
    outputs move by up to 9.8e-4: rows whose norm bytes agree are held to
    2e-4, a row with such a byte to 2e-3 (about twice the reading), and the
    plain version with XLA's norm stage (the witness) to 2e-4 everywhere."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    l, M_ = 1, 32
    rng = np.random.default_rng(30 + strict + wb)
    a8 = rng.integers(-128, 128, (M_, c.num_heads * c.head_dim_)).astype(np.int8)
    x = rng.normal(size=(M_, c.hidden_size)).astype(np.float32)
    jlr = _jlr(b, l)
    jmeta = jnp.concatenate([JE._mlp_block_meta(jlr, jpol, b["jcfg"]),
                             JE._otail_meta_ext(jlr, jpol)])
    lr = E.layer_ranges(b["packed"]["ranges"], l)
    meta = E._mlp_block_meta(lr, pol, c) + E._otail_meta_ext(lr, pol)
    site_on, osite_on = E._mlp_block_site_on(pol), E._otail_site_on(pol)
    ref = PMLP.fused_otail_block_stacked(
        jnp.asarray(a8), jnp.asarray(x), jly["o_proj"], jly["mlp_norm"]["w"],
        jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"], jmeta, l, "silu", "layernorm",
        site_on=site_on, osite_on=osite_on, interpret=True)
    args = (torch.from_numpy(a8), torch.from_numpy(x), ly["o_proj"], ly["mlp_norm"]["w"],
            ly["mlp_norm"]["b"], ly["w13_proj"], ly["w2"], meta, l, "silu", site_on, osite_on,
            "layernorm")
    block = OT.fused_otail_block_w4_plain.__globals__["fused_mlp_block_w4_plain"]
    seen = {}

    def capture(resid, *a, **k):
        seen["resid"] = resid
        return block(resid, *a, **k)

    before = fused_otail_block_w4.plain_calls
    OT.fused_mlp_block_w4_plain = capture
    try:
        out = fused_otail_block_w4(*args).numpy()
        OT.fused_mlp_block_w4_plain = _mlp_block_on_xla_norm
        witness = fused_otail_block_w4(*args).numpy()
    finally:
        OT.fused_mlp_block_w4_plain = block
    assert fused_otail_block_w4.plain_calls == before + 2
    ref = np.asarray(ref)
    np.testing.assert_allclose(witness, ref, rtol=2e-4, atol=2e-4)
    xx = seen["resid"]
    if site_on[0]:
        xx = _fq(xx, meta[16], meta[17], meta[18])
    nw, nb, m = ly["mlp_norm"]["w"][l], ly["mlp_norm"]["b"][l], [float(v) for v in meta]
    port_b = _norm_stage_bytes(xx, nw, nb, m, xla=False).numpy()
    xla_b = _norm_stage_bytes(xx, nw, nb, m, xla=True).numpy()
    _int8_close(port_b, xla_b)
    same = (port_b == xla_b).all(1)
    np.testing.assert_allclose(out[same], ref[same], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-3)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("m_st", [0, 1])
def test_chunk_ln_plain_matches_pallas(m_st, strict):
    """Row 11's LayerNorm edition (W4/h4) at B = 16: the whole staged step
    with the folded head's final LayerNorm."""
    b = built(4)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd, B, ncs = c.num_layers, c.num_kv_heads, c.head_dim_, 16, 2
    assert chunk_kernel_supported(c, S_MAX, B) and PC.chunk_kernel_supported(
        b["jcfg"], S_MAX, B)
    rng = np.random.default_rng(40 + 2 * m_st + strict)
    x = rng.normal(size=(B, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    sk = rng.integers(-128, 128, (L, B, Hkv, ncs, hd)).astype(np.int8)
    sv = rng.integers(-128, 128, (L, B, Hkv, ncs, hd)).astype(np.int8)
    kcs = kc.astype(np.int32).sum(-1).astype(np.float32)
    pos0 = np.asarray([9, 8, 7, 9] * 4, np.int32)
    cs = _rope_cs(b, pos0 + m_st)
    qk_on = bool(pol["self_attn.qk_bmm"].output.enabled)
    pv_on = bool(pol["self_attn.pv_bmm"].input.enabled)
    rx, rkv, rlg = PC.fused_model_w4_chunk(
        jnp.asarray(x), jnp.asarray(pos0), jnp.asarray(cs),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"]),
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcs).reshape(L, B, Hkv, 1, S_MAX),
        jnp.asarray(sk), jnp.asarray(sv), jnp.int32(m_st), _jmeta_L(b, jpol),
        b["jpacked"]["head_q"], b["jpacked"]["norm"]["w"], b["jpacked"]["norm"]["b"],
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        norm_kind="layernorm", qk_fq_on=qk_on, pv_fq_on=pv_on,
        site_on=JE._mlp_block_site_on(jpol), interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_model_w4_chunk.plain_calls
    ox, okv, olg = fused_model_w4_chunk(
        torch.from_numpy(x), torch.from_numpy(pos0), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(kcs),
        torch.from_numpy(sk), torch.from_numpy(sv), m_st, prep["meta"],
        b["packed"]["head_q"], b["packed"]["norm"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, norm_kind="layernorm",
        qk_fq_on=qk_on, pv_fq_on=pv_on)
    assert fused_model_w4_chunk.plain_calls == before + 1
    assert okv.shape == (L, B, 2 * Hkv, hd) and olg.shape == tuple(rlg.shape)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    _int8_close(okv.numpy(), np.asarray(rkv))
    assert _rel(olg.numpy(), rlg) <= 2e-3
