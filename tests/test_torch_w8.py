"""The port's W8A8 slice (plain versions on the CPU) held against the JAX
package: the W8 editions of the qkv epilogue, w13+gate, MLP-block,
whole-model / whole-layer and chunk kernels with the W8 head, w8a8_matmul,
the engine's W8 routing and Generator.generate_fast on a W8/h8 pack.

Model: the llama_gqa64 shape of tests/test_torch_fused.py (hidden 256, 8 q /
4 kv heads, head_dim 64, F 512, 2 layers, max_seq_len 128), calibrated and
packed W8A8 by the JAX package with its bench's W8 policy (per-tensor
asymmetric weights) and a W8 per-channel head (h8), or the fp head (h16).
The CUDA kernels cannot run here (no card, no nvcc): on CPU tensors every
wrapper runs its plain version, which chip_smoke.py holds against the kernel
on the card. The JAX kernels run in interpret mode where that stays cheap;
the whole-model and chunk kernels, slow in interpret mode, are held through
the JAX engine's XLA path, which the JAX package's own tests hold equal to
them (tests/test_kernels.py llama_gqa64_w8, w8_h16). Tolerances: fp32
outputs of one kernel rtol = atol = 2e-4 (integer dots exact, fp32 sums in
other orders), w8a8_matmul rel 1e-6; int8 outputs of the epilogue kernels
equal; decode chains: greedy tokens equal, logits rel <= 2e-3, or 2e-2 on a
chain whose written K/V bytes differ by a step (XLA's CPU rsqrt / exp / sin
are not correctly rounded: tests/test_torch_engine.py), and int8 caches
within one step on at most 0.1% of the bytes.
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
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import pallas_qkv as PQ
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.generate import Generator as JGenerator
from mobilequant_tpu.runtime.sampling import SamplerConfig

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import build_synthetic_packed, from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops.fused_layer import (
    fused_layer_w4, fused_model_w4, head_kernel_supported)
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4
from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope
from mobilequant_tpu_torch.ops.w13_gate import w13_gate
from mobilequant_tpu_torch.ops.w8a8_matmul import w8a8_matmul
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

S_MAX = 128
W8 = dict(bitwidth=8, is_per_channel=False, is_symmetric=False)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _int8_close(a, b, max_frac=1e-3):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert d.max() <= 1, f"max int8 difference {d.max()}"
    assert (d > 0).sum() <= max_frac * d.size, f"{(d > 0).sum()} of {d.size} differ"


@functools.lru_cache(maxsize=1)
def _calibrated():
    jcfg = dataclasses.replace(j_get_config("test-llama"), hidden_size=256,
                               intermediate_size=512, num_heads=8, num_kv_heads=4,
                               head_dim=64, num_layers=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(1))
    jpol = j_default_policy(jcfg, JQC(**W8), JQC(bitwidth=8))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    return jcfg, params, jpol, ranges


@functools.lru_cache(maxsize=2)
def _built(head_bits=8):
    """The W8A8 llama_gqa64 model packed by the JAX package (head_bits 8: the
    W8 per-channel head; 16: the fp head) and read by the port."""
    jcfg, params, jpol, ranges = _calibrated()
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=8,
                            head_bits=head_bits)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-llama-256").replace(num_heads=8, num_kv_heads=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = default_policy(cfg, QuantConfig(**W8), QuantConfig(bitwidth=8))
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=head_bits)
    packed = from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu")
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, jecfg=jecfg, cfg=cfg, pol=pol,
                ecfg=ecfg, packed=packed)


def _policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def _jlr(b, l):
    return jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"])


def _rope_cs(b, pos, rot):
    cos, sin = JM.rope_cos_sin(jnp.asarray(pos)[:, None], b["jcfg"], jnp.float32)
    return np.array(JE._rope_cs_vec(cos, sin, b["jcfg"].head_dim_, rot))


def test_w8_pack_is_the_jax_w8_layout():
    """from_jax_packed carries the JAX W8 pack across unchanged: (L, K, N)
    shifted int8 rows, per-tensor scale / shifted offset on o and w2, the
    fused qkv / w13 packs per column, and the (K, Vp) W8 head."""
    b = _built()
    jly, ly, c = b["jpacked"]["layers"], b["packed"]["layers"], b["cfg"]
    L, D, F = c.num_layers, c.hidden_size, c.intermediate_size
    assert tuple(ly["qkv_proj"]["wq"].shape) == (L, D, (c.num_heads + 2 * c.num_kv_heads) * 64)
    assert tuple(ly["w2"]["wq"].shape) == (L, F, D) and tuple(ly["o_proj"]["scale"].shape) == (L,)
    assert ly["o_proj"]["offset"].abs().max() > 0          # asymmetric: shifted zero-points
    for key in ("qkv_proj", "o_proj", "w13_proj", "w2"):
        for k, v in ly[key].items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jly[key][k]))
    hq = b["packed"]["head_q"]
    assert hq["wq"].shape[0] == D and head_kernel_supported(hq, D)
    np.testing.assert_array_equal(hq["wq"].numpy(), np.asarray(b["jpacked"]["head_q"]["wq"]))


def test_synthetic_w8_builder_matches_the_w8_pack_layout():
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", w_bits=8, head_bits=8,
                                                       max_seq_len=32, device="cpu")
    ly, L, D = packed["layers"], cfg.num_layers, cfg.hidden_size
    assert policy["mlp.w2"].weight.bitwidth == 8 and not policy["mlp.w2"].weight.is_symmetric
    for key, K in (("qkv_proj", D), ("o_proj", cfg.q_dim), ("w13_proj", D),
                   ("w2", cfg.intermediate_size)):
        p = ly[key]
        assert p["wq"].dtype == torch.int8 and p["wq"].shape[1] == K
        np.testing.assert_array_equal(p["colsum"].numpy(), p["wq"].float().sum(1).numpy())
    assert tuple(ly["w2"]["scale"].shape) == (L,) and tuple(ly["qkv_proj"]["scale"].shape)[:2] == (L, 1)
    assert ly["w2"]["offset"].abs().max() > 0
    assert packed["head_q"]["wq"].shape[0] == D


@pytest.mark.parametrize("M_,layer", [(1, None), (1, 1), (2, 1), (4, 1), (8, 1), (9, 1),
                                      (32, 1), (33, 1), (128, 1)],
                         ids=["M1", "M1_stacked", "M2_stacked", "M4_stacked", "M8_stacked",
                              "M9_stacked", "M32_stacked", "M33_stacked", "M128_stacked"])
def test_w8a8_matmul_plain_matches_pallas(M_, layer):
    """Row 14 at any M, as the JAX kernel takes it (the wrapper's plain
    version on the CPU; the kernel is held against it on the card)."""
    rng = np.random.default_rng(M_ + (layer or 0))
    K, N, L = 256, 512, 2
    wq = rng.integers(-128, 128, (L, K, N)).astype(np.int8)
    scale = np.full((L,), 1.0 / (74.0 * 16.0), np.float32)
    offset = np.asarray([-7.0, 5.0], np.float32)
    colsum = wq.astype(np.float32).sum(1)
    bias = (rng.normal(size=(L, N)) * 0.1).astype(np.float32)
    x = rng.integers(-128, 128, (M_, K)).astype(np.int8)
    xs, xo = float(np.float32(0.02)), 121.0
    li = layer or 0
    ref = PM.w8a8_matmul(jnp.asarray(x), jnp.asarray(wq[li]), scale[li], offset[li],
                         colsum[li], bias[li], xs, xo, block_n=256, interpret=True)
    pack = {"wq": wq, "scale": scale, "offset": offset, "colsum": colsum, "bias": bias}
    if layer is None:
        pack = {k: v[0] for k, v in pack.items()}
    before = w8a8_matmul.plain_calls
    out = w8a8_matmul(torch.from_numpy(x),
                      {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in pack.items()},
                      xs, xo, layer)
    assert w8a8_matmul.plain_calls == before + 1
    assert out.shape == (M_, N)
    assert _rel(out.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("M_", [32, 33])
def test_w8_projection_route_gate_is_the_jax_gate(M_, monkeypatch):
    """Under w8_matmul the engine sends a W8 projection of at most 32 rows to
    w8a8_matmul and 33 to the plain qops.int_linear, as the JAX _int_linear
    does (engine.W8_MATMUL_ROWS; the kernel itself takes any M); both routes
    equal the JAX one (its kernel in interpret mode)."""
    monkeypatch.setattr(PM, "w8a8_matmul", functools.partial(PM.w8a8_matmul, interpret=True))
    b = _built()
    K = b["cfg"].hidden_size
    x = np.random.default_rng(M_).integers(-128, 128, (M_, K)).astype(np.int8)
    r = {"scale": float(np.float32(0.02)), "offset": 121.0}
    before = w8a8_matmul.plain_calls
    out = E._int_linear(torch.from_numpy(x), r, b["packed"]["layers"]["qkv_proj"], 1,
                        KernelConfig.attn_all())
    assert w8a8_matmul.plain_calls == before + (M_ <= E.W8_MATMUL_ROWS)
    jp = jax.tree.map(lambda a: a[1], b["jpacked"]["layers"]["qkv_proj"])
    ref = JE._int_linear(jnp.asarray(x), r["scale"], r["offset"], jp, jp.get("bias"),
                         JE.KernelConfig.coerce("attn_all"))
    assert _rel(out.numpy(), ref) <= 1e-6


def test_qkv_rope_w8_plain_matches_pallas():
    b = _built()
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    pol = relax_16bit(b["pol"])
    l, M_, hd = 1, 40, c.head_dim_
    h8 = np.random.default_rng(3).integers(-128, 128, (M_, c.hidden_size)).astype(np.int8)
    ofq = E._qkv_ofq_rows(b["packed"], pol)[l].numpy()
    outq = E._qkv_outq_rows(b["packed"]["ranges"], c, c.num_layers, "cpu")[l].numpy()
    cs = _rope_cs(b, np.arange(M_), c.rotary_dim).reshape(M_, 2 * hd)
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
def test_w13_gate_w8_plain_matches_pallas(strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    l, M_ = 1, 40
    h8 = np.random.default_rng(4 + strict).integers(-128, 128, (M_, c.hidden_size)).astype(np.int8)
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c)
    so = E._mlp_block_site_on(pol)[1:5]
    ref = PMLP.w13_gate_stacked(jnp.asarray(h8), jly["w13_proj"],
                                JE._mlp_block_meta(_jlr(b, l), jpol, b["jcfg"]), l, "silu",
                                site_on=so, interpret=True)
    before = w13_gate.plain_calls
    out = w13_gate(torch.from_numpy(h8), ly["w13_proj"], meta, l, "silu", site_on=so)
    assert w13_gate.plain_calls == before + 1
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("M_", [1, 8, 128])
def test_mlp_block_w8_plain_matches_pallas(M_, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    jly, ly = b["jpacked"]["layers"], b["packed"]["layers"]
    l = 1
    assert PMLP.w8_mlp_block_supported(256, 512)
    x = np.random.default_rng(M_ + 10 * strict).normal(size=(M_, 256)).astype(np.float32)
    jmeta = JE._mlp_block_meta(_jlr(b, l), jpol, b["jcfg"])
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, b["cfg"])
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    site_on = E._mlp_block_site_on(pol)
    ref = PMLP.fused_mlp_block_w4_stacked(
        jnp.asarray(x), jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"],
        jly["w2"], jmeta, l, "silu", "rmsnorm", site_on=site_on, interpret=True)
    before = fused_mlp_block_w4.plain_calls
    out = fused_mlp_block_w4(torch.from_numpy(x), ly["mlp_norm"]["w"], ly["mlp_norm"]["b"],
                             ly["w13_proj"], ly["w2"], meta, l, "silu", site_on)
    assert fused_mlp_block_w4.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_fused_layer_w8_plain_matches_pallas():
    """The whole-layer kernel's W8 edition against the JAX one (its own
    TPU-permuted qkvp / op packs on the JAX side, the canonical ones here)."""
    b = _built()
    jpol, pol = _policies(b, False)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd, l = c.num_layers, c.num_kv_heads, c.head_dim_, 1
    rng = np.random.default_rng(21)
    x = rng.normal(size=(1, 256)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, 1, Hkv, S_MAX, hd)).astype(np.int8)
    pos = np.asarray([37], np.int32)
    cs = _rope_cs(b, pos, c.rotary_dim)
    rx, rkv = PL.fused_layer_w4_stacked(
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cs[0]),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"])[l],
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), JE._layer_meta(_jlr(b, l), jpol, b["jcfg"]), l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_layer_w4.plain_calls
    ox, okv = fused_layer_w4(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), prep["meta"], l,
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim)
    assert fused_layer_w4.plain_calls == before + 1
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    _int8_close(okv.numpy(), np.asarray(rkv))


def _jax_prefill(b, jpol, prompt):
    B, Tp = prompt.shape
    jcache = JE.init_kv_cache(b["jecfg"], B)
    lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol, kv_cache=jcache,
                            cache_position=jnp.zeros((B,), jnp.int32),
                            kv_valid_len=jnp.full((B,), Tp, jnp.int32))
    first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
    return first, jcache


def _check_chain(tt, cache, tl, jt, jc, jl, rows):
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    equal = all(np.array_equal(t.numpy()[:, :, :, rows], np.asarray(j)[:, :, :, rows])
                for t, j in ((cache.k, jc.k), (cache.v, jc.v)))
    assert _rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)
    _int8_close(cache.k.numpy(), np.asarray(jc.k))
    _int8_close(cache.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("B", [1, 4])
def test_w8_decode_chain_on_the_whole_model_kernel_matches_jax(B):
    """KernelConfig.decode() on the W8/h8 pack: one whole-model call a step
    (the W8 head folded) against the JAX engine's decode_loop (XLA) from the
    same prefill cache."""
    b = _built()
    jpol, pol = _policies(b, False)
    c, Tp, n = b["cfg"], 6, 4
    prompt = np.random.default_rng(30 + B).integers(0, c.vocab_size, (B, Tp)).astype(np.int32)
    first, jcache = _jax_prefill(b, jpol, prompt)
    jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache,
                                jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                use_pallas=False)
    cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                            torch.from_numpy(np.array(jcache.v)))
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, c, pol,
                                  kc=KernelConfig.decode())
    plain = T_ops.counts("plain_calls")
    assert plain["fused_model_w4"] == n and plain["w4a8_matmul"] == 0, plain
    assert sum(plain.values()) == n
    _check_chain(tt, cache, tl, jt, jc, jl, slice(Tp, Tp + n))


@pytest.mark.parametrize("head_bits", [8, 16], ids=["h8", "h16"])
def test_w8_staged_chain_on_the_chunk_kernel_matches_jax(head_bits):
    """decode_loop's entry config on the W8 pack at B = 16 takes the chunk
    kernel (the JAX gate: W8 packs at 8 < B <= 48), with the W8 head folded
    (h8) or the fp head after it (h16), against the JAX engine's staged
    decode_loop (XLA) from the same prefill cache: two chunks of 2 steps."""
    b = _built(head_bits)
    jpol, pol = _policies(b, False)
    c, B, Tp, n = b["cfg"], 16, 5, 4
    kc = KernelConfig.serving(c, b["packed"], B)
    assert kc.chunk_kernel
    toks = np.random.default_rng(7).integers(0, c.vocab_size, (2, Tp)).astype(np.int32)
    prompt = np.tile(toks, (B // 2, 1))
    first, jcache = _jax_prefill(b, jpol, prompt)
    jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first),
                                JE.EngineKVCache(jcache.k, jcache.v),
                                jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                use_pallas=False, staging_chunk=2)
    cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                            torch.from_numpy(np.array(jcache.v)))
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, c, pol,
                                  kc=None, staging_chunk=2)
    plain = T_ops.counts("plain_calls")
    assert plain["fused_model_w4_chunk"] == n and plain["staged_append"] == n, plain
    assert plain["fused_mlp_block_w4"] == 0 and plain["w4a8_matmul"] == 0
    _check_chain(tt, cache, tl, jt, jc, jl, slice(Tp, Tp + n))


@pytest.mark.parametrize("B", [1, 16])
def test_w8_generate_fast_matches_jax_generator(B):
    """The slice: Generator.generate_fast on the W8/h8 pack (prefill with qkv
    on the plain integer matmul, as the JAX engine keeps it on W8 packs, and
    the W8 w13 epilogue kernel or the MLP block; decode one whole-model call a
    step at B=1, one chunk call a step at B=16) gives the JAX Generator's
    greedy tokens."""
    b = _built()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    Tp = 20 if B == 1 else 6
    prompt = np.random.default_rng(40 + B).integers(0, c.vocab_size, (B, Tp)).astype(np.int32)
    ref = JGenerator(b["jpacked"], b["jcfg"], jpol, b["jecfg"]).generate(
        prompt, 6, SamplerConfig(greedy=True))
    gen = Generator(b["packed"], c, pol, b["ecfg"], device="cpu")
    T_ops.reset_counts()
    np.testing.assert_array_equal(gen.generate_fast(prompt, 6, chunk=3), ref)
    plain = T_ops.counts("plain_calls")
    L = c.num_layers
    assert plain["qkv_rope"] == 0 and plain["prefill_attention"] == L
    if B == 1:
        assert plain["fused_mlp_block_w4"] == L and plain["fused_model_w4"] == 5
    else:
        assert plain["w13_gate"] == L and plain["fused_model_w4_chunk"] == 5
    assert plain["w4a8_matmul"] == plain["w4a8_matmul_stacked"] == 0


def test_w8_projections_under_the_w4_kernel_flag_take_the_plain_matmul():
    """Repair: under w4_matmul a W8 pack falls through to the plain integer
    matmul (the JAX _int_linear), where the port used to raise; under
    w8_matmul (KernelConfig.attn_all()) a T = 1 step sends qkv and o to
    w8a8_matmul. Both equal the plain step."""
    b = _built()
    pol, c = relax_16bit(b["pol"]), b["cfg"]
    tok = torch.tensor([[5], [9]])
    pos = torch.tensor([3, 4], dtype=torch.int32)
    cache0 = E.init_kv_cache(b["ecfg"], 2, device="cpu")
    res = {}
    for name, kc in (("w4", KernelConfig(w4_matmul=True)), ("all", KernelConfig.attn_all()),
                     ("none", KernelConfig.none())):
        cache = E.EngineKVCache(cache0.k.clone(), cache0.v.clone())
        T_ops.reset_counts()
        res[name] = E.forward(b["packed"], tok, c, pol, positions=pos[:, None],
                              kv_cache=cache, cache_position=pos, kv_valid_len=pos + 1,
                              kc=kc)
        res[name + "_calls"] = T_ops.counts("plain_calls")
    assert not any(res["w4_calls"].values())
    assert res["all_calls"]["w8a8_matmul"] == 2 * c.num_layers          # qkv and o
    assert res["all_calls"]["decode_attention"] == c.num_layers
    assert res["all_calls"]["fused_mlp_block_w4"] == c.num_layers
    for name in ("w4", "all"):
        assert _rel(res[name][0].numpy(), res["none"][0].numpy()) <= 2e-3
        _int8_close(res[name][1].k.numpy(), res["none"][1].k.numpy())


def test_w8_head_under_a_kernel_flag_takes_the_plain_int_head():
    """Repair: quantized_head_logits on a W8 head with use_kernel takes the
    plain int head (the JAX engine's), where the port used to raise."""
    b = _built()
    hq = b["packed"]["head_q"]
    y = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 256)).astype(np.float32))
    out = E.quantized_head_logits(y, hq, b["cfg"].vocab_size, use_kernel=True)
    ref = JE.quantized_head_logits(jnp.asarray(y.numpy()), b["jpacked"]["head_q"],
                                   b["cfg"].vocab_size, use_kernel=False)
    assert _rel(out.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("B", [16, 32, 48])
def test_serving_config_on_w8_packs_runs_the_chunk_route(B):
    """Repair: KernelConfig.serving switches the chunk kernel on for W8 packs
    at 8 < B <= 48 (the JAX gate), and that route now runs (the port's chunk
    wrapper refused W8 packs): decode_loop's entry config on the W8/h8 pack
    is one chunk call a step with the W8 head folded, against the JAX
    decode_loop(use_pallas=True), which takes its chunk kernel there (in
    interpret mode), over 2 steps from the same prefill cache."""
    from mobilequant_tpu.ops import pallas_chunk as PC
    b = _built()
    jpol, pol = _policies(b, False)
    c, Tp, n = b["cfg"], 4, 2
    kc = KernelConfig.serving(c, b["packed"], B)
    assert kc.chunk_kernel and not KernelConfig.serving(c, b["packed"], 64).chunk_kernel
    prompt = np.random.default_rng(B).integers(0, c.vocab_size, (B, Tp)).astype(np.int32)
    first, jcache = _jax_prefill(b, jpol, prompt)
    orig = PC.fused_model_w4_chunk
    calls = []

    def interpreted(*a, **k):
        calls.append(1)
        return orig(*a, interpret=True, **k)
    PC.fused_model_w4_chunk = interpreted
    try:
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first),
                                    JE.EngineKVCache(jcache.k, jcache.v),
                                    jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                    use_pallas=True)
    finally:
        PC.fused_model_w4_chunk = orig
        jax.clear_caches()
    assert calls                                   # the JAX route took its chunk kernel
    cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                            torch.from_numpy(np.array(jcache.v)))
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, c, pol, kc=None)
    plain = T_ops.counts("plain_calls")
    assert plain["fused_model_w4_chunk"] == n and plain["staged_append"] == n, plain
    _check_chain(tt, cache, tl, jt, jc, jl, slice(Tp, Tp + n))
