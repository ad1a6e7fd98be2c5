"""Two more of the JAX engine's alternate MLP routes in the port (plain
versions on the CPU) held against the JAX package: the w2-folded prefill
kernel w13_gate_w2 (row 19, W4 and W8; the gate_kernel + w2fold_kernel
route, and the split path where its predicate refuses the shape) and the W8
edition of the o-tail kernel (row 18; KernelConfig(otail_kernel=True) and
KernelConfig.otail()).

Models: the llama_gqa64 shape (hidden 256, F 512, 2 layers, 8 q / 4 kv heads,
head_dim 64, max_seq_len 128) packed by the JAX package W4A8/h4
(tests/test_torch_fused.py) and W8A8/h8 with the JAX bench's W8 policy
(tests/test_torch_w8.py); for the refused shape the same model at F 384. The
JAX kernels run in interpret mode. Tolerances, the JAX tests' own (tests/
test_kernels.py test_w13_gate_kernel_matches_engine,
test_otail_block_kernel_matches_engine): fp32 outputs rtol = atol = 2e-4;
the port's o-tail chain against the port's plain chain: flushed caches
bit-exact; against the JAX chain: greedy tokens equal, logits rel <= 2e-3, or
2e-2 where a written K/V byte differs by a step (XLA's CPU rsqrt / exp / sin
are not correctly rounded: tests/test_torch_engine.py), int8 caches within
one step on at most 0.1% of the bytes; in the B=3 chain within two steps on
at most 0.2% of the bytes, the port's plain staged chain's own distance from
the JAX one there (ROADMAP §3, watched).
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
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import pallas_qkv as PQK
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.kernel_config import KernelConfig as JKC

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
from mobilequant_tpu_torch.ops.w13_gate_w2 import w13_gate_w2, w13_gate_w2_supported
from mobilequant_tpu_torch.quant.policy import default_policy
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

import test_torch_fused
import test_torch_w8
from test_torch_w8 import W8, _check_chain, _jlr, _policies, _rel

FOLD = KernelConfig(gate_kernel=True, w2fold_kernel=True)
JFOLD = JKC(gate_kernel=True, w2fold_kernel=True)


def _built(wb):
    return test_torch_w8._built() if wb == 8 else test_torch_fused._built()


@functools.lru_cache(maxsize=1)
def _built_f384():
    """The llama_gqa64 shape at F 384 (F/2 = 192: no 128-aligned w2 row
    block, so w13_gate_w2_supported refuses it), W8A8, fp head."""
    jcfg = dataclasses.replace(j_get_config("test-llama"), hidden_size=256,
                               intermediate_size=384, num_heads=8, num_kv_heads=4,
                               head_dim=64, num_layers=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    jpol = j_default_policy(jcfg, JQC(**W8), JQC(bitwidth=8))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=128, weight_bits=8)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-llama-256").replace(num_heads=8, num_kv_heads=4,
                                                intermediate_size=384)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = default_policy(cfg, QuantConfig(**W8), QuantConfig(bitwidth=8))
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, cfg=cfg, pol=pol,
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


def _interpret(pairs):
    orig = [(mod, name, getattr(mod, name)) for mod, name in pairs]
    for mod, name, fn in orig:
        setattr(mod, name, functools.partial(fn, interpret=True))
    return orig


def _restore(orig):
    for mod, name, fn in orig:
        setattr(mod, name, fn)
    jax.clear_caches()


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_w13_gate_w2_plain_matches_pallas(wb, act, strict):
    b = _built(wb)
    jpol, pol = _policies(b, strict)
    jly, ly = b["jpacked"]["layers"], b["packed"]["layers"]
    l, M_ = 1, 96
    assert w13_gate_w2_supported(M_, 256, 512, wb) and PMLP.w13_gate_w2_supported(M_, 256, 512,
                                                                                   wb)
    h8 = np.random.default_rng(wb + strict).integers(-128, 128, (M_, 256)).astype(np.int8)
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, b["cfg"])
    jmeta = JE._mlp_block_meta(_jlr(b, l), jpol, b["jcfg"])
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    so = E._mlp_block_site_on(pol)[1:5]
    ref = PMLP.w13_gate_w2_stacked(jnp.asarray(h8), jly["w13_proj"], jly["w2"], jmeta, l, act,
                                   site_on=so, interpret=True)
    before = w13_gate_w2.plain_calls
    out = w13_gate_w2(torch.from_numpy(h8), ly["w13_proj"], ly["w2"], meta, l, act, so)
    assert w13_gate_w2.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4", "w8"])
def test_w2fold_prefill_matches_jax_forward(wb, strict):
    """gate_kernel + w2fold_kernel at prefill M = 96: one w13_gate_w2 call a
    layer, against the JAX forward on the same flags (its kernels
    interpreted)."""
    b = _built(wb)
    jpol, pol = _policies(b, strict)
    c = b["cfg"]
    prompt = np.random.default_rng(1).integers(0, c.vocab_size, (1, 96)).astype(np.int32)
    orig = _interpret([(PMLP, "w13_gate_stacked"), (PMLP, "w13_gate_w2_stacked"),
                       (PQK, "qkv_rope_stacked")])
    try:
        ref, _ = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol, use_pallas=JFOLD)
    finally:
        _restore(orig)
    T_ops.reset_counts()
    out, _ = E.forward(b["packed"], torch.from_numpy(prompt), c, pol, kc=FOLD)
    plain = T_ops.counts("plain_calls")
    assert plain["w13_gate_w2"] == c.num_layers and plain["w13_gate"] == 0, plain
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_w2fold_refused_shape_takes_the_split_path():
    """At F = 384 the predicate refuses the fold (as the JAX one does): the
    route is the split gate path (w13_gate, then the w2 matmul), the same
    numbers as KernelConfig(gate_kernel=True) bit for bit, on both sides; the
    port's and the JAX split paths agree within the cross-framework bound
    (logits rel 2.49e-3 here, on equal K / V caches: the plain paths' own gap
    at this shape, XLA's CPU exp / rsqrt not being correctly rounded)."""
    b = _built_f384()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    assert not w13_gate_w2_supported(96, 256, 384, 8)
    assert not PMLP.w13_gate_w2_supported(96, 256, 384, 8)
    assert PMLP.w13_gate_supported(96, 256, 384, 8)
    prompt = np.random.default_rng(3).integers(0, c.vocab_size, (1, 96)).astype(np.int32)
    orig = _interpret([(PMLP, "w13_gate_stacked"), (PMLP, "w13_gate_w2_stacked")])
    try:
        ref, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                 use_pallas=JFOLD)
        ref_split, _ = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                  use_pallas=JKC(gate_kernel=True))
    finally:
        _restore(orig)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ref_split))
    T_ops.reset_counts()
    out, cache = E.forward(b["packed"], torch.from_numpy(prompt), c, pol, kc=FOLD)
    plain = T_ops.counts("plain_calls")
    assert plain["w13_gate"] == c.num_layers and plain["w13_gate_w2"] == 0, plain
    split, _ = E.forward(b["packed"], torch.from_numpy(prompt), c, pol,
                         kc=KernelConfig(gate_kernel=True))
    np.testing.assert_array_equal(out.numpy(), split.numpy())
    equal = all(np.array_equal(t.numpy(), np.asarray(j))
                for t, j in ((cache.k, jcache.k), (cache.v, jcache.v)))
    assert _rel(out.numpy(), ref) < (5e-3 if equal else 2e-2)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_w8_otail_plain_matches_pallas(strict):
    b = _built(8)
    jpol, pol = _policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    l, M_, Ko = 1, 24, c.num_heads * c.head_dim_
    rng = np.random.default_rng(31 + strict)
    a8 = rng.integers(-128, 128, (M_, Ko)).astype(np.int8)
    x = rng.normal(size=(M_, 256)).astype(np.float32)
    lr = E.layer_ranges(b["packed"]["ranges"], l)
    meta = E._mlp_block_meta(lr, pol, c) + E._otail_meta_ext(lr, pol)
    jmeta = jnp.concatenate([JE._mlp_block_meta(_jlr(b, l), jpol, b["jcfg"]),
                             JE._otail_meta_ext(_jlr(b, l), jpol)])
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    so, oso = E._mlp_block_site_on(pol), E._otail_site_on(pol)
    ref = PMLP.fused_otail_block_stacked(
        jnp.asarray(a8), jnp.asarray(x), jly["o_proj"], jly["mlp_norm"]["w"],
        jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"], jmeta, l, "silu", "rmsnorm",
        site_on=so, osite_on=oso, interpret=True)
    before = fused_otail_block_w4.plain_calls
    out = fused_otail_block_w4(torch.from_numpy(a8), torch.from_numpy(x), ly["o_proj"],
                               ly["mlp_norm"]["w"], ly["mlp_norm"]["b"], ly["w13_proj"],
                               ly["w2"], meta, l, "silu", so, oso)
    assert fused_otail_block_w4.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_w8_otail_forward_matches_jax_forward(strict):
    """KernelConfig(otail_kernel=True) on the W8 pack: B=2, T=8 (M = 16
    through the kernel) against the JAX forward on the same flag."""
    b = _built(8)
    jpol, pol = _policies(b, strict)
    c = b["cfg"]
    t = np.random.default_rng(5).integers(0, c.vocab_size, (2, 8)).astype(np.int32)
    orig = _interpret([(PMLP, "fused_otail_block_stacked")])
    try:
        ref, _ = JE.forward(b["jpacked"], jnp.asarray(t), b["jcfg"], jpol,
                            use_pallas=JKC(otail_kernel=True))
    finally:
        _restore(orig)
    T_ops.reset_counts()
    out, _ = E.forward(b["packed"], torch.from_numpy(t), c, pol,
                       kc=KernelConfig(otail_kernel=True))
    assert T_ops.counts("plain_calls")["fused_otail_block_w4"] == c.num_layers
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def _prefilled(b, jpol, B, Tp, seed):
    c = b["cfg"]
    toks = np.random.default_rng(seed).integers(0, c.vocab_size, (1, Tp)).astype(np.int32)
    prompt = np.repeat(toks, B, 0)
    jcache = JE.init_kv_cache(b["jecfg"], B)
    lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol, kv_cache=jcache,
                            cache_position=jnp.zeros((B,), jnp.int32),
                            kv_valid_len=jnp.full((B,), Tp, jnp.int32))
    first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
    return first, jcache


def _port_chain(b, pol, first, jcache, Tp, n, kc, staging_chunk):
    B = first.shape[0]
    cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                            torch.from_numpy(np.array(jcache.v)))
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, b["cfg"], pol,
                                  kc=kc, staging_chunk=staging_chunk)
    return tt, cache, tl, T_ops.counts("plain_calls")


def test_w8_otail_staged_b3_chain_matches_plain_and_jax():
    """The JAX test's staged chain (B=3, a 4-token prompt, 6 steps, staging
    chunk 4) on the W8 o-tail: its flushed caches equal the port's plain
    chain's bit for bit, as the JAX o-tail chain's equal the JAX plain
    chain's; the port's and the JAX chains then differ only where the two
    plain chains do (here the last step's layer-1 K / V row, by up to 2
    steps: the partwise staged softmax summed in another fp32 order, XLA's
    CPU exp not correctly rounded), with equal greedy tokens."""
    b = _built(8)
    jpol, pol = _policies(b, False)
    B, Tp, n = 3, 4, 6
    first, jcache = _prefilled(b, jpol, B, Tp, 6)
    kc = KernelConfig(otail_kernel=True)
    tt, cache, tl, plain = _port_chain(b, pol, first, jcache, Tp, n, kc, 4)
    assert plain["fused_otail_block_w4"] == n * b["cfg"].num_layers, plain
    rt, rcache, rl, rplain = _port_chain(b, pol, first, jcache, Tp, n, KernelConfig.none(), 4)
    assert not any(rplain.values())
    np.testing.assert_array_equal(tt.numpy(), rt.numpy())
    np.testing.assert_array_equal(cache.k.numpy(), rcache.k.numpy())
    np.testing.assert_array_equal(cache.v.numpy(), rcache.v.numpy())
    np.testing.assert_allclose(tl.numpy(), rl.numpy(), rtol=2e-4, atol=2e-4)
    orig = _interpret([(PMLP, "fused_otail_block_stacked")])
    try:
        jchains = [JE.decode_loop(b["jpacked"], jnp.asarray(first),
                                  JE.EngineKVCache(jcache.k, jcache.v),
                                  jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                  use_pallas=mode, staging_chunk=4)
                   for mode in (JKC(otail_kernel=True), False)]
    finally:
        _restore(orig)
    (jt, jc, jl), (_, jrc, jrl) = jchains
    np.testing.assert_array_equal(np.asarray(jc.k), np.asarray(jrc.k))
    np.testing.assert_array_equal(np.asarray(jc.v), np.asarray(jrc.v))
    np.testing.assert_allclose(np.asarray(jl), np.asarray(jrl), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    for t, j in ((cache.k, jc.k), (cache.v, jc.v)):
        d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32))
        assert d.max() <= 2 and (d > 0).sum() <= 2e-3 * d.size
    assert _rel(tl.numpy(), jl) < 2e-2


def test_w8_otail_b16_serving_chain_matches_jax():
    """KernelConfig.otail() on the W8 pack at B=16 (staged, the o-tail in every
    layer, 128-row gate) against the JAX decode_loop on the same set (the JAX
    default set with stacked_bt_max 128 and otail_kernel): 4 steps in two
    chunks."""
    b = _built(8)
    jpol, pol = _policies(b, False)
    B, Tp, n = 16, 5, 4
    first, jcache = _prefilled(b, jpol, B, Tp, 7)
    tt, cache, tl, plain = _port_chain(b, pol, first, jcache, Tp, n, KernelConfig.otail(), 2)
    L = b["cfg"].num_layers
    assert plain["fused_otail_block_w4"] == n * L and plain["staged_append"] == n, plain
    assert plain["fused_model_w4_chunk"] == plain["fused_mlp_block_w4"] == 0, plain
    orig = _interpret([(PMLP, "fused_otail_block_stacked")])
    try:
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first),
                                    JE.EngineKVCache(jcache.k, jcache.v),
                                    jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                    use_pallas=JKC.default().replace(stacked_bt_max=128,
                                                                     otail_kernel=True),
                                    staging_chunk=2)
    finally:
        _restore(orig)
    _check_chain(tt, cache, tl, jt, jc, jl, slice(Tp, Tp + n))
