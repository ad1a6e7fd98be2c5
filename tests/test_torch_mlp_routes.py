"""The JAX engine's alternate MLP routes in the port (plain versions on the
CPU) held against the JAX package: KernelConfig.coerce on the legacy
use_pallas values, the per-layer W8 MLP kernels fused_mlp (row 16) and
fused_mlp_block (row 17, RMSNorm and LayerNorm, the "mxu" and "vpu"
formulations), forward under "mlp", "mlpblock" and "mlpblockvpu", and
Generator(EngineConfig(use_pallas="mlpblock")).generate_fast.

Model: test-llama (hidden 64, F 128, 3 layers), and its gelu_tanh edition,
calibrated and packed W8A8 by the JAX package as its own kernel tests pack
it (tests/test_kernels.py test_fused_mlp_kernel_matches_engine). The JAX
kernels run in interpret mode. Tolerances, the JAX tests' own: the route
against the JAX route rtol = atol = 2e-4 for "mlp", 3e-4 for "mlpblock"; the
int8 g8 of row 16 and its row sums exact; fp32 block outputs of row 17 at
rtol = atol = 3e-4 (fp32 sums in other orders, XLA's CPU rsqrt / exp not
correctly rounded).
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
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.generate import Generator as JGenerator
from mobilequant_tpu.runtime.kernel_config import KernelConfig as JKC

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops.fused_mlp import fused_mlp
from mobilequant_tpu_torch.ops.fused_mlp_block import fused_mlp_block
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4_plain
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

S_MAX = 32

# every legacy token of the JAX coerce docstring, and mixes of them
LEGACY = [False, None, "none", True, "w4", "all", "pad8", "attn", "mlp", "mlpblock",
          "mlpblockvpu", "vpu", "gatek", "w2fold", "otail", "chunkk", "nokv4k", "nomlpk",
          "nolayerk", "nomodelk", "w4_attn_gatek", "attn_gatek", "attn_all", "w4nomodelk",
          "w4nolayerk", "mlp_nomlpk", "mlpblock_nomlpk", "mlp_all", "attn_mlp",
          "attn_mlpblockvpu", "gatek_w2fold", "w4_attn_gatek_w2fold", "otail_nokv4k",
          "chunkk_nomlpk", "w4_otail_nolayerk_nomodelk", "pad8_all_mlpblock"]


@pytest.mark.parametrize("mode", LEGACY, ids=[repr(m) for m in LEGACY])
def test_coerce_matches_the_jax_mapping(mode):
    """Field by field: every flag the port has equals the JAX one (the port
    has every JAX flag but pad8, an XLA tweak, and interpret)."""
    j, t = JKC.coerce(mode), KernelConfig.coerce(mode)
    jf = {f.name for f in dataclasses.fields(JKC)} - {"pad8", "interpret"}
    tf = {f.name for f in dataclasses.fields(KernelConfig)}
    assert jf == tf
    for name in sorted(tf):
        assert getattr(t, name) == getattr(j, name), name
    assert t.any_kernel == j.any_kernel


def test_coerce_keeps_a_kernel_config_and_serving_raises_legacy_values():
    kc = KernelConfig(mlp_kernel=True)
    assert KernelConfig.coerce(kc) is kc
    assert KernelConfig.coerce(True) == KernelConfig.decode()
    cfg = get_config("test-llama")
    w8 = {"layers": {"w13_proj": {"wq": torch.zeros((1, cfg.hidden_size, 8), dtype=torch.int8)}}}
    w4 = {"layers": {"w13_proj": {"wq": torch.zeros((1, cfg.hidden_size // 2, 8),
                                                    dtype=torch.int8)}}}
    # the JAX decode_loop's coercion: bt raised to 128; the chunk kernel beside
    # the whole-model kernel for W8 packs at 8 < B <= 48 only (so the legacy
    # "otail" string takes the chunk kernel there, as in the JAX engine; an
    # alternate route switches the whole-model kernel off)
    for mode in (True, "mlp", "mlpblock", "mlpblockvpu", "otail"):
        s = KernelConfig.serving(cfg, w8, 32, mode)
        assert s.stacked_bt_max == 128
        assert s.chunk_kernel == (mode in (True, "otail"))
        assert s.replace(stacked_bt_max=64, chunk_kernel=False) \
            == KernelConfig.coerce(mode).replace(chunk_kernel=False)
    assert not KernelConfig.serving(cfg, w8, 64).chunk_kernel
    assert not KernelConfig.serving(cfg, w4, 32).chunk_kernel


@functools.lru_cache(maxsize=2)
def _built(act="silu"):
    """test-llama (or its gelu_tanh edition) calibrated and packed W8A8 by the
    JAX package, read by the port."""
    jcfg = dataclasses.replace(j_get_config("test-llama"), hidden_act=act)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpol = j_default_policy(jcfg, JQC(bitwidth=8), JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-llama").replace(hidden_act=act)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = default_policy(cfg, QuantConfig(bitwidth=8), QuantConfig(bitwidth=8))
    packed = from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu")
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, jecfg=jecfg, tokens=tokens, cfg=cfg,
                pol=pol, packed=packed, ecfg=E.EngineConfig(model=cfg, max_seq_len=S_MAX))


def _policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def _layer(b, l):
    """(JAX per-layer w13 / w2 packs, port ones) of layer l."""
    jly, ly = b["jpacked"]["layers"], b["packed"]["layers"]
    jp = {k: jax.tree.map(lambda a: a[l], jly[k]) for k in ("w13_proj", "w2")}
    return jp, {k: layer_pack(ly[k], l) for k in ("w13_proj", "w2")}


def _metas(b, jpol, pol, l):
    lr = E.layer_ranges(b["packed"]["ranges"], l)
    meta = E._mlp_block_meta(lr, pol, b["cfg"])
    jmeta = JE._mlp_block_meta(jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"]), jpol,
                               b["jcfg"])
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    return meta


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_fused_mlp_plain_matches_pallas(act, strict):
    """Row 16: the raw Σ g8·w2 and the g8 row sums equal the JAX kernel's."""
    b = _built(act)
    jpol, pol = _policies(b, strict)
    l, M_ = 1, 16
    jp, tp = _layer(b, l)
    meta = _metas(b, jpol, pol, l)[:16]
    h8 = np.random.default_rng(3 + strict).integers(-128, 128, (M_, 64)).astype(np.int8)
    ref_acc, ref_rsum = PMLP.fused_mlp(jnp.asarray(h8), jp["w13_proj"], jp["w2"],
                                       jnp.asarray(meta, jnp.float32), act, interpret=True)
    before = fused_mlp.plain_calls
    acc, rsum = fused_mlp(torch.from_numpy(h8), tp["w13_proj"], tp["w2"], meta, act)
    assert fused_mlp.plain_calls == before + 1
    np.testing.assert_array_equal(rsum.numpy(), np.asarray(ref_rsum))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ref_acc))


@pytest.mark.parametrize("norm_kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("act", ["silu", "gelu_tanh"])
def test_fused_mlp_block_plain_matches_pallas(act, strict, norm_kind):
    """Row 17 on RMSNorm and LayerNorm, M = 1 (mxu and vpu, bit-identical) and
    M = 200 (two of the CUDA kernel's 128-row tiles)."""
    b = _built(act)
    jpol, pol = _policies(b, strict)
    l = 2
    jp, tp = _layer(b, l)
    meta = _metas(b, jpol, pol, l)
    rng = np.random.default_rng(11 + strict)
    nw = (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32)
    nb = (0.05 * rng.normal(size=64)).astype(np.float32)
    for M_ in (1, 200):
        x = rng.normal(size=(M_, 64)).astype(np.float32) * 2.0
        ref = PMLP.fused_mlp_block(jnp.asarray(x), jnp.asarray(nw), jnp.asarray(nb),
                                   jp["w13_proj"], jp["w2"], jnp.asarray(meta, jnp.float32),
                                   act, norm_kind, interpret=True)
        before = fused_mlp_block.plain_calls
        out = fused_mlp_block(torch.from_numpy(x), torch.from_numpy(nw), torch.from_numpy(nb),
                              tp["w13_proj"], tp["w2"], meta, act, norm_kind)
        assert fused_mlp_block.plain_calls == before + 1
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-4, atol=3e-4)
        if M_ == 1:
            vpu = fused_mlp_block(torch.from_numpy(x), torch.from_numpy(nw),
                                  torch.from_numpy(nb), tp["w13_proj"], tp["w2"], meta, act,
                                  norm_kind, mm_kind="vpu")
            np.testing.assert_array_equal(vpu.numpy(), out.numpy())
            jvpu = PMLP.fused_mlp_block(jnp.asarray(x), jnp.asarray(nw), jnp.asarray(nb),
                                        jp["w13_proj"], jp["w2"],
                                        jnp.asarray(meta, jnp.float32), act, norm_kind,
                                        interpret=True, mm_kind="vpu")
            np.testing.assert_allclose(vpu.numpy(), np.asarray(jvpu), rtol=3e-4, atol=3e-4)
    with pytest.raises(ValueError):
        fused_mlp_block(torch.zeros((2, 64)), torch.from_numpy(nw), torch.from_numpy(nb),
                        tp["w13_proj"], tp["w2"], meta, act, norm_kind, mm_kind="vpu")


def test_fused_mlp_block_shares_the_stacked_block_contract():
    """Row 17 runs the stacked MLP-block row kernel's body (runtime qmax sites)
    on the layer's packs: its plain version equals the stacked block's plain
    version with every static site on, on the same inputs, also where sites
    are switched off by qmax 0 (the strict policy's sites off one by one)."""
    b = _built()
    l = 1
    _, tp = _layer(b, l)
    ly = b["packed"]["layers"]
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], l), b["pol"], b["cfg"])
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(9, 64)).astype(np.float32))
    for off in (None, 4, 7, 10, 13, 18, 22, 25, 28, 31):
        m = list(meta)
        if off is not None:
            m[off] = 0.0
        a = fused_mlp_block(x, ly["mlp_norm"]["w"][l], ly["mlp_norm"]["b"][l],
                            tp["w13_proj"], tp["w2"], m)
        s = fused_mlp_block_w4_plain(x, ly["mlp_norm"]["w"][l], ly["mlp_norm"]["b"][l],
                                     tp["w13_proj"], tp["w2"], m, "silu", (True,) * 9)
        np.testing.assert_array_equal(a.numpy(), s.numpy())


def _interpret(*names):
    orig = {n: getattr(PMLP, n) for n in names}
    for n, fn in orig.items():
        setattr(PMLP, n, functools.partial(fn, interpret=True))
    return orig


def _restore(orig):
    for n, fn in orig.items():
        setattr(PMLP, n, fn)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("route,kernel,tol", [("mlp", "fused_mlp", 2e-4),
                                              ("mlpblock", "fused_mlp_block", 3e-4)])
def test_forward_route_matches_jax_forward(route, kernel, tol, strict):
    """forward(kc=legacy value) against the JAX forward(use_pallas=the same
    value) with its kernel interpreted: a B=2, T=8 pass (the JAX test's) and
    one cached B=1 decode step, which under "mlpblockvpu" takes the vpu
    formulation."""
    b = _built()
    jpol, pol = _policies(b, strict)
    c, t = b["cfg"], b["tokens"][:2, :8]
    orig = _interpret("fused_mlp", "fused_mlp_block")
    try:
        ref, _ = JE.forward(b["jpacked"], jnp.asarray(t), b["jcfg"], jpol, use_pallas=route)
        T_ops.reset_counts()
        out, _ = E.forward(b["packed"], torch.from_numpy(t), c, pol, kc=route)
        assert T_ops.counts("plain_calls")[kernel] == c.num_layers
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)
        for mode in (route, route + "vpu") if route == "mlpblock" else (route,):
            jc = JE.init_kv_cache(b["jecfg"], 1)
            tc = E.init_kv_cache(b["ecfg"], 1, device="cpu")
            p0 = np.zeros((1,), np.int32)
            _, jc = JE.forward(b["jpacked"], jnp.asarray(t[:1, :6]), b["jcfg"], jpol,
                               kv_cache=jc, cache_position=jnp.asarray(p0),
                               kv_valid_len=jnp.full((1,), 6, jnp.int32))
            tc = E.EngineKVCache(torch.from_numpy(np.array(jc.k)),
                                 torch.from_numpy(np.array(jc.v)))
            p = np.full((1,), 6, np.int32)
            jl, _ = JE.forward(b["jpacked"], jnp.asarray(t[:1, 6:7]), b["jcfg"], jpol,
                               positions=jnp.asarray(p)[:, None], kv_cache=jc,
                               cache_position=jnp.asarray(p), kv_valid_len=jnp.asarray(p + 1),
                               use_pallas=mode)
            T_ops.reset_counts()
            pt = torch.from_numpy(p)
            tl, _ = E.forward(b["packed"], torch.from_numpy(t[:1, 6:7]), c, pol,
                              positions=pt[:, None], kv_cache=tc, cache_position=pt,
                              kv_valid_len=pt + 1, kc=mode)
            assert T_ops.counts("plain_calls")[kernel] == c.num_layers
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    finally:
        _restore(orig)
        jax.clear_caches()


@pytest.mark.parametrize("mode,kernel", [("mlpblock", "fused_mlp_block"), ("mlp", "fused_mlp")])
def test_generator_on_an_alternate_route_matches_the_jax_generator(mode, kernel):
    """Generator(ecfg=EngineConfig(use_pallas=mode)).generate_fast decodes on
    that route (staged, no whole-step kernel) and gives the greedy tokens of
    the JAX Generator with the same use_pallas (its kernel interpreted)."""
    b = _built()
    jpol, pol = _policies(b, False)
    c, L = b["cfg"], b["cfg"].num_layers
    prompt = np.random.default_rng(9).integers(0, c.vocab_size, (2, 7)).astype(np.int32)
    orig = _interpret("fused_mlp", "fused_mlp_block")
    try:
        jgen = JGenerator(b["jpacked"], b["jcfg"], jpol,
                          dataclasses.replace(b["jecfg"], use_pallas=mode))
        ref = jgen.generate_fast(prompt, 5, chunk=2)
    finally:
        _restore(orig)
        jax.clear_caches()
    gen = Generator(b["packed"], c, pol, dataclasses.replace(b["ecfg"], use_pallas=mode),
                    device="cpu")
    T_ops.reset_counts()
    np.testing.assert_array_equal(gen.generate_fast(prompt, 5, chunk=2), ref)
    plain = T_ops.counts("plain_calls")
    assert plain[kernel] == 4 * L and plain["staged_append"] == 4, plain
    assert plain["fused_model_w4"] == plain["fused_mlp_block_w4"] == 0, plain
