"""The port's chunked-staging decode (B > 8) and its three kernels (plain
versions on the CPU) held against the JAX package.

Model: the llama_gqa64 shape of tests/test_torch_fused.py (hidden 256, 8 q /
4 kv heads, head_dim 64, 2 layers, max_seq_len 128), packed W4A8 with a W4
head by the JAX package. The JAX kernels run in interpret mode. Tolerances:
fp32 outputs rtol = atol = 2e-4 (the integer dots are exact, fp32 sums are
taken in other orders); int8 outputs within one quantization step on at most
0.1% of the bytes (_int8_close); logits rel <= 2e-3, or 2e-2 on a chain whose
written K/V bytes differ by a step somewhere (XLA's CPU rsqrt / exp / sin are
not correctly rounded; tests/test_torch_fused_model.py measures one step of
a self-term byte at about 1% of these logits).
"""

import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.ops import pallas_chunk as PC
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops.pallas_scatter import staged_append as j_staged_append
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.kernel_config import KernelConfig as JKC

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.ops import chunk_model as CM
from mobilequant_tpu_torch.ops import mlp_block as MB
from mobilequant_tpu_torch.ops.chunk_model import chunk_kernel_supported, fused_model_w4_chunk
from mobilequant_tpu_torch.ops.mlp_block import fused_mlp_block_w4
from mobilequant_tpu_torch.ops.otail import fused_otail_block_w4
from mobilequant_tpu_torch.ops.staged_append import staged_append
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_fused import S_MAX, _built, _int8_close, _jlr, _policies, _rope_cs

ROOT = Path(__file__).resolve().parent.parent


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


@pytest.mark.parametrize("m", [0, 5, 7, 8, 15])
def test_staged_append_plain_matches_pallas(m):
    rng = np.random.default_rng(m)
    L, B, Hkv, cs, hd = 3, 2, 2, 16, 64
    sk, sv = (rng.integers(-128, 128, (L, B, Hkv, cs, hd)).astype(np.int8) for _ in "kv")
    pk, pv = (rng.integers(-128, 128, (L, B, Hkv, 1, hd)).astype(np.int8) for _ in "kv")
    rk, rv = j_staged_append(jnp.asarray(sk), jnp.asarray(sv), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.int32(m), interpret=True)
    tk, tv = torch.from_numpy(sk.copy()), torch.from_numpy(sv.copy())
    before = staged_append.plain_calls
    ok, ov = staged_append(tk, tv, torch.from_numpy(pk), torch.from_numpy(pv), m)
    assert staged_append.plain_calls == before + 1
    assert ok is tk and ov is tv                    # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_staged_append_takes_strided_pending_rows_and_checks_m():
    """The chunk kernel's kv_new (L, B, 2 Hkv, hd) halves are taken as views."""
    rng = np.random.default_rng(1)
    L, B, Hkv, cs, hd = 2, 3, 2, 4, 64
    kv = torch.from_numpy(rng.integers(-128, 128, (L, B, 2 * Hkv, hd)).astype(np.int8))
    sk = torch.zeros((L, B, Hkv, cs, hd), dtype=torch.int8)
    sv = torch.zeros_like(sk)
    staged_append(sk, sv, kv[:, :, :Hkv, None], kv[:, :, Hkv:, None], 2)
    np.testing.assert_array_equal(sk[:, :, :, 2].numpy(), kv[:, :, :Hkv].numpy())
    np.testing.assert_array_equal(sv[:, :, :, 2].numpy(), kv[:, :, Hkv:].numpy())
    assert not sk[:, :, :, [0, 1, 3]].any()
    with pytest.raises(ValueError):
        staged_append(sk, sv, kv[:, :, :Hkv, None], kv[:, :, Hkv:, None], cs)


def test_fused_args_mirror_matches_the_cuda_struct():
    """ops/mlp_block.FusedArgs lays out as MqtFusedArgs: the offsets pinned by
    the static_asserts of csrc/fused_common.cuh."""
    src = (ROOT / "mobilequant_tpu_torch" / "csrc" / "fused_common.cuh").read_text()
    pinned = re.findall(r"static_assert\((\w+)\((\w+)(?:, (\w+))?\) == (\d+)", src)
    assert len(pinned) >= 4
    for fn, struct, field, value in pinned:
        cls = MB.StackedW4 if struct == "MqtStackedW4" else MB.FusedArgs
        got = ctypes.sizeof(cls) if fn == "sizeof" else getattr(cls, field).offset
        assert got == int(value), (fn, struct, field)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_otail_plain_matches_pallas(strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    l, M_ = 1, 16
    rng = np.random.default_rng(3 + strict)
    a8 = rng.integers(-128, 128, (M_, c.num_heads * c.head_dim_)).astype(np.int8)
    x = rng.normal(size=(M_, c.hidden_size)).astype(np.float32)
    jlr = _jlr(b, l)
    jmeta = jnp.concatenate([JE._mlp_block_meta(jlr, jpol, b["jcfg"]),
                             JE._otail_meta_ext(jlr, jpol)])
    lr = E.layer_ranges(b["packed"]["ranges"], l)
    meta = E._mlp_block_meta(lr, pol, c) + E._otail_meta_ext(lr, pol)
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    assert E._otail_site_on(pol) == JE._otail_site_on(jpol)
    site_on = E._mlp_block_site_on(pol)
    # the JAX kernel reads the canonical o_proj pack as the engine hands it
    ref = PMLP.fused_otail_block_stacked(
        jnp.asarray(a8), jnp.asarray(x), jly["o_proj"], jly["mlp_norm"]["w"],
        jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"], jmeta, l, "silu", "rmsnorm",
        site_on=site_on, osite_on=JE._otail_site_on(jpol), interpret=True)
    before = fused_otail_block_w4.plain_calls
    out = fused_otail_block_w4(torch.from_numpy(a8), torch.from_numpy(x), ly["o_proj"],
                               ly["mlp_norm"]["w"], ly["mlp_norm"]["b"], ly["w13_proj"],
                               ly["w2"], meta, l, "silu", site_on, E._otail_site_on(pol))
    assert fused_otail_block_w4.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_mlp_block_plain_matches_pallas_at_128_rows(strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    jly, ly = b["jpacked"]["layers"], b["packed"]["layers"]
    x = np.random.default_rng(128 + strict).normal(size=(128, 256)).astype(np.float32)
    meta = E._mlp_block_meta(E.layer_ranges(b["packed"]["ranges"], 0), pol, b["cfg"])
    site_on = E._mlp_block_site_on(pol)
    ref = PMLP.fused_mlp_block_w4_stacked(
        jnp.asarray(x), jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"],
        jly["w2"], JE._mlp_block_meta(_jlr(b, 0), jpol, b["jcfg"]), 0, "silu", "rmsnorm",
        site_on=site_on, interpret=True)
    before = fused_mlp_block_w4.plain_calls
    out = fused_mlp_block_w4(torch.from_numpy(x), ly["mlp_norm"]["w"], ly["mlp_norm"]["b"],
                             ly["w13_proj"], ly["w2"], meta, 0, "silu", site_on)
    assert fused_mlp_block_w4.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    with pytest.raises(NotImplementedError):
        fused_mlp_block_w4(torch.zeros((129, 256)), ly["mlp_norm"]["w"],
                           ly["mlp_norm"]["b"], ly["w13_proj"], ly["w2"], meta, 0)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("m_st", [0, 1])
def test_chunk_plain_matches_pallas(m_st, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd, B, ncs = c.num_layers, c.num_kv_heads, c.head_dim_, 16, 2
    assert chunk_kernel_supported(c, S_MAX, B) and PC.chunk_kernel_supported(
        b["jcfg"], S_MAX, B)
    rng = np.random.default_rng(10 + 2 * m_st + strict)
    x = rng.normal(size=(B, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    sk = rng.integers(-128, 128, (L, B, Hkv, ncs, hd)).astype(np.int8)
    sv = rng.integers(-128, 128, (L, B, Hkv, ncs, hd)).astype(np.int8)
    kcs = kc.astype(np.int32).sum(-1).astype(np.float32)           # (L, B, Hkv, S)
    pos0 = np.asarray([9, 8, 7, 9] * 4, np.int32)                  # staggered chunk starts
    cs = _rope_cs(b, pos0 + m_st, c.rotary_dim)                    # RoPE at pos0 + m
    qk_on = bool(pol["self_attn.qk_bmm"].output.enabled)
    pv_on = bool(pol["self_attn.pv_bmm"].input.enabled)
    assert qk_on == pv_on == strict
    jmeta = jnp.stack([JE._layer_meta(_jlr(b, l), jpol, b["jcfg"]) for l in range(L)])
    rx, rkv, rlg = PC.fused_model_w4_chunk(
        jnp.asarray(x), jnp.asarray(pos0), jnp.asarray(cs),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"]),
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcs).reshape(L, B, Hkv, 1, S_MAX),
        jnp.asarray(sk), jnp.asarray(sv), jnp.int32(m_st), jmeta, b["jpacked"]["head_q"],
        b["jpacked"]["norm"]["w"], b["jpacked"]["norm"]["b"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, qk_fq_on=qk_on,
        pv_fq_on=pv_on, site_on=JE._mlp_block_site_on(jpol), interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_model_w4_chunk.plain_calls
    ox, okv, olg = fused_model_w4_chunk(
        torch.from_numpy(x), torch.from_numpy(pos0), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(kcs),
        torch.from_numpy(sk), torch.from_numpy(sv), m_st, prep["meta"],
        b["packed"]["head_q"], b["packed"]["norm"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, qk_fq_on=qk_on,
        pv_fq_on=pv_on)
    assert fused_model_w4_chunk.plain_calls == before + 1
    assert okv.shape == (L, B, 2 * Hkv, hd) and olg.shape == tuple(rlg.shape)
    np.testing.assert_allclose(ox.numpy(), np.asarray(rx), rtol=2e-4, atol=2e-4)
    _int8_close(okv.numpy(), np.asarray(rkv))
    assert _rel(olg.numpy(), rlg) <= 2e-3


def _jax_interpret(name_fns):
    """Patch the JAX kernels named in name_fns [(module, attr)] to interpret
    mode; returns the originals for the restore."""
    orig = [(mod, attr, getattr(mod, attr)) for mod, attr in name_fns]
    for mod, attr, fn in orig:
        setattr(mod, attr, functools.partial(fn, interpret=True))
    return orig


def test_staged_decode_chains_match_jax_routes():
    """A staged decode chain at B = 16 (staging_chunk 2, 4 steps: two chunks,
    a flush between them) on three routes against the JAX engine's: the
    port's entry config (decode_loop kc=None) vs decode_loop(use_pallas=True),
    the chunk kernel vs KernelConfig(chunk_kernel=True), the o-tail kernel vs
    "otail". Tokens, flushed caches and the last logits are compared."""
    b = _built()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    B, Tp, n = 16, 5, 4
    toks = np.random.default_rng(7).integers(0, c.vocab_size, (2, Tp)).astype(np.int32)
    prompt = np.tile(toks, (B // 2, 1))
    orig = _jax_interpret([(PM, "int_linear_pallas_stacked"), (PM, "w4a8_matmul"),
                           (PMLP, "fused_mlp_block_w4_stacked"),
                           (PMLP, "fused_otail_block_stacked"),
                           (PC, "fused_model_w4_chunk")])
    try:
        jcache = JE.init_kv_cache(b["jecfg"], B)
        lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                                kv_valid_len=jnp.full((B,), Tp, jnp.int32))
        first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        routes = (("serving", True, None, "fused_mlp_block_w4"),
                  ("chunk", JKC(chunk_kernel=True), KernelConfig(chunk_kernel=True),
                   "fused_model_w4_chunk"),
                  ("otail", "otail", KernelConfig.otail(), "fused_otail_block_w4"))
        for name, jmode, kc, kernel in routes:
            jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first),
                                        JE.EngineKVCache(jcache.k, jcache.v),
                                        jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                        use_pallas=jmode, staging_chunk=2)
            cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                    torch.from_numpy(np.array(jcache.v)))
            T_ops.reset_counts()
            tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                          torch.full((B,), Tp, dtype=torch.int32), n, c,
                                          pol, kc=kc, staging_chunk=2)
            plain = T_ops.counts("plain_calls")
            per_step = 1 if kernel == "fused_model_w4_chunk" else c.num_layers
            assert plain[kernel] == n * per_step, (name, plain)
            assert plain["staged_append"] == n, (name, plain)
            np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
            rows = slice(Tp, Tp + n)
            equal = all(np.array_equal(t.numpy()[:, :, :, rows], np.asarray(j)[:, :, :, rows])
                        for t, j in ((cache.k, jc.k), (cache.v, jc.v)))
            assert _rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2), name
            _int8_close(cache.k.numpy(), np.asarray(jc.k))
            _int8_close(cache.v.numpy(), np.asarray(jc.v))
    finally:
        for mod, attr, fn in orig:
            setattr(mod, attr, fn)
        jax.clear_caches()


def _tiny(B):
    from mobilequant_tpu_torch.convert import build_synthetic_packed
    from mobilequant_tpu_torch.quant.policy import relax_16bit
    packed, cfg, policy, ecfg = build_synthetic_packed("test-llama-256", max_seq_len=64,
                                                       device="cpu")
    policy = relax_16bit(policy)
    prompt = torch.from_numpy(np.random.default_rng(B).integers(
        0, cfg.vocab_size, (B, 6)).astype(np.int64))
    cache = E.init_kv_cache(ecfg, B, device="cpu")
    lg, cache = E.forward(packed, prompt, cfg, policy, kv_cache=cache,
                          cache_position=torch.zeros(B, dtype=torch.int32),
                          kv_valid_len=torch.full((B,), 6, dtype=torch.int32),
                          logits_at=torch.full((B,), 5, dtype=torch.int32))
    first = torch.argmax(lg[:, -1], -1)[:, None]
    return packed, cfg, policy, cache, first


def test_serving_decode_at_128_rows_takes_the_mlp_block_kernel():
    """decode_loop's entry config raises stacked_bt_max to 128 (the JAX
    decode_loop's raise for use_pallas=True), so a B = 128 staged step runs
    the MLP-block kernel in every layer; an explicit KernelConfig.decode()
    keeps its 64-row gate and the split path. Both equal the plain staged
    loop (KernelConfig.none())."""
    packed, cfg, policy, cache0, first = _tiny(128)
    L, B, n = cfg.num_layers, 128, 3
    assert KernelConfig.serving(cfg, packed, B).stacked_bt_max == 128
    assert not KernelConfig.serving(cfg, packed, 32).chunk_kernel      # W4: never
    start = torch.full((B,), 6, dtype=torch.int32)
    res = {}
    for name, kc in (("serving", None), ("decode", KernelConfig.decode()),
                     ("none", KernelConfig.none())):
        cache = E.EngineKVCache(cache0.k.clone(), cache0.v.clone())
        T_ops.reset_counts()
        res[name] = E.decode_loop(packed, first, cache, start, n, cfg, policy, kc=kc,
                                  staging_chunk=2)
        res[name + "_calls"] = T_ops.counts("plain_calls")
    assert res["serving_calls"]["fused_mlp_block_w4"] == n * L
    assert res["decode_calls"]["fused_mlp_block_w4"] == 0
    assert not any(res["none_calls"].values())
    for name in ("serving", "decode"):
        toks, cache, last = res[name]
        np.testing.assert_array_equal(toks.numpy(), res["none"][0].numpy())
        assert _rel(last.numpy(), res["none"][2].numpy()) <= 2e-3
        _int8_close(cache.k.numpy(), res["none"][1].k.numpy())
        _int8_close(cache.v.numpy(), res["none"][1].v.numpy())


def test_chunk_route_on_engine_numerics_equals_plain_staged_chain():
    """chip_smoke's witness for the chunk route against the plain engine path:
    with the plain engine's staged attention and fp32 norms in place of the
    chunk kernel's (chip_smoke.engine_numerics), the chunk route's plain
    version gives the plain staged chain's logits and flushed rows, so what
    differs between the two routes is rounding, not the route's wiring."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    B, n, p0 = 16, 6, 6
    packed, cfg, policy, cache0, _ = _tiny(B)
    L, _, Hkv, _, hd = cache0.k.shape
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (B, n)))
    pos0 = torch.full((B,), p0, dtype=torch.int32)

    def chain(kc):
        cache = E.EngineKVCache(cache0.k.clone(), cache0.v.clone())
        st = E.StagedKVCache(cache.k, cache.v, torch.zeros((L, B, Hkv, n, hd), dtype=torch.int8),
                             torch.zeros((L, B, Hkv, n, hd), dtype=torch.int8), 0,
                             E.kv_colsums(cache.k))
        lgs = []
        for i in range(n):
            st = E._stage_pending(st, kc)
            p = pos0 + i
            lg, st = E.forward(packed, toks[:, i:i + 1], cfg, policy, positions=p[:, None],
                               kv_cache=st, cache_position=pos0, kv_valid_len=p + 1, kc=kc)
            lgs.append(lg[:, -1])
        st = E._stage_pending(st, kc)
        E._flush(cache.k, st.sk, pos0)
        E._flush(cache.v, st.sv, pos0)
        return torch.stack(lgs, 1).numpy(), cache

    plain_lg, plain_c = chain(KernelConfig.none())
    orig = CM.chunk_attention_plain
    with cs.patched(cs.engine_numerics(E, cfg, policy)):
        assert CM.chunk_attention_plain is not orig
        T_ops.reset_counts()
        lg, c = chain(KernelConfig.chunk())
        assert T_ops.counts("plain_calls")["fused_model_w4_chunk"] == n
    assert CM.chunk_attention_plain is orig and MB.rms_norm is not E._rms
    assert _rel(lg, plain_lg) <= 2e-3
    rows = slice(p0, p0 + n)
    for t, r in ((c.k, plain_c.k), (c.v, plain_c.v)):
        np.testing.assert_array_equal(t.numpy()[:, :, :, rows], r.numpy()[:, :, :, rows])


def test_staged_loop_refuses_to_write_past_the_cache():
    packed, cfg, policy, cache, first = _tiny(16)
    with pytest.raises(ValueError, match="pass the cache"):
        E.decode_loop(packed, first, cache, torch.full((16,), 60, dtype=torch.int32), 8,
                      cfg, policy, kc=None)
