"""The port's int4 KV cache and its kv4 decode-attention kernel (plain version
on the CPU) held against the JAX package.

Model: the llama_gqa64 shape of tests/test_torch_fused.py (hidden 256, 8 q /
4 kv heads, head_dim 64, 2 layers), max_seq_len 128 (so S/2 = 64), calibrated
and packed W4A8 with a W4 head by the JAX package under the 4-bit KV policy
(kv_bits_policy(..., 4)). The JAX kv4 kernel runs in interpret mode.
Tolerances: integer helpers bit-exact; the kv4 kernel's plain version (fp64
sums) and the engine's plain twin (fp32 sums in PyTorch's order) against the
JAX ones rtol = atol = 2e-4; a prefill's unpacked caches within one 4-bit
step on at most 0.1% of the values (XLA's CPU rsqrt / exp / sin are not
correctly rounded) and its logits rel <= 2e-3, or 2e-2 where a cache value
differs by a step; decode chains: tokens equal, caches within one step, the
last logits rel <= 2e-3 (2e-2 where a written value differs by a step).
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
from mobilequant_tpu.ops import pallas_kv4 as PKV
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import qops as JQ
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import kv_bits_policy as j_kv_bits_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops import qops as Q
from mobilequant_tpu_torch.ops.kv4_attention import kv4_attn_supported, kv4_decode_attention
from mobilequant_tpu_torch.quant.policy import default_policy, kv_bits_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_staged import _jax_interpret, _rel

S_MAX = 128


def _within_one_step(a, b, max_frac=1e-3):
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert d.max() <= 1, f"max difference {d.max()} steps"
    assert (d > 0).sum() <= max_frac * d.size, f"{(d > 0).sum()} of {d.size} differ"


@functools.lru_cache(maxsize=1)
def _built():
    jcfg = dataclasses.replace(j_get_config("test-llama"), hidden_size=256,
                               intermediate_size=512, num_heads=8, num_kv_heads=4,
                               head_dim=64, num_layers=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpol = j_kv_bits_policy(j_default_policy(
        jcfg, JQC(bitwidth=4, is_per_channel=True, is_symmetric=True), JQC(bitwidth=8)), 4)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=4, head_bits=4,
                            kv_bits=4)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-llama-256").replace(num_heads=8, num_kv_heads=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = kv_bits_policy(default_policy(
        cfg, QuantConfig(bitwidth=4, is_per_channel=True, is_symmetric=True),
        QuantConfig(bitwidth=8)), 4)
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, jecfg=jecfg, cfg=cfg, pol=pol,
                ecfg=E.EngineConfig(model=cfg, max_seq_len=S_MAX, kv_bits=4, head_bits=4),
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


def _policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def _jlr(b, l):
    return jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"])


# (S, staging columns, start positions): a chunk straddling S/2, one wider
# than a nibble plane (it writes both nibbles of some bytes), one-column ticks
@pytest.mark.parametrize("S,cs,starts", [(16, 4, [0, 6, 7, 12]), (16, 10, [0, 3, 6, 5]),
                                         (8, 6, [0, 1, 2, 2]), (64, 1, [0, 31, 32, 63])],
                         ids=["straddle", "cs_over_half", "cs_over_half_tiny", "ticks"])
def test_kv4_qops_bit_exact(S, cs, starts):
    rng = np.random.default_rng(S + cs)
    L, B, Hkv, hd = 2, len(starts), 2, 8
    cache = rng.integers(-128, 128, (L, B, Hkv, hd, S // 2)).astype(np.int8)
    staged = (rng.integers(0, 16, (L, B, Hkv, cs, hd)) - 128).astype(np.int8)
    at = np.asarray(starts, np.int32)
    ref = np.asarray(JQ.kv_flush_packed(jnp.asarray(cache), jnp.asarray(staged),
                                        jnp.asarray(at)))
    t = torch.from_numpy(cache.copy())
    assert Q.kv_flush_packed(t, torch.from_numpy(staged), torch.from_numpy(at)) is t
    np.testing.assert_array_equal(t.numpy(), ref)
    np.testing.assert_array_equal(Q.unpack_kv_s(torch.from_numpy(cache)).numpy(),
                                  np.asarray(JQ.unpack_kv_s(jnp.asarray(cache))))
    np.testing.assert_array_equal(Q.kv_colsums_packed(torch.from_numpy(cache)).numpy(),
                                  np.asarray(JQ.kv_colsums_packed(jnp.asarray(cache))))
    rows = (rng.integers(0, 16, (L, B, Hkv, S, hd)) - 128).astype(np.int8)
    packed = Q.pack_kv_s(torch.from_numpy(rows))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JQ.pack_kv_s(jnp.asarray(rows))))
    np.testing.assert_array_equal(Q.unpack_kv_s(packed).numpy(), rows)
    # per-segment clip bounds: q rows 8-bit, K rows the 4-bit cache bound
    x = (rng.normal(size=(2, 3, 6, hd)) * 4).astype(np.float32)
    qmax = np.asarray([255.0] * 4 + [15.0] * 2, np.float32)[None, None, :, None]
    np.testing.assert_array_equal(
        Q.quantize_act(torch.from_numpy(x), 0.05, 7.0, torch.from_numpy(qmax)).numpy(),
        np.asarray(JQ.quantize_act(jnp.asarray(x), 0.05, 7.0, jnp.asarray(qmax))))


def _attn_inputs(b, B, cs, seed):
    c = b["cfg"]
    L, Hkv, hd, G = c.num_layers, c.num_kv_heads, c.head_dim_, c.num_heads // c.num_kv_heads
    rng = np.random.default_rng(seed)
    BH, S2 = B * Hkv, S_MAX // 2
    return dict(
        q8=rng.integers(-128, 128, (BH, G, hd)).astype(np.int8),
        kp=rng.integers(-128, 128, (L, BH, hd, S2)).astype(np.int8),
        vp=rng.integers(-128, 128, (L, BH, hd, S2)).astype(np.int8),
        sk=(rng.integers(0, 16, (L, BH, cs, hd)) - 128).astype(np.int8),
        sv=(rng.integers(0, 16, (L, BH, cs, hd)) - 128).astype(np.int8),
        kn=(rng.integers(0, 16, (BH, hd)) - 128).astype(np.int8),
        vn=(rng.integers(0, 16, (BH, hd)) - 128).astype(np.int8))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("m_st", [0, 5])
def test_kv4_attention_plain_matches_pallas(m_st, strict):
    b = _built()
    jpol, pol = _policies(b, strict)
    c = b["cfg"]
    Hkv, hd, B, cs, l = c.num_kv_heads, c.head_dim_, 3, 8, 1
    assert kv4_attn_supported(Hkv, S_MAX, hd, B) and PKV.kv4_attn_supported(Hkv, S_MAX, hd, B)
    a = _attn_inputs(b, B, cs, 20 + 2 * m_st + strict)
    L, BH = c.num_layers, B * Hkv
    kcs = Q.kv_colsums_packed(torch.from_numpy(a["kp"]))                 # (L, BH, S)
    pos = np.asarray([9, 70, 64], np.int32)                                # past S/2 = 64
    jmeta = JE._attn_meta(_jlr(b, l), jpol, b["jcfg"])
    meta = E._attn_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, c)
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    qk_on = bool(pol["self_attn.qk_bmm"].output.enabled)
    pv_on = bool(pol["self_attn.pv_bmm"].input.enabled)
    assert qk_on == pv_on == strict
    ref = PKV.kv4_decode_attention(
        jnp.asarray(a["q8"]), jnp.asarray(a["kp"]), jnp.asarray(a["vp"]),
        jnp.asarray(kcs.numpy()).reshape(L, BH, 1, S_MAX), jnp.asarray(a["sk"]),
        jnp.asarray(a["sv"]), jnp.asarray(a["kn"]).reshape(BH, 1, hd),
        jnp.asarray(a["vn"]).reshape(BH, 1, hd), jmeta,
        jnp.repeat(jnp.asarray(pos), Hkv).reshape(BH, 1, 1), m_st, l, num_kv_heads=Hkv,
        head_dim=hd, qk_fq_on=qk_on, pv_fq_on=pv_on, interpret=True)
    before = kv4_decode_attention.plain_calls
    out = kv4_decode_attention(*(torch.from_numpy(a[k]) for k in ("q8", "kp", "vp")), kcs,
                               *(torch.from_numpy(a[k]) for k in ("sk", "sv", "kn", "vn")),
                               meta, torch.from_numpy(pos), m_st, l, qk_fq_on=qk_on,
                               pv_fq_on=pv_on)
    assert kv4_decode_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        kv4_decode_attention(torch.from_numpy(a["q8"]), torch.from_numpy(a["kp"]),
                             torch.from_numpy(a["vp"]), kcs, torch.from_numpy(a["sk"]),
                             torch.from_numpy(a["sv"]), torch.from_numpy(a["kn"]),
                             torch.from_numpy(a["vn"]), meta, torch.from_numpy(pos), cs + 1, l)


@pytest.mark.parametrize("staged", [False, True], ids=["unstaged", "staged"])
def test_kv4_light_attention_matches_jax_twin(staged):
    b = _built()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    Hkv, hd, B, cs, l = c.num_kv_heads, c.head_dim_, 3, 8, 0
    G = c.num_heads // Hkv
    a = _attn_inputs(b, B, cs, 30 + staged)
    kp = a["kp"][l].reshape(B, Hkv, hd, S_MAX // 2)
    vp = a["vp"][l].reshape(B, Hkv, hd, S_MAX // 2)
    q8 = a["q8"].reshape(B, 1, Hkv * G, hd)
    kn, vn = a["kn"].reshape(B, Hkv, 1, hd), a["vn"].reshape(B, Hkv, 1, hd)
    pos = np.asarray([9, 70, 64], np.int32)
    st = {}
    if staged:
        st = dict(ks=a["sk"][l].reshape(B, Hkv, cs, hd), vs=a["sv"][l].reshape(B, Hkv, cs, hd),
                  staged_len=5)
    ref = JE._kv4_decode_light_attention(
        jnp.asarray(q8), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp), jnp.asarray(vp),
        _jlr(b, l)["self_attn.qk_bmm"], _jlr(b, l)["self_attn.pv_bmm"], jpol,
        jnp.asarray(pos), b["jcfg"], B, Hkv, G, hd,
        **{k: (jnp.asarray(v) if k != "staged_len" else v) for k, v in st.items()})
    out = E._kv4_decode_light_attention(
        torch.from_numpy(q8), torch.from_numpy(kn), torch.from_numpy(vn), torch.from_numpy(kp),
        torch.from_numpy(vp), E.layer_ranges(b["packed"]["ranges"], l), pol,
        torch.from_numpy(pos), c, B, Hkv, G, hd,
        **{k: (torch.from_numpy(v) if k != "staged_len" else v) for k, v in st.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def _prefill(b, jpol, pol, prompt, kc=KernelConfig.none()):
    B, Tp = prompt.shape
    jcache = JE.init_kv_cache(b["jecfg"], B)
    jlg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                             kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                             kv_valid_len=jnp.full((B,), Tp, jnp.int32))
    cache = E.init_kv_cache(b["ecfg"], B, device="cpu")
    assert tuple(cache.k.shape) == tuple(jcache.k.shape)      # (L, B, Hkv, hd, S/2)
    lg, cache = E.forward(b["packed"], torch.from_numpy(prompt), b["cfg"], pol,
                          kv_cache=cache, cache_position=torch.zeros(B, dtype=torch.int32),
                          kv_valid_len=torch.full((B,), Tp, dtype=torch.int32), kc=kc)
    return jlg, jcache, lg, cache


def test_kv4_prefill_matches_jax():
    """A prefill into the packed cache (unpack, the int8 program with K / V
    rows clipped at 15, repack) under the prefill kernel set, whose qkv
    epilogue kernel the int4 cache skips."""
    b = _built()
    jpol, pol = _policies(b, False)
    prompt = np.random.default_rng(5).integers(0, b["cfg"].vocab_size, (2, 12)).astype(np.int64)
    T_ops.reset_counts()
    jlg, jcache, lg, cache = _prefill(b, jpol, pol, prompt, KernelConfig.prefill())
    calls = T_ops.counts("plain_calls")
    assert calls["qkv_rope"] == 0 and calls["prefill_attention"] == b["cfg"].num_layers, calls
    equal = True
    for t, j in ((cache.k, jcache.k), (cache.v, jcache.v)):
        u, ju = Q.unpack_kv_s(t).numpy(), np.asarray(JQ.unpack_kv_s(j))
        assert u.max() <= -128 + 15                               # 4-bit values
        _within_one_step(u, ju)
        equal = equal and np.array_equal(u, ju)
    # one step of a 4-bit value (or of an int8 activation after it) moves a
    # later row's logits by ~1e-2 on this random model (measured: 1.2e-2 at
    # 5 + 9 of 131,072 cache values off by a step; the other rows agree to
    # 2e-7)
    assert _rel(lg.numpy(), jlg) <= (2e-3 if equal else 2e-2)


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_kv4_staged_decode_loop_matches_jax(route):
    """A B = 16 staged decode chain on the int4 cache (staging_chunk 2, 4
    steps: two flushes, positions straddling S/2) against the JAX engine's
    decode_loop: the port's entry config vs use_pallas=True (the kv4 kernel
    in every layer and step), KernelConfig.none() vs use_pallas=False."""
    b = _built()
    jpol, pol = _policies(b, False)
    c = b["cfg"]
    L, B, Tp, n = c.num_layers, 16, 5, 4
    toks = np.random.default_rng(7).integers(0, c.vocab_size, (2, Tp)).astype(np.int64)
    prompt = np.tile(toks, (B // 2, 1))
    jmode, kc = (True, None) if route == "kernels" else (False, KernelConfig.none())
    orig = _jax_interpret([(PM, "int_linear_pallas_stacked"), (PM, "w4a8_matmul"),
                           (PMLP, "fused_mlp_block_w4_stacked"),
                           (PKV, "kv4_decode_attention")])
    try:
        jlg, jcache, lg, cache = _prefill(b, jpol, pol, prompt)
        first = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)[:, None]
        start = np.asarray([Tp, 62, 63, Tp] * 4, np.int32)
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache,
                                    jnp.asarray(start), n, b["jcfg"], jpol, use_pallas=jmode,
                                    staging_chunk=2)
        cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                torch.from_numpy(np.array(jcache.v)))
        T_ops.reset_counts()
        tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                      torch.from_numpy(start), n, c, pol, kc=kc,
                                      staging_chunk=2)
        calls = T_ops.counts("plain_calls")
    finally:
        for mod, attr, fn in orig:
            setattr(mod, attr, fn)
        jax.clear_caches()
    want = {"kv4_decode_attention": n * L if route == "kernels" else 0,
            "staged_append": n if route == "kernels" else 0,
            "fused_model_w4": 0, "fused_model_w4_chunk": 0, "qkv_rope": 0}
    assert {k: calls[k] for k in want} == want, calls
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    equal = all(np.array_equal(t.numpy(), np.asarray(j)) for t, j in ((cache.k, jc.k),
                                                                     (cache.v, jc.v)))
    assert _rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)
    for t, j in ((cache.k, jc.k), (cache.v, jc.v)):
        _within_one_step(Q.unpack_kv_s(t).numpy(), np.asarray(JQ.unpack_kv_s(j)))


def test_kv4_staged_loop_matches_stepwise():
    """The port's staged loop on the int4 cache (staged rows, the per-chunk
    nibble merge, packed-byte K column sums) against per-token steps with the
    one-column merge: tokens equal, logits allclose, packed caches bit-equal
    (the JAX package's test_kv4_staged_decode_loop_matches_stepwise)."""
    b = _built()
    _, pol = _policies(b, False)
    c = b["cfg"]
    B, Tp, n = 2, 6, 4
    prompt = np.random.default_rng(9).integers(0, c.vocab_size, (B, Tp)).astype(np.int64)
    ca = E.init_kv_cache(b["ecfg"], B, device="cpu")
    lg, ca = E.forward(b["packed"], torch.from_numpy(prompt), c, pol, kv_cache=ca,
                       cache_position=torch.zeros(B, dtype=torch.int32),
                       kv_valid_len=torch.full((B,), Tp, dtype=torch.int32))
    cb = E.EngineKVCache(ca.k.clone(), ca.v.clone())
    first = torch.argmax(lg[:, -1], -1)[:, None]
    pos = torch.tensor([Tp, 63], dtype=torch.int32)                # one chunk straddles S/2
    kc = KernelConfig.none()
    tk, ca, l_loop = E.decode_loop(b["packed"], first, ca, pos, n, c, pol, kc=kc,
                                   staging_chunk=2)
    tok, cache, p, outs = first, cb, pos, []
    for _ in range(n):
        lg_s, cache = E.forward(b["packed"], tok, c, pol, positions=p[:, None], kv_cache=cache,
                                cache_position=p, kv_valid_len=p + 1, kc=kc)
        tok = torch.argmax(lg_s[:, -1], -1)[:, None]
        outs.append(tok[:, 0])
        p = p + 1
    np.testing.assert_array_equal(tk.numpy(), torch.stack(outs, 1).numpy())
    np.testing.assert_allclose(l_loop.numpy(), lg_s[:, -1].numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(ca.k.numpy(), cache.k.numpy())
    np.testing.assert_array_equal(ca.v.numpy(), cache.v.numpy())
