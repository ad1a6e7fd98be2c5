"""The chunk kernel's head-dim-256 edition (row 11, Gemma's attention shape:
8 q heads over one kv head of 256) on the CPU, held against the JAX package:
the plain version against the JAX chunk kernel in interpret mode, the
staged serving chains that take it (W4 on KernelConfig.chunk(), W8 on the
entry config) against the JAX decode_loop with its chunk kernel interpreted,
and the chunk gate against the JAX gate on the registry's served models.

Model: the gemma_mqa256 pack of tests/test_torch_gemma256_kernels.py (W4A8/h4
and W8A8/h8, calibrated and packed by the JAX package). Inputs are drawn by a
seeded numpy generator. Tolerances as tests/test_torch_staged.py's hd-64
chunk tests: x_out rtol = atol = 2e-4; kv_new within one quantization step
on at most 0.1% of the bytes (int8_close); logits rel <= 2e-3; a chain's
greedy tokens equal, its caches within int8_close and its last logits rel
<= 2e-3, or 2e-2 where a written K/V byte differs by a step.

One rounding is the frameworks' own: under the strict policy the 16-bit
fake-quant of p = e / den sits on a step boundary for some probability when
den moves by one fp32 ulp, and den is an fp32 sum in the JAX kernel's order
but an fp64 sum rounded once in the port (its kernel's, so that kernel and
plain version agree bit for bit). A sequence whose probabilities are so
placed (den_ulp_rows: the witness, replayed on the port's own layers) may
take the other step, and the step moves its later bytes; it is held as a
decode chain whose K/V byte moved: bytes within 2 steps, logits rel <= 2e-2.
Every other sequence is held to the tolerances above.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.ops import pallas_chunk as PC
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.kernel_config import KernelConfig as JKC

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops import chunk_model as CM
from mobilequant_tpu_torch.ops.chunk_model import (
    chunk_attention_plain, chunk_kernel_supported, fused_model_w4_chunk)
from mobilequant_tpu_torch.ops.fused_layer import layer_tail_plain, qkv_rows_plain
from mobilequant_tpu_torch.ops.mlp_block import sum_f32
from mobilequant_tpu_torch.ops.qops import int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq
from mobilequant_tpu_torch.ops.w4a8_matmul import layer_pack
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_gemma256_kernels import S_MAX, built, int8_close, jmeta_L, policies, rel, rope_cs


@pytest.mark.parametrize("name", ["gemma-2b", "tinyllama-1.1b", "stablelm-2-1.6b"])
def test_chunk_gate_is_the_jax_gate(name):
    """The port's chunk gate equals the JAX chunk_kernel_supported on the
    registry's served models at S 1024 (Gemma-2B's head_dim 256 included),
    and Gemma-2B's attention stage fits shared memory with the hd-256
    layout's 64 q words (8·DPL)."""
    c, jc = get_config(name), j_get_config(name)
    for B in (8, 16, 32, 48, 64, 128, 136):
        assert chunk_kernel_supported(c, 1024, B) == PC.chunk_kernel_supported(jc, 1024, B), B
    assert chunk_kernel_supported(c, 1024, 16) and not chunk_kernel_supported(c, 1024, 136)
    assert CM.chunk_head_dim_ok(c.head_dim_)
    assert CM.chunk_attn_smem(256, 1024, 16, 8) <= CM.SMEM_LIMIT
    assert CM.chunk_qwords(256) == 64 and CM.chunk_qwords(128) == CM.chunk_qwords(64) == 32
    # csrc/fused_rows.cuh AttnLayout at hd 256 (with the Python mirror's 1,152
    # bytes of slack): ys / q8, the cache | staged P·V partials, 64 q words,
    # the scores, the staged cache rows; no grouped stage at hd 256
    assert CM.chunk_attn_smem(256, 1024, 16, 8) == \
        1280 + 24 * 256 + 2 * 8 * 256 * 8 + 4 * 64 + (1024 + 16) * 4 + 256 * 256
    assert [h for h in range(32, 513, 32) if CM.chunk_head_dim_ok(h)] == [32, 64, 96, 128, 256]


def den_ulp_rows(b, pol, x, pos0, cs, kc, vc, kcs, sk, sv, m_st):
    """The sequences of a strict-policy chunk step (the port's plain layers
    replayed) with a probability whose 16-bit fake-quant step changes when
    the softmax denominator moves by one fp32 ulp either way."""
    c, ly = b["cfg"], b["packed"]["layers"]
    Hq, Hkv, hd = c.num_heads, c.num_kv_heads, c.head_dim_
    G, S, B = Hq // Hkv, kc.shape[3], x.shape[0]
    prep = E._kernel_prep(b["packed"], pol, c)
    xt, pos = torch.from_numpy(x), torch.from_numpy(pos0)
    rows = set()
    for l, m in enumerate(prep["meta"].tolist()):
        q8 = qkv_rows_plain(xt, torch.from_numpy(cs), prep["ofq"][l], ly["attn_norm"]["w"][l],
                            ly["attn_norm"]["b"][l], layer_pack(ly["qkv_proj"], l), m, Hq, Hkv,
                            hd, c.rotary_dim)
        qg = q8[:, :Hq * hd].reshape(B, Hkv, G, hd)
        kn = q8[:, Hq * hd:(Hq + Hkv) * hd].reshape(B, Hkv, 1, hd).to(torch.float32)
        oq, ok = np.float32(m[7]) - np.float32(128.0), np.float32(m[9]) - np.float32(128.0)
        sqk, inv = np.float32(m[6]) * np.float32(m[8]), np.float32(1.0 / math.sqrt(hd))
        hdoo = np.float32(hd) * oq * ok

        def logits(k8, ksum, valid):
            raw = int_dot(qg, k8.transpose(-1, -2)) - float(ok) * rowsum_i8(qg) \
                - float(oq) * ksum[:, :, None, :] + float(hdoo)
            mask = torch.where(torch.arange(k8.shape[2])[None] < valid[:, None], 0.0, m[18])
            return _fq(raw * float(sqk), m[12], m[13], m[14]) * float(inv) + mask[:, None, None]

        skl = torch.from_numpy(sk[l])
        lg = torch.cat([logits(torch.from_numpy(kc[l]), torch.from_numpy(kcs[l]), pos.long()),
                        logits(skl, rowsum_i8(skl)[..., 0], torch.full((B,), m_st))], -1)
        s_self = _fq(sum_f32((qg.to(torch.float32) - float(oq)) * (kn - float(ok))) * float(sqk),
                     m[12], m[13], m[14]) * float(inv)
        lg = torch.cat([lg, s_self], -1)
        e = torch.exp(lg - lg.amax(-1, keepdim=True))
        den = sum_f32(e[..., :S]) + e[..., -1:] + sum_f32(e[..., S:-1])
        p = _fq(e / den, m[15], m[16], m[17])
        for to in (math.inf, -math.inf):
            moved = _fq(e / torch.nextafter(den, torch.tensor(to)), m[15], m[16], m[17]) != p
            rows |= set(torch.nonzero(moved.flatten(1).any(1)).flatten().tolist())
        att = chunk_attention_plain(q8, torch.from_numpy(kc[l]), torch.from_numpy(vc[l]),
                                    torch.from_numpy(kcs[l]), skl, torch.from_numpy(sv[l]),
                                    pos, m_st, m, Hq, Hkv, hd, True, True)
        xt = layer_tail_plain(xt, att, layer_pack(ly["o_proj"], l), ly["mlp_norm"]["w"][l],
                              ly["mlp_norm"]["b"][l], layer_pack(ly["w13_proj"], l),
                              layer_pack(ly["w2"], l), m, c.hidden_act)
    return rows


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("m_st", [0, 1])
@pytest.mark.parametrize("wb", [4, 8], ids=["w4h4", "w8h8"])
def test_chunk_hd256_plain_matches_pallas(wb, m_st, strict):
    """Row 11 at hd 256, B = 16: the whole staged step (staggered chunk
    starts, m_st staged columns valid of 2) with the tied head folded."""
    b = built(wb)
    jpol, pol = policies(b, strict)
    c, jly, ly = b["cfg"], b["jpacked"]["layers"], b["packed"]["layers"]
    L, Hkv, hd, B, ncs = c.num_layers, c.num_kv_heads, c.head_dim_, 16, 2
    assert hd == 256 and chunk_kernel_supported(c, S_MAX, B) \
        and PC.chunk_kernel_supported(b["jcfg"], S_MAX, B)
    rng = np.random.default_rng(90 + 4 * wb + 2 * m_st + strict)
    x = rng.normal(size=(B, c.hidden_size)).astype(np.float32)
    kc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    vc = rng.integers(-128, 128, (L, B, Hkv, S_MAX, hd)).astype(np.int8)
    sk = rng.integers(-128, 128, (L, B, Hkv, ncs, hd)).astype(np.int8)
    sv = rng.integers(-128, 128, (L, B, Hkv, ncs, hd)).astype(np.int8)
    kcs = kc.astype(np.int32).sum(-1).astype(np.float32)           # (L, B, Hkv, S)
    pos0 = np.asarray([9, 8, 7, 9] * 4, np.int32)                  # staggered chunk starts
    cs = rope_cs(b, pos0 + m_st)                                   # RoPE at pos0 + m
    qk_on = bool(pol["self_attn.qk_bmm"].output.enabled)
    pv_on = bool(pol["self_attn.pv_bmm"].input.enabled)
    assert qk_on == pv_on == strict
    rx, rkv, rlg = PC.fused_model_w4_chunk(
        jnp.asarray(x), jnp.asarray(pos0), jnp.asarray(cs),
        JE._qkv_ofq_rows_stacked(b["jpacked"], jpol, b["jcfg"]),
        jly["attn_norm"]["w"], jly["attn_norm"]["b"], jly["qkvp"], jly["op"],
        jly["mlp_norm"]["w"], jly["mlp_norm"]["b"], jly["w13_proj"], jly["w2"],
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kcs).reshape(L, B, Hkv, 1, S_MAX),
        jnp.asarray(sk), jnp.asarray(sv), jnp.int32(m_st), jmeta_L(b, jpol),
        b["jpacked"]["head_q"], b["jpacked"]["norm"]["w"], b["jpacked"]["norm"]["b"],
        num_q_heads=c.num_heads, num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim,
        act_kind=c.hidden_act, qk_fq_on=qk_on, pv_fq_on=pv_on,
        site_on=JE._mlp_block_site_on(jpol), interpret=True)
    prep = E._kernel_prep(b["packed"], pol, c)
    before = fused_model_w4_chunk.plain_calls
    ox, okv, olg = fused_model_w4_chunk(
        torch.from_numpy(x), torch.from_numpy(pos0), torch.from_numpy(cs), prep["ofq"],
        ly["attn_norm"], ly["qkv_proj"], ly["o_proj"], ly["mlp_norm"], ly["w13_proj"],
        ly["w2"], torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(kcs),
        torch.from_numpy(sk), torch.from_numpy(sv), m_st, prep["meta"],
        b["packed"]["head_q"], b["packed"]["norm"], num_q_heads=c.num_heads,
        num_kv_heads=Hkv, head_dim=hd, rotary_dim=c.rotary_dim, act_kind=c.hidden_act,
        qk_fq_on=qk_on, pv_fq_on=pv_on)
    assert fused_model_w4_chunk.plain_calls == before + 1
    assert okv.shape == (L, B, 2 * Hkv, hd) and olg.shape == tuple(rlg.shape)
    ox, okv, olg = ox.numpy(), okv.numpy(), olg.numpy()
    rx, rkv, rlg = np.asarray(rx), np.asarray(rkv), np.asarray(rlg)
    near = den_ulp_rows(b, pol, x, pos0, cs, kc, vc, kcs, sk, sv, m_st) if strict else set()
    held = [r for r in range(B) if r not in near]
    np.testing.assert_allclose(ox[held], rx[held], rtol=2e-4, atol=2e-4)
    int8_close(okv[:, held], rkv[:, held])
    assert rel(olg[held], rlg[held]) <= 2e-3
    for r in sorted(near):                      # the witnessed sequences
        d = np.abs(okv[:, r].astype(np.int32) - rkv[:, r].astype(np.int32))
        assert d.max() <= 2 and rel(olg[r], rlg[r]) <= 2e-2, r
    assert len(held) >= B // 2, near


def _interpreted(names):
    orig = [(mod, attr, getattr(mod, attr)) for mod, attr in names]
    for mod, attr, fn in orig:
        setattr(mod, attr, functools.partial(fn, interpret=True))
    return orig


def _restore(orig):
    for mod, attr, fn in orig:
        setattr(mod, attr, fn)
    jax.clear_caches()


@pytest.mark.parametrize("wb", [4, 8], ids=["w4h4_chunk", "w8h8_entry"])
def test_gemma256_b16_chunk_chain_matches_jax_route(wb):
    """A B = 16 staged chain (staging_chunk 2, 4 steps) on the routes where
    the JAX engine takes its chunk kernel: on W8 the entry config
    (decode_loop kc=None, whose W8 chunk gate covers 8 < B <= 48), on W4
    KernelConfig.chunk(). The port takes its chunk kernel too (one call a
    step, no MLP-block call), with the JAX chunk kernel's greedy tokens and
    caches (interpreted)."""
    b = built(wb)
    jpol, pol = policies(b, False)
    c = b["cfg"]
    B, Tp, n = 16, 5, 4
    jmode, kc = (True, None) if wb == 8 else (JKC(chunk_kernel=True), KernelConfig.chunk())
    toks = np.random.default_rng(80 + wb).integers(0, c.vocab_size, (2, Tp)).astype(np.int32)
    prompt = np.tile(toks, (B // 2, 1))
    orig = _interpreted([(PM, "int_linear_pallas_stacked"), (PM, "w4a8_matmul"),
                         (PMLP, "fused_mlp_block_w4_stacked"), (PC, "fused_model_w4_chunk")])
    try:
        jcache = JE.init_kv_cache(b["jecfg"], B)
        lg, jcache = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                                kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                                kv_valid_len=jnp.full((B,), Tp, jnp.int32))
        first = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
        cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                                torch.from_numpy(np.array(jcache.v)))
        jt, jc, jl = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache,
                                    jnp.full((B,), Tp, jnp.int32), n, b["jcfg"], jpol,
                                    use_pallas=jmode, staging_chunk=2)
    finally:
        _restore(orig)
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.full((B,), Tp, dtype=torch.int32), n, c, pol, kc=kc,
                                  staging_chunk=2)
    plain = T_ops.counts("plain_calls")
    assert plain["fused_model_w4_chunk"] == n and plain["fused_mlp_block_w4"] == 0, plain
    assert plain["staged_append"] == n, plain
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    rows = slice(Tp, Tp + n)
    equal = all(np.array_equal(t.numpy()[:, :, :, rows], np.asarray(j)[:, :, :, rows])
                for t, j in ((cache.k, jc.k), (cache.v, jc.v)))
    int8_close(cache.k.numpy(), np.asarray(jc.k))
    int8_close(cache.v.numpy(), np.asarray(jc.v))
    assert rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)
