"""Six query heads a kv head (Qwen2-1.5B's G = 6, head_dim 128): the port's
kernels' plain versions and engine held against the JAX package on the CPU.

Rows 4 (prefill_attention, relaxed and strict), 15 (decode_attention) and 10
(kv4_decode_attention) at G = 6, hd 128 against the JAX Pallas kernels in
interpret mode; the kernels' G = 6 editions (a block's 64 query rows hold
10 positions of each of the 6 heads; the decode kernels' lanes 30 and 31
idle) are held against these plain versions on the card (chip_smoke.py,
scripts/check_decode_attention.py).

Model: test-qwen2 narrowed to hidden 256, F 512, 6 q heads over one kv head
of head_dim 128, 2 layers (RMSNorm, a q/k/v bias, rope theta 1e4), calibrated
and packed W4A8/h4 (per-channel symmetric) by the JAX package, on the int8
cache and under the 4-bit KV policy; the port reads each pack
(convert.from_jax_packed) and packs the int8 one itself (bit-exact). The JAX
engine runs its XLA body. Tolerances as tests/test_torch_engine.py and
tests/test_torch_kv4.py: a prefill's logits rel <= 2e-3 with the caches
equal; decode chains: greedy tokens equal, the caches within one
quantization step on at most 0.1% of the values (XLA's CPU rsqrt / exp /
sin are not correctly rounded, so a written K/V byte may move by one step:
counted), the last logits rel <= 2e-3, or 2e-2 where a cache value differs.
Gates: the port's whole-layer, chunk, kv4, qkv and MLP-block gates equal the
JAX gates at the registry's Qwen2-1.5B, Llama-3-8B and Llama-2-7B.
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
from mobilequant_tpu.ops import pallas_kv4 as PKV
from mobilequant_tpu.ops import pallas_layer as PL
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import pallas_prefill_attention as PP
from mobilequant_tpu.ops import pallas_qkv as PQ
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
from mobilequant_tpu_torch.ops.chunk_model import chunk_kernel_supported
from mobilequant_tpu_torch.ops.decode_attention import decode_attention
from mobilequant_tpu_torch.ops.fused_layer import layer_kernel_supported
from mobilequant_tpu_torch.ops.kv4_attention import kv4_attn_supported, kv4_decode_attention
from mobilequant_tpu_torch.ops.mlp_block import stacked_mlp_supported
from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention
from mobilequant_tpu_torch.ops.qkv_rope import qkv_rope_supported
from mobilequant_tpu_torch.quant.policy import default_policy, kv_bits_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

S_MAX = 64
SHAPE = dict(hidden_size=256, intermediate_size=512, num_heads=6, num_kv_heads=1,
             head_dim=128, num_layers=2)
W4 = dict(bitwidth=4, is_per_channel=True, is_symmetric=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _within_one_step(a, b, max_frac=1e-3):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    assert d.max() <= 1, f"max difference {d.max()} steps"
    assert (d > 0).sum() <= max_frac * d.size, f"{(d > 0).sum()} of {d.size} differ"


@functools.lru_cache(maxsize=2)
def built(kv_bits: int = 8):
    jcfg = dataclasses.replace(j_get_config("test-qwen2"), **SHAPE)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    # the q/k/v biases the JAX init leaves at 0, drawn so the bias is exercised
    rng = np.random.default_rng(5)
    for k in ("q_proj", "k_proj", "v_proj"):
        b0 = params["layers"][k]["b"]
        params["layers"][k]["b"] = jnp.asarray(0.1 * rng.normal(size=b0.shape), b0.dtype)
    jpol = j_kv_bits_policy(j_default_policy(jcfg, JQC(**W4), JQC(bitwidth=8)), kv_bits)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=4, head_bits=4,
                            kv_bits=kv_bits)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-qwen2").replace(**SHAPE)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_heads // cfg.num_kv_heads == 6 and cfg.has_qkv_bias
    pol = kv_bits_policy(default_policy(cfg, QuantConfig(**W4), QuantConfig(bitwidth=8)),
                         kv_bits)
    return dict(jcfg=jcfg, params=params, ranges=ranges, jpol=jpol, jecfg=jecfg,
                jpacked=jpacked, cfg=cfg, pol=pol,
                ecfg=E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=4,
                                    kv_bits=kv_bits),
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


def _policies(b, strict):
    return (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))


def _metas(b, strict, l=1):
    jpol, pol = _policies(b, strict)
    jmeta = JE._attn_meta(jax.tree.map(lambda a: a[l], b["jpacked"]["ranges"]), jpol, b["jcfg"])
    meta = E._attn_meta(E.layer_ranges(b["packed"]["ranges"], l), pol, b["cfg"])
    np.testing.assert_array_equal(np.asarray(meta, np.float32), np.asarray(jmeta))
    return jmeta, meta


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_prefill_attention_g6_plain_matches_pallas(strict):
    """Row 4 at G = 6, hd 128: T = 23 positions (past two of the kernel's
    10-position query tiles) into a 48-row cache, a valid length below T on
    sequence 0."""
    b = built()
    jmeta, meta = _metas(b, strict)
    B, Hkv, G, T_, S, hd = 2, 1, 6, 23, 48, 128
    rng = np.random.default_rng(11 + strict)
    q8 = rng.integers(-128, 128, (B, Hkv, G, T_, hd)).astype(np.int8)
    k8 = rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8)
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
def test_decode_attention_g6_plain_matches_pallas(strict):
    """Row 15 at G = 6, hd 128: three sequences at valid lengths 1, 40, 64."""
    b = built()
    jmeta, meta = _metas(b, strict)
    B, Hkv, G, hd = 3, 1, 6, 128
    rng = np.random.default_rng(21 + strict)
    q8 = rng.integers(-128, 128, (B, Hkv, G, hd)).astype(np.int8)
    k8 = rng.integers(-128, 128, (B, Hkv, S_MAX, hd)).astype(np.int8)
    v8 = rng.integers(-128, 128, (B, Hkv, S_MAX, hd)).astype(np.int8)
    vl = np.asarray([1, 40, S_MAX], np.int32)
    ref = PA.decode_attention(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), jmeta,
                              jnp.asarray(vl), interpret=True)
    before = decode_attention.plain_calls
    out = decode_attention(torch.from_numpy(q8), torch.from_numpy(k8), torch.from_numpy(v8),
                           meta, torch.from_numpy(vl))
    assert decode_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_kv4_attention_g6_plain_matches_pallas(strict):
    """Row 10 at G = 6, hd 128: three sequences at positions on both sides of
    S/2 = 32, five staged columns of eight."""
    b = built(4)
    jmeta, meta = _metas(b, strict)
    c = b["cfg"]
    L, B, Hkv, G, hd, cs, m_st, l = c.num_layers, 3, 1, 6, 128, 8, 5, 1
    BH, S2 = B * Hkv, S_MAX // 2
    assert kv4_attn_supported(Hkv, S_MAX, hd, B) and PKV.kv4_attn_supported(Hkv, S_MAX, hd, B)
    rng = np.random.default_rng(31 + strict)
    a = dict(q8=rng.integers(-128, 128, (BH, G, hd)).astype(np.int8),
             kp=rng.integers(-128, 128, (L, BH, hd, S2)).astype(np.int8),
             vp=rng.integers(-128, 128, (L, BH, hd, S2)).astype(np.int8),
             sk=(rng.integers(0, 16, (L, BH, cs, hd)) - 128).astype(np.int8),
             sv=(rng.integers(0, 16, (L, BH, cs, hd)) - 128).astype(np.int8),
             kn=(rng.integers(0, 16, (BH, hd)) - 128).astype(np.int8),
             vn=(rng.integers(0, 16, (BH, hd)) - 128).astype(np.int8))
    kcs = Q.kv_colsums_packed(torch.from_numpy(a["kp"]))
    pos = np.asarray([9, 40, 32], np.int32)
    ref = PKV.kv4_decode_attention(
        jnp.asarray(a["q8"]), jnp.asarray(a["kp"]), jnp.asarray(a["vp"]),
        jnp.asarray(kcs.numpy()).reshape(L, BH, 1, S_MAX), jnp.asarray(a["sk"]),
        jnp.asarray(a["sv"]), jnp.asarray(a["kn"]).reshape(BH, 1, hd),
        jnp.asarray(a["vn"]).reshape(BH, 1, hd), jmeta,
        jnp.repeat(jnp.asarray(pos), Hkv).reshape(BH, 1, 1), m_st, l, num_kv_heads=Hkv,
        head_dim=hd, qk_fq_on=strict, pv_fq_on=strict, interpret=True)
    before = kv4_decode_attention.plain_calls
    out = kv4_decode_attention(*(torch.from_numpy(a[k]) for k in ("q8", "kp", "vp")), kcs,
                               *(torch.from_numpy(a[k]) for k in ("sk", "sv", "kn", "vn")),
                               meta, torch.from_numpy(pos), m_st, l, qk_fq_on=strict,
                               pv_fq_on=strict)
    assert kv4_decode_attention.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_port_pack_bit_exact_with_jax():
    """engine.pack of the same params and ranges (q/k/v biases drawn, the W4
    head) equals the JAX pack on every canonical key."""
    b = built()
    mine = E.pack(jax.tree.map(np.asarray, b["params"]), jax.tree.map(np.asarray, b["ranges"]),
                  b["cfg"], b["pol"], b["ecfg"], device="cpu")
    ref = b["packed"]
    assert ref["layers"]["qkv_proj"]["bias"].abs().max() > 0
    for name in ("qkv_proj", "o_proj", "w13_proj", "w2", "attn_norm", "mlp_norm"):
        for k, v in ref["layers"][name].items():
            np.testing.assert_array_equal(mine["layers"][name][k].numpy(), v.numpy(),
                                          err_msg=f"{name}.{k}")
    for k in ("head_q", "norm"):
        for kk, v in ref[k].items():
            np.testing.assert_array_equal(mine[k][kk].numpy(), v.numpy(), err_msg=k)
    np.testing.assert_array_equal(mine["embed"].numpy(), ref["embed"].numpy())


def _prefill(b, jpol, pol, prompt, kc):
    B, T = prompt.shape
    jl, jc = JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                        positions=jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                        kv_cache=JE.init_kv_cache(b["jecfg"], B),
                        cache_position=jnp.zeros((B,), jnp.int32),
                        kv_valid_len=jnp.full((B,), T, jnp.int32), use_pallas=False,
                        logits_at=jnp.full((B,), T - 1, jnp.int32))
    tl, tc = E.forward(b["packed"], torch.from_numpy(prompt), b["cfg"], pol,
                       kv_cache=E.init_kv_cache(b["ecfg"], B, device="cpu"),
                       cache_position=torch.zeros(B, dtype=torch.int32),
                       kv_valid_len=torch.full((B,), T, dtype=torch.int32), kc=kc,
                       logits_at=torch.full((B,), T - 1, dtype=torch.int32))
    return jl, jc, tl, tc


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
def test_prefill_matches_jax(strict):
    """A B = 2, T = 37 prefill under KernelConfig.prefill() (the qkv epilogue,
    prefill attention at G = 6 and w13-gate kernels' plain versions) against
    the JAX engine: logits rel <= 2e-3, the int8 caches equal."""
    b = built()
    jpol, pol = _policies(b, strict)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 37)).astype(np.int32)
    T_ops.reset_counts()
    jl, jc, tl, tc = _prefill(b, jpol, pol, prompt, KernelConfig.prefill())
    plain = T_ops.counts("plain_calls")
    L = b["cfg"].num_layers
    assert plain["qkv_rope"] == L and plain["prefill_attention"] == L, plain
    assert _rel(tl.numpy(), jl) <= 2e-3
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))


# (kv bits, batch) -> the port's plain calls a decode step on the entry config
DECODE = {"int8_b1": (8, 1, {"fused_model_w4": 1}),
          "int8_b16": (8, 16, {"fused_mlp_block_w4": 2, "staged_append": 1}),
          "int4_b1": (4, 1, {"kv4_decode_attention": 2, "staged_append": 1}),
          "int4_b16": (4, 16, {"kv4_decode_attention": 2, "staged_append": 1})}


@pytest.mark.parametrize("case", list(DECODE))
def test_decode_loop_matches_jax(case):
    """Four greedy steps of decode_loop on the entry config (B = 1: the
    whole-model kernel; B = 16 and the int4 cache: staged in chunks of two,
    positions ragged) from one prefill's cache, against the JAX engine's
    decode_loop (XLA)."""
    kv_bits, B, per_step = DECODE[case]
    b = built(kv_bits)
    jpol, pol = _policies(b, False)
    c, n, Tp = b["cfg"], 4, 9
    prompt = np.random.default_rng(40 + B).integers(0, c.vocab_size, (B, Tp)).astype(np.int32)
    # the port's plain prefill (equal to the JAX one: test_prefill_matches_jax)
    # starts both loops, which spares a JAX prefill compile a case
    lg, pc = E.forward(b["packed"], torch.from_numpy(prompt), c, pol,
                       kv_cache=E.init_kv_cache(b["ecfg"], B, device="cpu"),
                       cache_position=torch.zeros(B, dtype=torch.int32),
                       kv_valid_len=torch.full((B,), Tp, dtype=torch.int32),
                       kc=KernelConfig.none())
    first = torch.argmax(lg[:, -1], -1).numpy().astype(np.int32)[:, None]
    start = np.asarray(([Tp, 29, 30, Tp + 3] * 4)[:B], np.int32)
    jcache = JE.EngineKVCache(jnp.asarray(pc.k.numpy()), jnp.asarray(pc.v.numpy()))
    jt, jc, jlg = JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache, jnp.asarray(start), n,
                                 b["jcfg"], jpol, use_pallas=False, staging_chunk=2)
    cache = E.EngineKVCache(pc.k.clone(), pc.v.clone())
    T_ops.reset_counts()
    tt, cache, tlg = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                   torch.from_numpy(start), n, c, pol, staging_chunk=2)
    plain = T_ops.counts("plain_calls")
    assert {k: plain[k] for k in per_step} == {k: v * n for k, v in per_step.items()}, plain
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    unpack = (lambda t: Q.unpack_kv_s(t).numpy()) if kv_bits == 4 else (lambda t: t.numpy())
    junpack = (lambda t: np.asarray(JQ.unpack_kv_s(t))) if kv_bits == 4 else np.asarray
    equal = True
    for t, j in ((cache.k, jc.k), (cache.v, jc.v)):
        _within_one_step(unpack(t), junpack(j))
        equal = equal and np.array_equal(unpack(t), junpack(j))
    assert _rel(tlg.numpy(), jlg) <= (2e-3 if equal else 2e-2)


@pytest.mark.parametrize("name", ["qwen2-1.5b", "llama-3-8b", "llama-2-7b"])
def test_gates_match_jax_at_full_width(name):
    """The routing gates at the registry's hd-128 models: the whole-layer /
    whole-model kernel and the chunk kernel by batch at S 1024 and 2048
    (Llama-2-7B's K slab a sequence, 32 kv heads of 128, is 4 MiB at S 1024,
    within the 4 MiB rule, and 8 MiB at S 2048, where it runs the staged
    route), and at S 1024 the kv4 kernel, the qkv epilogue kernel and the MLP-block kernel,
    each equal to the JAX gate."""
    c, jc = get_config(name), j_get_config(name)
    for S in (1024, 2048):
        assert layer_kernel_supported(c, S) == PL.layer_kernel_supported(jc, S) is True
        for B in (8, 16, 32, 128, 136):
            assert chunk_kernel_supported(c, S, B) == PC.chunk_kernel_supported(jc, S, B), B
        assert chunk_kernel_supported(c, S, 32) == (name != "llama-2-7b" or S == 1024)
    S = 1024
    for B in (1, 32):
        assert kv4_attn_supported(c.num_kv_heads, S, c.head_dim_, B) == \
            PKV.kv4_attn_supported(c.num_kv_heads, S, c.head_dim_, B) is True
    Nq, K2w = (c.num_heads + 2 * c.num_kv_heads) * c.head_dim_, c.hidden_size // 2
    assert qkv_rope_supported(Nq, c.head_dim_, c.rotary_dim, K2w) == \
        PQ.qkv_kernel_supported(jc, Nq, K2w) is True
    for wb, jgate in ((4, PMLP.w4_mlp_block_supported), (8, PMLP.w8_mlp_block_supported)):
        assert stacked_mlp_supported(c.hidden_size, c.intermediate_size, wb) == \
            jgate(c.hidden_size, c.intermediate_size) is True
