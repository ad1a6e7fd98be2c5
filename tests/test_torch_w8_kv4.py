"""W8A8 packs on the int4 KV cache, and the W8 prefill's kernel set, held
against the JAX package.

Model: the llama_gqa64 shape of tests/test_torch_fused.py (hidden 256, 8 q /
4 kv heads, head_dim 64, F 512, 2 layers, max_seq_len 128, so S/2 = 64),
calibrated and packed W8A8 by the JAX package with its bench's W8 policy
(per-tensor asymmetric weights) and a W8 per-channel head (h8), under the
4-bit KV policy (kv_bits_policy(..., 4)); the W8 prefill test reads the int8
cache pack of tests/test_torch_w8.py. The JAX kernels run in interpret mode;
the port's wrappers run their plain versions on CPU tensors.

Routes (the JAX engine's, which the port mirrors): a W8 kv4 decode step runs
the W8 qkv and o projections on the plain integer matmul, the kv4 attention
kernel (one launch a layer), the W8 MLP-block kernel (up to 128 rows) and
staged_append; a W8 prefill under KernelConfig.prefill() keeps qkv on the
plain integer matmul (the JAX engine takes the qkv epilogue kernel on W4
packs only) and runs the prefill attention and w13+gate kernels.

Tolerances (tests/test_torch_kv4.py, tests/test_torch_w8.py): caches first,
then logits. A 4-bit cache value within one step on at most 0.1% of the
values, int8 rows within one step on at most 0.1% of the bytes (XLA's CPU
rsqrt / exp / sin are not correctly rounded); logits rel <= 2e-3 where the
caches are equal, else 2e-2; greedy tokens equal.
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
from mobilequant_tpu.ops import pallas_mlp as PMLP
from mobilequant_tpu.ops import pallas_prefill_attention as PPA
from mobilequant_tpu.ops import pallas_qkv as PQ
from mobilequant_tpu.ops import qops as JQ
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import kv_bits_policy as j_kv_bits_policy
from mobilequant_tpu.quant.policy import relax_16bit as j_relax
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime.generate import Generator as JGenerator
from mobilequant_tpu.runtime.sampling import SamplerConfig

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops import qops as Q
from mobilequant_tpu_torch.quant.policy import default_policy, kv_bits_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

from test_torch_staged import _jax_interpret, _rel
from test_torch_w8 import W8, _int8_close
from test_torch_w8 import _built as _built_w8

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
    params = JM.init_params(jcfg, jax.random.PRNGKey(2))
    jpol = j_kv_bits_policy(j_default_policy(jcfg, JQC(**W8), JQC(bitwidth=8)), 4)
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=8, head_bits=8,
                            kv_bits=4)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-llama-256").replace(num_heads=8, num_kv_heads=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pol = kv_bits_policy(default_policy(cfg, QuantConfig(**W8), QuantConfig(bitwidth=8)), 4)
    return dict(jcfg=jcfg, jpol=j_relax(jpol), jpacked=jpacked, jecfg=jecfg, cfg=cfg,
                pol=relax_16bit(pol),
                ecfg=E.EngineConfig(model=cfg, max_seq_len=S_MAX, kv_bits=4, head_bits=8),
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


# the JAX kernels of the routes below, run in interpret mode
_PREFILL_KERNELS = [(PPA, "prefill_attention"), (PMLP, "w13_gate_stacked"),
                    (PQ, "qkv_rope_stacked"), (PMLP, "fused_mlp_block_w4_stacked")]
_DECODE_KERNELS = [(PMLP, "fused_mlp_block_w4_stacked"), (PKV, "kv4_decode_attention")]


def _jax_run(name_fns, fn):
    orig = _jax_interpret(name_fns)
    try:
        return fn()
    finally:
        for mod, attr, f in orig:
            setattr(mod, attr, f)
        jax.clear_caches()


def _prefill(b, jpol, pol, prompt, jmode, kc):
    """The same prompt through the JAX forward (use_pallas=jmode, its kernels
    interpreted) and the port's (kc) -> (jax logits, jax cache, logits,
    cache, the port's plain-call counts)."""
    B, Tp = prompt.shape

    def jax_prefill():
        jcache = JE.init_kv_cache(b["jecfg"], B)
        return JE.forward(b["jpacked"], jnp.asarray(prompt), b["jcfg"], jpol,
                          kv_cache=jcache, cache_position=jnp.zeros((B,), jnp.int32),
                          kv_valid_len=jnp.full((B,), Tp, jnp.int32), use_pallas=jmode)
    jlg, jcache = _jax_run(_PREFILL_KERNELS, jax_prefill)
    cache = E.init_kv_cache(b["ecfg"], B, device="cpu")
    assert tuple(cache.k.shape) == tuple(jcache.k.shape)
    T_ops.reset_counts()
    lg, cache = E.forward(b["packed"], torch.from_numpy(prompt), b["cfg"], pol,
                          kv_cache=cache, cache_position=torch.zeros(B, dtype=torch.int32),
                          kv_valid_len=torch.full((B,), Tp, dtype=torch.int32), kc=kc)
    return jlg, jcache, lg, cache, T_ops.counts("plain_calls")


def test_w8_prefill_keeps_qkv_off_the_epilogue_kernel_as_jax():
    """A W8 prefill under KernelConfig.prefill() against the JAX
    forward(use_pallas="attn_gatek"), its kernels interpreted. B·T = 80 > 64,
    so the MLP runs the w13+gate kernel, not the MLP block. The JAX engine
    takes the qkv epilogue kernel on W4 packs only: the W8 qkv runs the
    plain integer matmul, the fake-quant, RoPE and the segment quantization,
    here as there. Logits and the int8 cache bytes are compared."""
    b = _built_w8()
    c = b["cfg"]
    prompt = np.random.default_rng(11).integers(0, c.vocab_size, (2, 40)).astype(np.int64)
    jlg, jcache, lg, cache, calls = _prefill(b, j_relax(b["jpol"]), relax_16bit(b["pol"]),
                                             prompt, "attn_gatek", KernelConfig.prefill())
    L = c.num_layers
    equal = all(np.array_equal(t.numpy(), np.asarray(j)) for t, j in ((cache.k, jcache.k),
                                                                     (cache.v, jcache.v)))
    assert calls["qkv_rope"] == 0, calls
    assert calls["w13_gate"] == L and calls["prefill_attention"] == L, calls
    _int8_close(cache.k.numpy(), np.asarray(jcache.k))
    _int8_close(cache.v.numpy(), np.asarray(jcache.v))
    assert _rel(lg.numpy(), jlg) <= (2e-3 if equal else 2e-2)


def test_w8_kv4_prefill_matches_jax():
    """A W8 prefill into the packed int4 cache under KernelConfig.prefill()
    against the JAX forward(use_pallas="attn_gatek"), as the JAX Generator
    runs it on the card: the prefill attention and w13+gate kernels, qkv on
    the plain integer matmul (the epilogue kernel clips K / V rows at the
    8-bit bound, and is W4-only besides). B·T = 80 > 64: the w13+gate
    kernel, not the MLP block."""
    b = _built()
    prompt = np.random.default_rng(5).integers(0, b["cfg"].vocab_size, (2, 40)).astype(np.int64)
    jlg, jcache, lg, cache, calls = _prefill(b, b["jpol"], b["pol"], prompt, "attn_gatek",
                                             KernelConfig.prefill())
    L = b["cfg"].num_layers
    assert calls["qkv_rope"] == 0 and calls["w13_gate"] == L, calls
    assert calls["prefill_attention"] == L and calls["fused_mlp_block_w4"] == 0, calls
    equal = True
    for t, j in ((cache.k, jcache.k), (cache.v, jcache.v)):
        u, ju = Q.unpack_kv_s(t).numpy(), np.asarray(JQ.unpack_kv_s(j))
        assert u.max() <= -128 + 15                               # 4-bit values
        _within_one_step(u, ju)
        equal = equal and np.array_equal(u, ju)
    assert _rel(lg.numpy(), jlg) <= (2e-3 if equal else 2e-2)


@pytest.mark.parametrize("B", [1, 32, 128])
def test_w8_kv4_decode_loop_matches_jax(B):
    """decode_loop's entry config (kc=None) on the W8/h8 kv4 pack against
    the JAX decode_loop(use_pallas=True), its kv4 and MLP-block kernels
    interpreted, from the same prefill cache: every step staged (two chunks
    of 2 steps, one straddling S/2 where B > 1), each a kv4 launch and a W8
    MLP-block launch a layer and one staged_append, qkv / o / the W8 head on
    the plain integer matmul. Caches first, then the tokens and the last
    logits."""
    b = _built()
    c = b["cfg"]
    L, Tp, n = c.num_layers, 5, 4
    toks = np.random.default_rng(20 + B).integers(0, c.vocab_size, (min(B, 2), Tp))
    prompt = np.tile(toks, (max(B // 2, 1), 1)).astype(np.int64)
    jlg, jcache, _, _, _ = _prefill(b, b["jpol"], b["pol"], prompt, False, KernelConfig.none())
    first = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)[:, None]
    start = np.asarray(([Tp, 62, 63, Tp] * B)[:B], np.int32)

    def jax_decode():
        return JE.decode_loop(b["jpacked"], jnp.asarray(first), jcache, jnp.asarray(start),
                              n, b["jcfg"], b["jpol"], use_pallas=True, staging_chunk=2)
    jt, jc, jl = _jax_run(_DECODE_KERNELS, jax_decode)
    cache = E.EngineKVCache(torch.from_numpy(np.array(jcache.k)),
                            torch.from_numpy(np.array(jcache.v)))
    T_ops.reset_counts()
    tt, cache, tl = E.decode_loop(b["packed"], torch.from_numpy(first).long(), cache,
                                  torch.from_numpy(start), n, c, b["pol"], kc=None,
                                  staging_chunk=2)
    calls = T_ops.counts("plain_calls")
    want = {"kv4_decode_attention": n * L, "fused_mlp_block_w4": n * L, "staged_append": n,
            "fused_model_w4": 0, "fused_model_w4_chunk": 0, "qkv_rope": 0,
            "w8a8_matmul": 0, "w4a8_matmul": 0, "w4a8_matmul_stacked": 0}
    assert {k: calls[k] for k in want} == want, calls
    equal = True
    for t, j in ((cache.k, jc.k), (cache.v, jc.v)):
        u, ju = Q.unpack_kv_s(t).numpy(), np.asarray(JQ.unpack_kv_s(j))
        _within_one_step(u, ju)
        equal = equal and np.array_equal(u, ju)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    assert _rel(tl.numpy(), jl) < (2e-3 if equal else 2e-2)


@pytest.mark.parametrize("B", [1, 2])
def test_w8_kv4_generate_fast_matches_jax_generator(B):
    """Generator.generate_fast on the W8/h8 kv4 pack (the prefill kernel
    set, then decode_loop's entry config) gives the
    JAX Generator's greedy tokens."""
    b = _built()
    c = b["cfg"]
    prompt = np.random.default_rng(40 + B).integers(0, c.vocab_size, (B, 12)).astype(np.int32)
    ref = JGenerator(b["jpacked"], b["jcfg"], b["jpol"], b["jecfg"]).generate(
        prompt, 6, SamplerConfig(greedy=True))
    gen = Generator(b["packed"], c, b["pol"], b["ecfg"], device="cpu")
    T_ops.reset_counts()
    np.testing.assert_array_equal(gen.generate_fast(prompt, 6, chunk=3), ref)
    plain = T_ops.counts("plain_calls")
    L = c.num_layers
    assert plain["kv4_decode_attention"] == 5 * L and plain["fused_model_w4"] == 0, plain
    assert plain["qkv_rope"] == 0 and plain["prefill_attention"] == L, plain
