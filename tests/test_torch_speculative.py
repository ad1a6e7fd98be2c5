"""Greedy generation at an offset, and speculative decoding, of the port held
against the JAX package on the CPU.

The packs are the JAX package's own test packs (tests/test_engine.py's
_build: test-llama, calibrated, W8 per-tensor asymmetric or W4 per-channel
symmetric, S 32; the int4 cache with kv_bits_policy), carried across with
convert.from_jax_packed. The JAX side runs its XLA engine (the CPU backend
takes no Pallas kernel); the port runs its kernel routes, whose wrappers run
their plain versions on CPU tensors: the prefill set, and for the verify
forward (T = k rows at cache_position = pos) the JAX choice "w4nomodelk" on
W4 packs.

  * Generator.generate(sampler=greedy) equals the JAX generate;
  * a T = 4 / 8 forward at cache_position 5 and 16 (the chunked prefill's and
    the verify's shape) equals the JAX forward: logits rel <= 2e-3 at each
    position whose attended cache rows are equal, but for at most one
    position carrying a one-step move of an int8 activation (a one-step
    move, counted, moves this random model's logits by up to ~1%: rel <=
    2e-2 then, and at most T // 2 positions at or after a moved row; the
    test of decode steps in tests/test_torch_engine.py counts the same
    moves, in cache values: the int4 cache is compared unpacked); the
    routes equal the plain engine to 2e-3;
  * the draft proposers equal the JAX ones;
  * generate_speculative and generate_speculative_fast (prompt lookup, a
    random draft, a 2-layer self-draft, EOS) emit the port's greedy chain,
    which equals the JAX speculative streams, with the same
    tokens_per_verify for prompt lookup; the weight-only edition too.
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
from mobilequant_tpu.ops import qops as JQ
from mobilequant_tpu.quant import calibrate
from mobilequant_tpu.quant.policy import default_policy as j_default_policy
from mobilequant_tpu.quant.policy import kv_bits_policy as j_kv_bits_policy
from mobilequant_tpu.quant.quantizer import QuantConfig as JQC
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime import generate as JG
from mobilequant_tpu.runtime import wonly as JW
from mobilequant_tpu.runtime.sampling import SamplerConfig as JSamplerConfig

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed, from_jax_params
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.ops import qops as Q
from mobilequant_tpu_torch.quant.policy import default_policy, kv_bits_policy
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import wonly as W
from mobilequant_tpu_torch.runtime.generate import (
    Generator, _ig_lookup_draft, prompt_lookup_draft)
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig
from mobilequant_tpu_torch.runtime.sampling import SamplerConfig

S_MAX = 32
REPEAT = np.asarray([[7, 3, 9, 4, 7, 3, 9, 4, 7, 3]], np.int32)


@functools.lru_cache(maxsize=None)
def build(w_bits: int, kv_bits: int = 8, name: str = "test-llama", S: int = S_MAX,
          head_bits: int = 16):
    """The JAX package's test pack (tests/test_engine.py's _build) and the port's
    copy of it: dict(j=(cfg, policy, packed, ecfg), t=(cfg, policy, packed,
    ecfg)), made once per argument set."""
    jcfg = j_get_config(name)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    w4 = w_bits == 4
    jpol = j_kv_bits_policy(j_default_policy(
        jcfg, JQC(bitwidth=w_bits, is_per_channel=w4, is_symmetric=w4), JQC(bitwidth=8)), kv_bits)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=4), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S, weight_bits=w_bits, kv_bits=kv_bits,
                            head_bits=head_bits)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config(name)
    pol = kv_bits_policy(default_policy(
        cfg, QuantConfig(bitwidth=w_bits, is_per_channel=w4, is_symmetric=w4),
        QuantConfig(bitwidth=8)), kv_bits)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S, kv_bits=kv_bits, head_bits=head_bits)
    return {"j": (jcfg, jpol, jpacked, jecfg),
            "t": (cfg, pol, from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"), ecfg)}


@pytest.fixture(scope="module", params=[8, 4], ids=["w8", "w4"])
def pack(request):
    return build(request.param)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _gens(b):
    jcfg, jpol, jpacked, jecfg = b["j"]
    cfg, pol, packed, ecfg = b["t"]
    return JG.Generator(jpacked, jcfg, jpol, jecfg), Generator(packed, cfg, pol, ecfg,
                                                               device="cpu")


def test_generate_sampler_greedy_matches_jax(pack):
    jg, g = _gens(pack)
    prompt = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    want = np.asarray(jg.generate(prompt, 10, JSamplerConfig(greedy=True)))
    np.testing.assert_array_equal(g.generate(prompt, 10, sampler=SamplerConfig(greedy=True)),
                                  want)
    np.testing.assert_array_equal(g.generate(prompt, 10, sampler=SamplerConfig(temperature=0.0),
                                             seed=5), want)


@pytest.mark.parametrize("kv_bits", [8, 4], ids=["int8", "int4"])
def test_forward_at_offset_matches_jax(kv_bits):
    """A T > 1 forward at cache_position > 0 (chunked prefill, the verify),
    T = 4 and 8, with row 0 at cache_position 5 and row 1 at 16, over the
    cache the JAX prefill of 16 tokens wrote (so that both packages get the
    same arguments; row 0's prefill rows past 5 + T are masked out by its
    valid length), on the routes that serve it: the prefill set, the
    verify's "w4nomodelk", and the plain engine."""
    b = build(4, kv_bits)
    jcfg, jpol, jpacked, jecfg = b["j"]
    cfg, pol, packed, ecfg = b["t"]
    rng = np.random.default_rng(2)
    B, cp = 2, np.asarray([5, 16], np.int32)
    prompt = rng.integers(0, 256, (B, 16)).astype(np.int32)
    jc0 = JE.init_kv_cache(jecfg, B)
    _, jc0 = JE.forward(jpacked, jnp.asarray(prompt), jcfg, jpol, kv_cache=jc0,
                        cache_position=jnp.zeros((B,), jnp.int32),
                        kv_valid_len=jnp.full((B,), 16, jnp.int32))
    jc0 = jax.tree.map(np.asarray, jc0)
    for T in (4, 8):
        seg = rng.integers(0, 256, (B, T)).astype(np.int32)
        pos = (cp[:, None] + np.arange(T)[None]).astype(np.int32)
        jl, jc = JE.forward(jpacked, jnp.asarray(seg), jcfg, jpol, positions=jnp.asarray(pos),
                            kv_cache=jax.tree.map(jnp.asarray, jc0),
                            cache_position=jnp.asarray(cp), kv_valid_len=jnp.asarray(cp + T))
        jl = np.asarray(jl)
        routes = []
        for kc in (KernelConfig.prefill(), KernelConfig.coerce("w4nomodelk"),
                   KernelConfig.none()):
            c = E.EngineKVCache(torch.from_numpy(np.array(jc0.k)),
                                torch.from_numpy(np.array(jc0.v)))
            tl, c = E.forward(packed, torch.from_numpy(seg), cfg, pol,
                              positions=torch.from_numpy(pos), kv_cache=c,
                              cache_position=torch.from_numpy(cp),
                              kv_valid_len=torch.from_numpy(cp + T), kc=kc)
            assert tl.shape == jl.shape
            diffs = []
            for t_, j_ in ((c.k, jc.k), (c.v, jc.v)):
                if kv_bits == 4:        # the cache values (two a byte), in steps
                    t_, j_ = Q.unpack_kv_s(t_), JQ.unpack_kv_s(j_)
                d = np.abs(t_.numpy().astype(np.int32) - np.asarray(j_).astype(np.int32))
                diffs.append(d)
                assert d.max() <= 1
                assert (d > 0).sum() <= 1e-3 * d.size, (T, kc)
            # per position: rel 2e-3 where no row it attends moved; one
            # position of the 2T may carry a one-step move of an int8
            # activation after the K/V write (XLA's CPU exp / rsqrt; read
            # 3.8e-3 at T = 8 on the int4 cache, on every route alike, with
            # the caches equal); positions at or after their row's first
            # moved cache row may reach 2e-2, at most T // 2 of them
            mv = np.logical_or.reduce([d.any(axis=(0, 2, 4)) for d in diffs])   # (B, S)
            first = np.where(mv.any(-1), mv.argmax(-1), S_MAX)
            after = pos >= first[:, None]                                     # (B, T)
            rel = np.abs(tl.numpy() - jl).max(-1) / np.abs(jl).max()         # (B, T)
            off = rel > 2e-3
            assert rel.max() < 2e-2, (T, kc, rel)
            assert (off & ~after).sum() <= 1 and (off & after).sum() <= T // 2, \
                (T, kc, first, rel)
            routes.append(tl)
        for tl in routes[:2]:       # the kernel routes' plain versions: the plain engine's
            assert _rel(tl.numpy(), routes[2].numpy()) < 2e-3, T


def test_draft_proposers_match_jax():
    rng = np.random.default_rng(3)
    hists = [[1, 2, 3, 1, 2], [5, 5, 5, 5], [9, 8], [4, 1, 4, 1, 4], [1, 2, 1, 2, 3, 1, 2]]
    hists += [list(rng.integers(0, 6, int(n))) for n in rng.integers(3, 30, 12)]
    for n in (1, 3, 5):
        for h in hists:
            want = JG.prompt_lookup_draft(h, n)
            assert prompt_lookup_draft(h, n) == want, (h, n)
            buf = np.zeros(32, np.int32)
            buf[:len(h)] = h
            jd = np.asarray(JG._ig_lookup_draft(jnp.asarray(buf), jnp.int32(len(h)), n))
            td = _ig_lookup_draft(torch.from_numpy(buf.astype(np.int64)),
                                  torch.tensor([len(h)]), n).numpy()
            np.testing.assert_array_equal(td, jd, err_msg=f"{h} {n}")
            assert td.tolist() == want


def test_speculative_matches_greedy_and_jax(pack):
    """Every edition (prompt lookup, a random draft, the 2-layer self-draft,
    EOS) emits the port's greedy chain, which equals the JAX greedy chain;
    on the W8 pack (the JAX tests' pack) the JAX prompt-lookup streams and
    their verify counts are held too. The JAX package's own tests hold its
    self-draft and W4 streams to its greedy chain, so those JAX compiles are
    left out here to keep the file short."""
    jg, g = _gens(pack)
    cfg = pack["t"][0]
    w4 = pack["t"][2]["layers"]["qkv_proj"]["wq"].shape[1] * 2 == cfg.hidden_size
    want = g.generate(REPEAT, 12)[0].tolist()
    assert want == np.asarray(jg.generate(REPEAT, 12, JSamplerConfig(greedy=True)))[0].tolist()

    got, st = g.generate_speculative(REPEAT, 12, k=4, return_stats=True)
    jgot, jst = jg.generate_speculative(REPEAT, 12, k=4, return_stats=True)
    assert got[0].tolist() == want == np.asarray(jgot)[0].tolist()
    assert st["verify_calls"] == jst["verify_calls"] <= 12
    assert st["tokens_per_verify"] == jst["tokens_per_verify"]

    rng = np.random.default_rng(0)
    bad = lambda hist, n: [int(x) for x in rng.integers(0, cfg.vocab_size, n)]
    assert g.generate_speculative(REPEAT, 12, k=4, draft_fn=bad)[0].tolist() == want
    eos = want[5]
    assert g.generate_speculative(REPEAT, 12, k=4, eos_token_id=eos)[0].tolist() == \
        want[:want.index(eos) + 1]

    T_ops.reset_counts()
    fast, fst = g.generate_speculative_fast(REPEAT, 12, k=4, rounds_per_chunk=3,
                                            return_stats=True)
    assert fast[0].tolist() == want
    assert fst["host_syncs"] == -(-fst["verify_calls"] // 3)     # one read-back a chunk
    if not w4:
        jfast, jfst = jg.generate_speculative_fast(REPEAT, 12, k=4, rounds_per_chunk=3,
                                                   return_stats=True)
        assert np.asarray(jfast)[0].tolist() == want
        assert fst["tokens_per_verify"] == jfst["tokens_per_verify"]
        assert fst["verify_calls"] == jfst["verify_calls"]
    else:
        # W4: the verify's rows go through the W4A8 kernel (M = k), as the
        # JAX "w4nomodelk" takes them (test-llama's widths are below the
        # MLP-block kernel's gate)
        assert T_ops.counts("plain_calls")["w4a8_matmul_stacked"] > 0

    # the self-draft edition: the first 2 of 3 layers as the proposer
    sd = g.generate_speculative_fast(REPEAT, 12, k=4, self_draft_layers=2,
                                     rounds_per_chunk=3)
    assert sd[0].tolist() == want
    hsd = g.generate_speculative(REPEAT, 12, k=4, self_draft_layers=2)
    assert hsd[0].tolist() == want
    assert g.generate_speculative_fast(REPEAT, 12, k=4, eos_token_id=eos)[0].tolist() == \
        want[:want.index(eos) + 1]


def test_wonly_speculative_matches_greedy_and_jax():
    """The weight-only edition (tests/test_wonly.py's pack: W4 g16, an 8-bit
    head): generate_speculative / _fast through runtime/wonly.py."""
    jcfg = j_get_config("test-llama")
    params = JM.init_params(jcfg, jax.random.PRNGKey(4))
    jw = JQC(bitwidth=4, is_per_channel=True, group_size=16, is_symmetric=False)
    jpacked = JW.pack_weight_only(params, jcfg, jw, head_bits=8)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, act_bits=16)
    cfg = get_config("test-llama")
    packed = W.pack_weight_only(from_jax_params(jax.tree.map(np.asarray, params), "cpu"), cfg,
                                QuantConfig(bitwidth=4, is_per_channel=True, group_size=16,
                                            is_symmetric=False), head_bits=8)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, act_bits=16)
    jg = JG.Generator(jpacked, jcfg, None, jecfg)
    g = Generator(packed, cfg, None, ecfg, device="cpu")
    want = g.generate(REPEAT, 10)[0].tolist()
    assert want == np.asarray(jg.generate(REPEAT, 10))[0].tolist()
    got, st = g.generate_speculative(REPEAT, 10, k=4, return_stats=True)
    _, jst = jg.generate_speculative(REPEAT, 10, k=4, return_stats=True)
    assert got[0].tolist() == want and st["verify_calls"] == jst["verify_calls"] <= 10
    fast = g.generate_speculative_fast(REPEAT, 10, k=4, rounds_per_chunk=2)
    assert fast[0].tolist() == want


def test_self_draft_cut_pack():
    """SelfDraft's pack is the first N layers (tensors and host ranges), the
    kernel operands made for the full depth left behind."""
    b = build(8)
    cfg, pol, packed, ecfg = b["t"]
    g = Generator(packed, cfg, pol, ecfg, device="cpu")
    g.generate_fast(REPEAT, 2)                       # makes the full pack's kernel_prep
    from mobilequant_tpu_torch.runtime.generate import SelfDraft
    sd = SelfDraft(g, 2)
    assert sd.cfg.num_layers == 2 and "kernel_prep" not in sd.packed
    assert sd.packed["layers"]["qkv_proj"]["wq"].shape[0] == 2
    assert all(so["scale"].shape == (2,) for roles in sd.packed["ranges"].values()
               for so in roles.values())
    assert dataclasses.replace(sd.ecfg, model=cfg) == g.ecfg
