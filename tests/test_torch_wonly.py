"""The port's weight-only (W4A16 / W8A16) serving mode held against the JAX
package: grouped weight quantization, the weight-only linears, the plain
versions of the weight-only kernels (wonly_matmul_stacked, w4a16_matmul)
against the JAX Pallas kernels in interpret mode, pack_weight_only and
runtime/wonly.forward, the kernel / plain decode chain, the Generator, and
the placement policy.

The JAX model's seeded parameters are carried across as numpy
(convert.from_jax_params); activations are fp32 on the CPU, where each
kernel wrapper runs its plain version. Tolerances: integer packs bit-exact;
one weight-only matmul rtol = atol = 1e-4 (the JAX kernel's own test); a
forward's logits rtol 1e-5 / atol 2e-4 (tests/test_wonly.py); the
alternating kernel / plain decode chain against the full forward rtol 1e-4 /
atol 5e-4 (tests/test_wonly.py); greedy tokens equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import model as JM
from mobilequant_tpu.models.registry import MODEL_CONFIGS as J_CONFIGS
from mobilequant_tpu.ops import pallas_matmul as PM
from mobilequant_tpu.ops import qops as JQ
from mobilequant_tpu.quant import policy as JP
from mobilequant_tpu.quant import quantizer as JQZ
from mobilequant_tpu.runtime import engine as JE
from mobilequant_tpu.runtime import wonly as JW
from mobilequant_tpu.runtime.generate import Generator as JGenerator

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import build_synthetic_wonly, from_jax_params
from mobilequant_tpu_torch.models.registry import MODEL_CONFIGS
from mobilequant_tpu_torch.ops import qops as Q
from mobilequant_tpu_torch.ops.wonly_matmul import (
    w4a16_matmul, w4a16_matmul_plain, wonly_matmul_stacked)
from mobilequant_tpu_torch.quant import policy as P
from mobilequant_tpu_torch.quant.quantizer import QuantConfig, fake_quant_weight
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime import wonly as W
from mobilequant_tpu_torch.runtime.generate import Generator
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig


def _wcfg(bits, gs, sym=False, pc=True):
    kw = dict(bitwidth=bits, is_per_channel=pc, group_size=gs, is_symmetric=sym)
    return QuantConfig(**kw), JQZ.QuantConfig(**kw)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_tree_equal(tt, jt, path=""):
    assert set(tt) == set(jt), (path, set(tt) ^ set(jt))
    for k in jt:
        if isinstance(jt[k], dict):
            _assert_tree_equal(tt[k], jt[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(_np(tt[k]), np.asarray(jt[k]), err_msg=f"{path}/{k}")


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("gs", [-1, 16, 32])
def test_grouped_pack_weight_is_bit_exact(bits, gs):
    """pack_weight (wq, scale, offset, colsum) and fake_quant_weight, asymmetric
    and symmetric, per channel or grouped along the input axis."""
    rng = np.random.default_rng(bits * 100 + gs)
    w = rng.normal(size=(128, 96)).astype(np.float32)
    for sym in (False, True):
        tc, jc = _wcfg(bits, gs, sym)
        _assert_tree_equal(Q.pack_weight(torch.from_numpy(w), tc),
                           JQ.pack_weight(jnp.asarray(w), jc), f"bits={bits} gs={gs} sym={sym}")
        np.testing.assert_array_equal(fake_quant_weight(torch.from_numpy(w), tc).numpy(),
                                      np.asarray(JQZ.fake_quant_weight(jnp.asarray(w), jc)))
    if gs != -1:
        assert Q.pack_weight(torch.from_numpy(w), tc)["scale"].shape == (128 // gs, 1, 96)


def test_weight_only_linears_match_jax():
    rng = np.random.default_rng(1)
    K, N, E_ = 64, 48, 3
    x = rng.normal(size=(2, 5, K)).astype(np.float32)
    b = rng.normal(size=(N,)).astype(np.float32)
    for bits, gs in ((4, -1), (4, 16), (8, -1), (8, 32)):
        tc, jc = _wcfg(bits, gs)
        w = rng.normal(size=(K, N)).astype(np.float32)
        tp, jp = Q.pack_weight(torch.from_numpy(w), tc), JQ.pack_weight(jnp.asarray(w), jc)
        np.testing.assert_allclose(
            Q.weight_only_linear(torch.from_numpy(x), tp, torch.from_numpy(b)).numpy(),
            np.asarray(JQ.weight_only_linear(jnp.asarray(x), jp, jnp.asarray(b))),
            rtol=1e-5, atol=1e-5)
        # expert stacks (E, K, N): dispatch form (B, T, K) and expert-axis form
        we = rng.normal(size=(E_, K, N)).astype(np.float32)
        tps = [Q.pack_weight(torch.from_numpy(we[e]), tc) for e in range(E_)]
        tpe = {k: torch.stack([p[k] for p in tps]) for k in ("wq", "scale", "offset")}
        jpe = jax.vmap(lambda wi: JQ.pack_weight(wi, jc))(jnp.asarray(we))
        be = rng.normal(size=(E_, N)).astype(np.float32)
        xe = rng.normal(size=(2, 5, E_, K)).astype(np.float32)
        for xi in (x, xe):
            np.testing.assert_allclose(
                Q.weight_only_expert_linear(torch.from_numpy(xi), tpe, torch.from_numpy(be)).numpy(),
                np.asarray(JQ.weight_only_expert_linear(jnp.asarray(xi), jpe, jnp.asarray(be))),
                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("gs", [-1, 32, "tensor"])
def test_wonly_stacked_plain_matches_pallas(bits, gs):
    """Row 12: wonly_matmul_stacked's plain version (the wrapper on CPU
    tensors) against pallas_matmul.wonly_matmul_stacked(interpret=True), per
    channel, grouped (g32) or per tensor, layers 0 and L−1, M = 1, 2, 8."""
    rng = np.random.default_rng(bits + (0 if gs == "tensor" else gs))
    L, K, N = 3, 128, 256
    tc, jc = (_wcfg(bits, -1, pc=False) if gs == "tensor" else _wcfg(bits, gs))
    ws = rng.normal(size=(L, K, N)).astype(np.float32)
    jpk = jax.vmap(lambda wi: JQ.pack_weight(wi, jc))(jnp.asarray(ws))
    tpk = {k: torch.from_numpy(np.array(jpk[k])) for k in ("wq", "scale", "offset")}
    tp0 = Q.pack_weight(torch.from_numpy(ws[0]), tc)
    for k in ("wq", "scale", "offset"):
        np.testing.assert_array_equal(tp0[k].numpy(), np.asarray(jpk[k][0]))
    bias = rng.normal(size=(L, N)).astype(np.float32)
    for M_ in (1, 2, 8):
        x = rng.normal(size=(M_, K)).astype(np.float32)
        for li in (0, L - 1):
            ref = PM.wonly_matmul_stacked(jnp.asarray(x), jpk["wq"], jpk["scale"],
                                          jpk["offset"], jnp.asarray(bias), li, block_n=128,
                                          interpret=True)
            before = wonly_matmul_stacked.plain_calls
            out = wonly_matmul_stacked(torch.from_numpy(x), tpk["wq"], tpk["scale"],
                                       tpk["offset"], torch.from_numpy(bias), li)
            assert wonly_matmul_stacked.plain_calls == before + 1
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4,
                                       err_msg=f"M={M_} li={li}")
    with pytest.raises(NotImplementedError):
        wonly_matmul_stacked(torch.zeros((9, K)), tpk["wq"], tpk["scale"], tpk["offset"],
                             torch.from_numpy(bias), 0)
    jax.clear_caches()


@pytest.mark.parametrize("sym", [True, False], ids=["sym", "asym"])
def test_w4a16_plain_matches_pallas(sym):
    """Row 13: w4a16_matmul's plain version against
    pallas_matmul.w4a16_matmul(interpret=True) (tests/test_kernels.py's
    shapes), and both against x @ fake_quant_weight(w) + b."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 128)).astype(np.float32)
    w = rng.normal(size=(128, 256)).astype(np.float32)
    b = rng.normal(size=(256,)).astype(np.float32)
    tc, jc = _wcfg(4, -1, sym)
    jpk = JQ.pack_weight(jnp.asarray(w), jc)
    tpk = Q.pack_weight(torch.from_numpy(w), tc)
    ref = PM.w4a16_matmul(jnp.asarray(x), jpk["wq"], jpk["scale"], jpk["offset"],
                          jnp.asarray(b), interpret=True)
    before = w4a16_matmul.plain_calls
    out = w4a16_matmul(torch.from_numpy(x), tpk["wq"], tpk["scale"], tpk["offset"],
                       torch.from_numpy(b))
    assert w4a16_matmul.plain_calls == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    fq = torch.from_numpy(x) @ fake_quant_weight(torch.from_numpy(w), tc) + torch.from_numpy(b)
    np.testing.assert_allclose(out.numpy(), fq.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        w4a16_matmul_plain(torch.from_numpy(x), tpk["wq"], tpk["scale"].reshape(-1),
                           tpk["offset"].reshape(-1), None).numpy(),
        np.asarray(ref) - b, rtol=1e-4, atol=1e-4)
    jax.clear_caches()


def test_wonly_kernels_refuse_foreign_devices():
    """On a device with no kernel (here: meta) the wrappers raise: no plain
    fallback off the CPU."""
    x = torch.zeros((1, 64), device="meta")
    wq = torch.zeros((2, 32, 128), dtype=torch.int8, device="meta")
    sc = torch.ones((2, 1, 128), device="meta")
    with pytest.raises(ValueError):
        wonly_matmul_stacked(x, wq, sc, sc, None, 0)
    with pytest.raises(ValueError):
        w4a16_matmul(x, wq[0], sc[0], sc[0], None)


def _jax_and_port(name, bits, gs, head_bits=16, seed=0):
    jcfg = J_CONFIGS[name]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tc, jc = _wcfg(bits, gs)
    jpacked = JW.pack_weight_only(jp, jcfg, jc, head_bits=head_bits)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    packed = W.pack_weight_only(tp, MODEL_CONFIGS[name], tc, head_bits=head_bits)
    return jcfg, jpacked, MODEL_CONFIGS[name], packed


@pytest.mark.parametrize("name,bits,gs,head_bits", [
    ("test-llama", 4, 16, 16),
    ("test-stablelm", 8, -1, 16),
    ("test-mixtral", 4, 16, 16),     # weight-only MoE expert stacks
    ("test-llama", 8, -1, 8),
    ("test-llama", 4, 32, 4),
    ("test-gemma", 8, -1, 8),        # tied embeddings: the head packed off embed.T
], ids=["llama-w4g16", "stablelm-w8", "mixtral-w4g16", "llama-h8", "llama-w4g32-h4",
        "gemma-tied-h8"])
def test_pack_weight_only_and_forward_match_jax(name, bits, gs, head_bits):
    """pack_weight_only equals the JAX pack leaf for leaf (skeleton, packs,
    head_q), from_jax_params carries the JAX pack across, and
    wonly.forward's logits (plain route, and the kernel route's plain
    versions) match the JAX forward's."""
    jcfg, jpacked, cfg, packed = _jax_and_port(name, bits, gs, head_bits)
    _assert_tree_equal(packed, jax.tree.map(np.asarray, jpacked))
    _assert_tree_equal(from_jax_params(jax.tree.map(np.asarray, jpacked), "cpu"),
                       jax.tree.map(np.asarray, jpacked))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = JW.forward(jpacked, jnp.asarray(toks), jcfg)
    tl, _ = W.forward(packed, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=2e-4)
    # one decode-sized call of the kernel route (rows <= 8: the stacked
    # kernel's plain version for every projection) against the JAX forward
    one = toks[:, :1]
    jl1, _ = JW.forward(jpacked, jnp.asarray(one), jcfg)
    T_ops.reset_counts()
    tl1, _ = W.forward(packed, torch.from_numpy(one), cfg, kc=KernelConfig.decode())
    n_proj = 7 if not cfg.is_moe else 4
    assert wonly_matmul_stacked.plain_calls == n_proj * cfg.num_layers
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=1e-5, atol=2e-4)


def test_wonly_decode_chain_matches_prefill_kernel_and_plain():
    """tests/test_wonly.py's chain: a prefill, then decode steps alternating
    the kernel route (the stacked kernel's plain version) and the plain route,
    against the full forward, and against the JAX chain."""
    jcfg, jpacked, cfg, packed = _jax_and_port("test-llama", 4, 16, seed=1)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=32, act_bits=16)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int64)
    T0 = 6
    cache = W.init_kv_cache(ecfg, 2, device="cpu")
    assert tuple(cache.k.shape) == (cfg.num_layers, 2, 32, cfg.num_kv_heads, cfg.head_dim_)
    lg, cache = W.forward(packed, torch.from_numpy(toks[:, :T0]), cfg,
                          positions=torch.arange(T0)[None].expand(2, T0), kv_cache=cache,
                          cache_position=torch.zeros(2, dtype=torch.int32),
                          kv_valid_len=torch.full((2,), T0))
    outs = [lg[:, -1]]
    T_ops.reset_counts()
    for t in range(T0, 11):
        pos = torch.full((2,), t, dtype=torch.int32)
        lg, cache = W.forward(packed, torch.from_numpy(toks[:, t:t + 1]), cfg,
                              positions=pos[:, None], kv_cache=cache, cache_position=pos,
                              kv_valid_len=pos + 1,
                              kc=KernelConfig.decode() if t % 2 == 0 else KernelConfig())
        outs.append(lg[:, 0])
    assert wonly_matmul_stacked.plain_calls == 3 * 7 * cfg.num_layers     # t = 6, 8, 10
    chain = torch.stack(outs, 1).numpy()
    full, _ = W.forward(packed, torch.from_numpy(toks), cfg)
    np.testing.assert_allclose(chain, full[:, T0 - 1:11].numpy(), rtol=1e-4, atol=5e-4)
    jfull, _ = JW.forward(jpacked, jnp.asarray(toks.astype(np.int32)), jcfg)
    np.testing.assert_allclose(chain, np.asarray(jfull[:, T0 - 1:11]), rtol=1e-4, atol=5e-4)


@pytest.mark.parametrize("B,head_bits", [(1, 16), (2, 16), (1, 4)])
def test_generator_act_bits_16_matches_jax_generator(B, head_bits):
    """Generator(ecfg.act_bits=16) swaps to runtime/wonly.py: generate_fast
    (prefill with no kernel, decode through the stacked kernel's plain
    version and, with the W4 head, the W4A8 kernel's) and generate give the
    JAX Generator's greedy tokens; the policy's KV check is skipped."""
    jcfg, jpacked, cfg, packed = _jax_and_port("test-llama", 4, 16, head_bits, seed=2)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=32, act_bits=16)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=32, act_bits=16)
    prompt = np.random.default_rng(B).integers(0, cfg.vocab_size, (B, 9)).astype(np.int32)
    ref = np.asarray(JGenerator(jpacked, jcfg, None, jecfg).generate_fast(prompt, 6))
    gen = Generator(packed, cfg, None, ecfg, device="cpu")
    T_ops.reset_counts()
    np.testing.assert_array_equal(gen.generate_fast(prompt, 6, chunk=3), ref)
    calls = T_ops.counts("plain_calls")
    assert calls["wonly_matmul_stacked"] == 5 * 7 * cfg.num_layers, calls
    assert calls["w4a8_matmul"] == (5 if head_bits == 4 else 0), calls
    np.testing.assert_array_equal(gen.generate(prompt, 6), ref)


def test_synthetic_wonly_builder_on_cpu():
    """build_synthetic_wonly (what chip_smoke.py serves): bf16 skeleton and
    cache, packs of the asked layout, a Generator that runs."""
    packed, cfg, policy, ecfg = build_synthetic_wonly("test-llama-256", w_bits=4,
                                                      group_size=32, head_bits=4,
                                                      max_seq_len=48, device="cpu")
    L, D = cfg.num_layers, cfg.hidden_size
    assert packed["skeleton"]["embed"]["w"].dtype == torch.bfloat16
    assert tuple(packed["packs"]["q_proj"]["wq"].shape) == (L, D // 2, cfg.q_dim)
    assert tuple(packed["packs"]["q_proj"]["scale"].shape) == (L, D // 32, 1, cfg.q_dim)
    assert "head_q" in packed and ecfg.act_bits == 16 and "lm_head" in policy
    gen = Generator(packed, cfg, policy, ecfg, device="cpu")
    out = gen.generate_fast(np.arange(10)[None] % cfg.vocab_size, 4)
    assert out.shape == (1, 4) and (out >= 0).all() and (out < cfg.vocab_size).all()
    assert gen.init_cache(1).k.dtype == torch.bfloat16


@pytest.mark.parametrize("linears,head_bits", [(3, 16), (3, 4), (2, 8)])
def test_weight_only_policy_matches_jax(linears, head_bits):
    tc, jc = _wcfg(4, 128)
    pol = P.weight_only_policy(
        MODEL_CONFIGS["test-llama"].replace(num_linears_per_mlp=linears), tc, head_bits)
    jpol = JP.weight_only_policy(
        J_CONFIGS["test-llama"].replace(num_linears_per_mlp=linears), jc, head_bits)
    assert P.WEIGHT_ONLY_PROJ_KEYS == JP.WEIGHT_ONLY_PROJ_KEYS
    assert set(pol) == set(jpol)
    for site in jpol:
        for role in ("input", "input2", "weight", "output"):
            a, b = getattr(pol[site], role), getattr(jpol[site], role)
            assert (a is None) == (b is None), (site, role)
            if a is not None:
                assert {f: getattr(a, f) for f in a.__dataclass_fields__} == \
                    {f: getattr(b, f) for f in a.__dataclass_fields__}, (site, role)
