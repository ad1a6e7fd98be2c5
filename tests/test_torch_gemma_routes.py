"""Gemma in the port's integer engine (plain versions on the CPU) held
against the JAX engine, on the plain path and the four alternate MLP routes
of the JAX engine: "mlp" (fused_mlp), "mlpblock" (fused_mlp_block), the W8
o-tail (KernelConfig(otail_kernel=True)) and the w2-folded prefill
(gate_kernel + w2fold_kernel).

Model: the gemma_mqa128 shape of tests/test_kernels.py (test-gemma at hidden
256, F 512, 4 q heads over one kv head of head_dim 128, 2 layers: RMSNorm
with the (1 + w) weights, gelu_tanh, the embedding scaled by sqrt(hidden),
the head tied to the embedding), calibrated and packed W8A8 (per-channel
asymmetric) with a W8 head (head_bits 8) by the JAX package. The JAX kernels
run in interpret mode. Tolerances: logits rtol = atol = 2e-4 on a
prefill of B=2, T=8 and a decode step, as the JAX package's own kernel
tests hold each route against its XLA path.
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
from mobilequant_tpu.runtime.kernel_config import KernelConfig as JKC

from mobilequant_tpu_torch import ops as T_ops
from mobilequant_tpu_torch.convert import from_jax_packed
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.quant.policy import default_policy, relax_16bit
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.kernel_config import KernelConfig

S_MAX = 64
WCFG = dict(bitwidth=8, is_per_channel=True, is_symmetric=False)

# route -> (the port's kc, the JAX use_pallas, the wrapper that runs a layer)
ROUTES = {
    "plain": (KernelConfig.none(), False, None),
    "mlp": ("mlp", "mlp", "fused_mlp"),
    "mlpblock": ("mlpblock", "mlpblock", "fused_mlp_block"),
    "otail": (KernelConfig(otail_kernel=True), JKC(otail_kernel=True), "fused_otail_block_w4"),
    "w2fold": (KernelConfig(gate_kernel=True, w2fold_kernel=True),
               JKC(gate_kernel=True, w2fold_kernel=True), "w13_gate_w2"),
}


@functools.lru_cache(maxsize=1)
def _built():
    jcfg = dataclasses.replace(j_get_config("test-gemma"), hidden_size=256,
                               intermediate_size=512, num_heads=4, num_kv_heads=1,
                               head_dim=128, num_layers=2)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jpol = j_default_policy(jcfg, JQC(**WCFG), JQC(bitwidth=8))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(
        calibrate.run_calibration(params, tokens, jcfg, jpol, batch_size=2), jpol)
    jecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=8, head_bits=8)
    jpacked = JE.pack(params, ranges, jcfg, jpol, jecfg)
    cfg = get_config("test-gemma").replace(hidden_size=256, intermediate_size=512,
                                           num_heads=4, num_kv_heads=1, head_dim=128,
                                           num_layers=2)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.tie_word_embeddings and cfg.normalize_embed and cfg.hidden_act == "gelu_tanh"
    pol = default_policy(cfg, QuantConfig(**WCFG), QuantConfig(bitwidth=8))
    return dict(jcfg=jcfg, jpol=jpol, jpacked=jpacked, jecfg=jecfg, tokens=tokens, cfg=cfg,
                pol=pol, ecfg=E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=8),
                packed=from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu"))


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_gemma_w8_route_matches_jax(route, strict):
    b = _built()
    jpol, pol = (b["jpol"], b["pol"]) if strict else (j_relax(b["jpol"]), relax_16bit(b["pol"]))
    c, L = b["cfg"], b["cfg"].num_layers
    kc, jmode, kernel = ROUTES[route]
    assert "head_q" in b["packed"] and b["packed"]["head_q"]["wq"].shape[0] == c.hidden_size
    t = b["tokens"][:2, :8]
    names = ("fused_mlp", "fused_mlp_block", "fused_otail_block_stacked",
             "w13_gate_stacked", "w13_gate_w2_stacked")
    orig = {n: getattr(PMLP, n) for n in names}
    for n, fn in orig.items():
        setattr(PMLP, n, functools.partial(fn, interpret=True))
    try:
        ref, jcache = JE.forward(b["jpacked"], jnp.asarray(t), b["jcfg"], jpol, use_pallas=jmode,
                                 kv_cache=JE.init_kv_cache(b["jecfg"], 2),
                                 cache_position=jnp.zeros((2,), jnp.int32),
                                 kv_valid_len=jnp.full((2,), 8, jnp.int32))
        p = np.full((2,), 8, np.int32)
        nxt = np.asarray(jnp.argmax(ref[:, -1], -1)).astype(np.int32)[:, None]
        ref2, _ = JE.forward(b["jpacked"], jnp.asarray(nxt), b["jcfg"], jpol,
                             positions=jnp.asarray(p)[:, None], kv_cache=jcache,
                             cache_position=jnp.asarray(p), kv_valid_len=jnp.asarray(p + 1),
                             use_pallas=jmode)
    finally:
        for n, fn in orig.items():
            setattr(PMLP, n, fn)
        jax.clear_caches()
    T_ops.reset_counts()
    out, cache = E.forward(b["packed"], torch.from_numpy(t), c, pol, kc=kc,
                           kv_cache=E.init_kv_cache(b["ecfg"], 2, device="cpu"),
                           cache_position=torch.zeros(2, dtype=torch.int32),
                           kv_valid_len=torch.full((2,), 8, dtype=torch.int32))
    plain = T_ops.counts("plain_calls")
    if kernel is None:
        assert not any(plain.values()), plain
    else:
        assert plain[kernel] == L, plain
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(cache.k.numpy(), np.asarray(jcache.k))
    pt = torch.from_numpy(p)
    out2, _ = E.forward(b["packed"], torch.from_numpy(nxt).long(), c, pol, kc=kc,
                        positions=pt[:, None], kv_cache=cache, cache_position=pt,
                        kv_valid_len=pt + 1)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), rtol=2e-4, atol=2e-4)
