"""The port's sampler (runtime/sampling.py) held against the JAX package's on
the CPU.

torch's generator is not JAX's PRNG, so drawn tokens differ between the
packages. What is held exactly: the set of logits that survive temperature,
top-k and top-p (read off the JAX functions by catching the logits they hand
to jax.random.categorical), greedy and temperature-0 rows (the argmax), and
sample_batched against sample row by row. The draws are held by their
frequencies over 20,000 seeded draws (chi-square against the filtered
softmax) and by repeating under a seed. The logits carry planted ties at the
top-k boundary and top-p thresholds that fall between cumulative masses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy import stats

from mobilequant_tpu.runtime import sampling as JS

from mobilequant_tpu_torch.convert import build_synthetic_packed
from mobilequant_tpu_torch.quant.policy import relax_16bit
from mobilequant_tpu_torch.runtime import engine as E
from mobilequant_tpu_torch.runtime.sampling import (
    SamplerConfig, filter_logits, filter_logits_batched, loop_next_token, sample,
    sample_batched, sampler_arrays)

V = 48
CONFIGS = [SamplerConfig(temperature=0.7),
           SamplerConfig(temperature=1.3, top_k=5),
           SamplerConfig(temperature=1.0, top_k=1),
           SamplerConfig(temperature=0.9, top_p=0.5),
           SamplerConfig(temperature=1.0, top_p=0.93),
           SamplerConfig(temperature=1.0, top_k=7, top_p=0.8),
           SamplerConfig(temperature=0.5, top_k=12, top_p=0.97)]


def _logits(B=6, seed=0):
    """Rows on a half-integer grid (many exact ties), each with a planted tie
    at ranks 4 and 5 (the top_k=5 boundary) and at ranks 0 and 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 8, (B, V)).astype(np.float32) / 2
    for r in range(B):
        order = np.argsort(-x[r], kind="stable")
        x[r, order[1]] = x[r, order[0]]
        x[r, order[5]] = x[r, order[4]]
    return x


def _jax_kept(fn, *args):
    """The finite entries of the logits `fn` hands to jax.random.categorical
    (the JAX package's filtered logits), with jit off so that they are
    concrete."""
    seen = []

    def spy(key, logits, axis=-1):
        seen.append(np.asarray(logits))
        return jnp.argmax(logits, axis=axis)

    orig = jax.random.categorical
    jax.random.categorical = spy
    try:
        with jax.disable_jit():
            fn(*args)
    finally:
        jax.random.categorical = orig
    return np.isfinite(seen[-1])


def _margin(x, cfgs):
    """The smallest distance of a top-p threshold from a descending
    cumulative mass it is compared with (float64), over the rows."""
    out = np.inf
    for row, c in zip(x, cfgs):
        if c.top_p >= 1.0:
            continue
        z = np.sort(row.astype(np.float64) / c.temperature)[::-1]
        p = np.exp(z - z.max())
        p /= p.sum()
        out = min(out, np.abs(np.cumsum(p) - p - c.top_p).min())
    return out


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"t{c.temperature}-k{c.top_k}-p{c.top_p}")
def test_sample_kept_set_matches_jax(cfg):
    x = _logits()
    assert _margin(x, [cfg] * len(x)) > 1e-4
    want = _jax_kept(JS.sample, jnp.asarray(x), jax.random.PRNGKey(0), cfg)
    got = torch.isfinite(filter_logits(torch.from_numpy(x), cfg)).numpy()
    np.testing.assert_array_equal(got, want)
    if cfg.top_k == 5 and cfg.top_p >= 1.0:
        assert (got.sum(1) >= 6).all()          # the planted tie at rank 4 / 5 is kept
    toks = sample(torch.from_numpy(x), torch.Generator().manual_seed(1), cfg).numpy()
    assert got[np.arange(len(x)), toks].all()


def test_sample_batched_kept_set_matches_jax():
    x = _logits(B=len(CONFIGS) + 2, seed=1)
    cfgs = CONFIGS + [SamplerConfig(greedy=True), SamplerConfig(temperature=0.0)]
    assert _margin(x, cfgs) > 1e-4
    arrs = sampler_arrays(cfgs)
    want = _jax_kept(JS.sample_batched, jnp.asarray(x), jax.random.PRNGKey(0),
                     *(jnp.asarray(a) for a in arrs))
    got = torch.isfinite(filter_logits_batched(torch.from_numpy(x), *arrs[:3])).numpy()
    np.testing.assert_array_equal(got, want)
    toks = sample_batched(torch.from_numpy(x), torch.Generator().manual_seed(2), *arrs).numpy()
    arg = x.argmax(-1)
    assert toks[-2] == arg[-2] and toks[-1] == arg[-1]        # greedy / temperature 0
    assert got[np.arange(len(x)), toks].all()
    jt = np.asarray(JS.sample_batched(jnp.asarray(x), jax.random.PRNGKey(0),
                                      *(jnp.asarray(a) for a in arrs)))
    assert jt[-2] == toks[-2] and jt[-1] == toks[-1]


@pytest.mark.parametrize("cfg", [SamplerConfig(greedy=True), SamplerConfig(temperature=0.0)]
                         + CONFIGS, ids=lambda c: f"g{int(c.greedy)}-t{c.temperature}-k"
                                                  f"{c.top_k}-p{c.top_p}")
def test_sample_batched_row_by_row_equals_sample(cfg):
    """With one config on every row and the same generator state the two
    draw the same tokens, except where top-k and top-p are both on: there
    the JAX sample_batched measures the top-p mass over the unfiltered row
    and sample over what top-k kept, so each draw is held to its own kept
    set (and the kept sets to the JAX ones, above)."""
    x = torch.from_numpy(_logits(B=8, seed=2))
    a = sample(x, torch.Generator().manual_seed(7), cfg)
    b = sample_batched(x, torch.Generator().manual_seed(7), *sampler_arrays([cfg] * 8))
    if cfg.top_k and cfg.top_p < 1.0 and not cfg.greedy:
        rows = torch.arange(8)
        assert torch.isfinite(filter_logits(x, cfg))[rows, a].all()
        assert torch.isfinite(filter_logits_batched(x, *sampler_arrays([cfg] * 8)[:3]))[
            rows, b].all()
    else:
        assert torch.equal(a, b)
    if cfg.greedy or cfg.temperature == 0.0:
        assert torch.equal(a, torch.argmax(x, -1))


@pytest.mark.parametrize("cfg", [SamplerConfig(temperature=0.8),
                                 SamplerConfig(temperature=0.8, top_k=6),
                                 SamplerConfig(temperature=1.2, top_p=0.9)],
                         ids=["t0.8", "k6", "p0.9"])
def test_draw_frequencies_match_filtered_softmax(cfg):
    """20,000 draws of one row through sample, sample_batched and
    loop_next_token (per-slot temperatures): the counts fit the filtered
    softmax (chi-square, p > 1e-3 each), and no filtered token is drawn."""
    n = 20000
    row = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 16)).astype(np.float32))
    x = row.expand(n, 16).contiguous()
    kept = filter_logits(row, cfg)[0]
    p = torch.softmax(kept.double(), -1).numpy()
    draws = [sample(x, torch.Generator().manual_seed(11), cfg),
             sample_batched(x, torch.Generator().manual_seed(12),
                            *sampler_arrays([cfg] * n))]
    if cfg.top_k == 0 and cfg.top_p >= 1.0:
        draws.append(loop_next_token(x, torch.full((n,), cfg.temperature),
                                     torch.Generator().manual_seed(13)))
    live = p > 0
    for d in draws:
        counts = np.bincount(d.numpy(), minlength=16)
        assert counts[~live].sum() == 0
        res = stats.chisquare(counts[live], n * p[live])
        assert res.pvalue > 1e-3, (counts, n * p)


def test_seeded_draws_repeat():
    x = torch.from_numpy(_logits(B=8, seed=4))
    cfg = SamplerConfig(temperature=0.9, top_k=10, top_p=0.95)
    arrs = sampler_arrays([cfg, SamplerConfig(temperature=1.5)] * 4)
    temps = torch.tensor([0.0, 0.7] * 4)
    outs = []
    for seed in (5, 5, 6):
        g = torch.Generator().manual_seed(seed)
        outs.append(torch.stack([sample(x, g, cfg), sample_batched(x, g, *arrs),
                                 loop_next_token(x, temps, g), loop_next_token(x, 1.1, g)]))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert torch.equal(outs[0][2, 0::2], torch.argmax(x, -1)[0::2])   # temperature-0 slots


def test_decode_loop_per_slot_temperatures():
    """engine.decode_loop with a per-slot temperature tensor: the
    temperature-0 rows follow the greedy chain, on the whole-model route (B
    <= 8) and the staged route; a seed repeats the hot rows."""
    packed, cfg, pol, ecfg = build_synthetic_packed("test-llama-256", w_bits=4, head_bits=4,
                                                    max_seq_len=64, device="cpu")
    pol = relax_16bit(pol)
    B, T0, n = 4, 6, 5
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (B, T0)))

    def run(kc, temperature, seed=0):
        cache = E.init_kv_cache(ecfg, B, device="cpu")
        lg, cache = E.forward(packed, prompt, cfg, pol, kv_cache=cache,
                              cache_position=torch.zeros(B, dtype=torch.int32),
                              kv_valid_len=torch.full((B,), T0))
        first = torch.argmax(lg[:, -1], -1)[:, None]
        toks, _, _ = E.decode_loop(packed, first, cache, torch.full((B,), T0, dtype=torch.int32),
                                   n, cfg, pol, kc, temperature=temperature,
                                   generator=torch.Generator().manual_seed(seed), max_start=T0)
        return toks

    temps = torch.tensor([0.0, 1.3, 0.0, 0.9])
    for kc in (True, False):
        greedy = run(kc, 0.0)
        a, b = run(kc, temps, seed=3), run(kc, temps, seed=3)
        assert torch.equal(a, b)
        assert torch.equal(a[0::2], greedy[0::2]), kc
