"""The port's quantizer, policy schema, calibration data, LET, fake-quant sim
and calibration held against the JAX package on the CPU.

The same inputs (numpy seeds, the JAX params carried across by
convert.from_jax_params) go through both. Elementwise ops are bit-exact;
reductions and matmuls hold the tolerances stated at each test.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.data import calib as j_calib
from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.quant import calibrate as j_cal
from mobilequant_tpu.quant import policy as j_pol
from mobilequant_tpu.quant import qmodel as j_qm
from mobilequant_tpu.quant import quantizer as j_q
from mobilequant_tpu.quant import smooth as j_sm

from mobilequant_tpu_torch.convert import from_jax_params, from_jax_qstate, qstate_to_numpy
from mobilequant_tpu_torch.data import calib
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.quant import calibrate, policy as pol, qmodel, smooth
from mobilequant_tpu_torch.quant import quantizer as q

WCFGS = {
    "w8-tensor-asym": dict(bitwidth=8),
    "w8-tensor-sym": dict(bitwidth=8, is_symmetric=True),
    "w4-channel-sym": dict(bitwidth=4, is_per_channel=True, is_symmetric=True),
    "w4-channel-asym": dict(bitwidth=4, is_per_channel=True),
    "w4-g128-asym": dict(bitwidth=4, is_per_channel=True, group_size=128),
    "w8-g128-sym": dict(bitwidth=8, is_per_channel=True, group_size=128, is_symmetric=True),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _pairs(tree, ref):
    """(path, leaf, ref's leaf at that path) over tree's leaves (JAX trees
    come back with sorted keys, so leaves pair by path, not by order)."""
    for path, a in _leaves(tree):
        b = ref
        for k in path.split("/")[1:]:
            b = b[k]
        yield path, a, b


def _models(name):
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, jp, cfg, from_jax_params(jax.tree.map(np.asarray, jp), "cpu")


def _policies(jcfg, cfg, w=dict(bitwidth=8)):
    return (j_pol.default_policy(jcfg, j_q.QuantConfig(**w), j_q.QuantConfig(bitwidth=8)),
            pol.default_policy(cfg, q.QuantConfig(**w), q.QuantConfig(bitwidth=8)))


def _tokens(cfg, n=4, T=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, T)).astype(np.int32)


# ---------------------------------------------------------------------------
# quantizer: round_ste, LWC
# ---------------------------------------------------------------------------

def test_round_ste_rounds_half_to_even_with_an_identity_gradient():
    x = np.concatenate([np.arange(-4, 4.5, 0.5), np.random.default_rng(0).normal(size=64) * 9])
    x = x.astype(np.float32)
    np.testing.assert_array_equal(_np(q.round_ste(torch.from_numpy(x))),
                                  np.asarray(j_q.round_ste(jnp.asarray(x))))
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (q.round_ste(xt) * torch.from_numpy(g)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(j_q.round_ste(v) * g))(jnp.asarray(x))
    np.testing.assert_array_equal(_np(xt.grad), np.asarray(jg))


def _weight(shape=(256, 48), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 0.05


@pytest.mark.parametrize("kind", list(WCFGS))
def test_lwc_init_bounds_and_fake_quant_weight_match_jax(kind):
    w = _weight()
    jc, tc = j_q.QuantConfig(**WCFGS[kind]), q.QuantConfig(**WCFGS[kind])
    jl = j_q.lwc_init(jnp.asarray(w), jc)
    tl = q.lwc_init(torch.from_numpy(w), tc)
    for k in ("up", "low"):
        np.testing.assert_array_equal(_np(tl[k]), np.asarray(jl[k]))
    # random bound factors around the init: the LWC-clipped paths
    rng = np.random.default_rng(2)
    lwc = {k: np.asarray(np.asarray(jl[k]) + rng.normal(size=jl[k].shape) * 1.5, np.float32)
           for k in ("up", "low")}
    tlwc = {k: torch.from_numpy(v) for k, v in lwc.items()}
    jlwc = {k: jnp.asarray(v) for k, v in lwc.items()}
    for a, b in zip(q._lwc_bounds(torch.from_numpy(w), tc, tlwc),
                    j_q._lwc_bounds(jnp.asarray(w), jc, jlwc)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    for lw_t, lw_j in ((None, None), (tl, jl), (tlwc, jlwc)):
        np.testing.assert_array_equal(
            _np(q.fake_quant_weight(torch.from_numpy(w), tc, lw_t)),
            np.asarray(j_q.fake_quant_weight(jnp.asarray(w), jc, lw_j)))
    np.testing.assert_array_equal(
        _np(q.clip_weight_to_learned_bounds(torch.from_numpy(w), tc, tlwc)),
        np.asarray(j_q.clip_weight_to_learned_bounds(jnp.asarray(w), jc, jlwc)))


@pytest.mark.parametrize("kind", list(WCFGS))
def test_lwc_gradients_match_jax_grad(kind):
    """d/d(up, low, w) of <fq(w, lwc), R> within rel 1e-5 of jax.grad: the
    STE, the clip's split gradient on its bounds and the min / max
    reductions' split among equal elements are the JAX rules.

    A per-tensor factor's gradient is one sum over all 12,288 elements whose
    terms cancel (their sum is a few percent of their magnitudes' sum), so
    fp32 summation order alone moves it by several 1e-5 of itself: there the
    1e-5 is taken of the terms' magnitude sum, Σ|c_i| (the terms: the
    gradients of a factor tensor of the weight's shape holding the scalar
    everywhere), and the port's sum is held within the same bound of the
    fp64 sum of its terms."""
    w = _weight(seed=3)
    R = np.random.default_rng(4).normal(size=w.shape).astype(np.float32)
    jc, tc = j_q.QuantConfig(**WCFGS[kind]), q.QuantConfig(**WCFGS[kind])
    jl = j_q.lwc_init(jnp.asarray(w), jc)
    rng = np.random.default_rng(5)
    lwc = {k: np.asarray(np.asarray(jl[k]) + rng.normal(size=jl[k].shape), np.float32)
           for k in ("up", "low")}

    jg = jax.grad(lambda ww, l: jnp.sum(j_q.fake_quant_weight(ww, jc, l) * R),
                  argnums=(0, 1))(jnp.asarray(w), {k: jnp.asarray(v) for k, v in lwc.items()})
    tw = torch.from_numpy(w).requires_grad_(True)
    tl = {k: torch.from_numpy(v).requires_grad_(True) for k, v in lwc.items()}
    (q.fake_quant_weight(tw, tc, tl) * torch.from_numpy(R)).sum().backward()
    assert _rel(_np(tw.grad), jg[0]) <= 1e-5
    if tc.is_per_channel:
        for k in ("up", "low"):
            assert _rel(_np(tl[k].grad), jg[1][k]) <= 1e-5, k
        return
    te = {k: torch.full(w.shape, float(v), requires_grad=True) for k, v in lwc.items()}
    (q.fake_quant_weight(torch.from_numpy(w), tc, te) * torch.from_numpy(R)).sum().backward()
    for k in ("up", "low"):
        c = te[k].grad.double().numpy()
        mass = np.abs(c).sum()
        g = float(tl[k].grad)
        assert abs(g - float(jg[1][k])) <= 1e-5 * mass, k
        assert abs(g - c.sum()) <= 1e-5 * mass, k


def test_fake_quant_gradients_match_jax_grad():
    """Static-range fake quant: gradients to x, scale and offset (LRL), with
    values exactly on the clip bounds (the split gradient)."""
    cfg = q.QuantConfig(bitwidth=8)
    x = np.random.default_rng(6).normal(size=(8, 64)).astype(np.float32)
    s, o = j_q.scale_offset_from_min_max(x.min(), x.max(), j_q.QuantConfig(bitwidth=8))
    s, o = float(s) * 0.9, float(o)            # some values past the top bound
    R = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda a, b, c: jnp.sum(j_q.fake_quant(a, b, c, j_q.QuantConfig(bitwidth=8))
                                          * R), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.float32(s), jnp.float32(o))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.tensor(s, dtype=torch.float32, requires_grad=True)
    to = torch.tensor(o, dtype=torch.float32, requires_grad=True)
    out = q.fake_quant(tx, ts, to, cfg)
    np.testing.assert_array_equal(
        _np(out), np.asarray(j_q.fake_quant(jnp.asarray(x), jnp.float32(s), jnp.float32(o),
                                            j_q.QuantConfig(bitwidth=8))))
    (out * torch.from_numpy(R)).sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), np.asarray(jg[0]))
    assert _rel(_np(ts.grad), jg[1]) <= 1e-5 and _rel(_np(to.grad), jg[2]) <= 1e-5


# ---------------------------------------------------------------------------
# policy schema, calibration data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["default", "relaxed", "w4", "weight_only"])
def test_policy_dict_matches_jax_and_round_trips(which):
    jcfg, cfg = j_get_config("test-llama"), get_config("test-llama")
    if which == "weight_only":
        jp_ = j_pol.weight_only_policy(jcfg, j_q.QuantConfig(bitwidth=4, group_size=32,
                                                             is_per_channel=True), 4)
        tp_ = pol.weight_only_policy(cfg, q.QuantConfig(bitwidth=4, group_size=32,
                                                        is_per_channel=True), 4)
    else:
        w = (dict(bitwidth=4, is_per_channel=True, is_symmetric=True) if which == "w4"
             else dict(bitwidth=8))
        jp_, tp_ = _policies(jcfg, cfg, w)
        if which == "relaxed":
            jp_, tp_ = j_pol.relax_16bit(jp_), pol.relax_16bit(tp_)
    d = pol.policy_to_dict(tp_)
    assert d == j_pol.policy_to_dict(jp_)
    assert pol.policy_from_dict(d) == tp_
    assert pol.policy_to_dict(pol.policy_from_dict(j_pol.policy_to_dict(jp_))) == d


def test_quant_config_schema_booleans():
    """default_qcfg.json stores booleans as strings; JSON booleans and
    lower-case strings read the same (the JAX from_dict's rule)."""
    for v, want in (("True", True), ("true", True), (True, True), ("False", False),
                    (False, False), ("false", False)):
        d = {"bitwidth": "4", "group_size": "-1", "is_symmetric": v,
             "is_per_channel": v, "is_dynamic": "False"}
        got = q.QuantConfig.from_dict(d)
        assert got.is_symmetric is want and got.is_per_channel is want
        assert dataclasses.asdict(got) == dataclasses.asdict(j_q.QuantConfig.from_dict(d))
    assert q.QuantConfig(bitwidth=4, is_symmetric=True).to_dict() == \
        j_q.QuantConfig(bitwidth=4, is_symmetric=True).to_dict()


def test_calibration_tokens_are_the_jax_packages():
    for args in ((256, 4, 16, 0), (32000, 8, 64, 1337)):
        a = calib.synthetic_tokens(*args)
        np.testing.assert_array_equal(a, j_calib.synthetic_tokens(*args))
        assert a.dtype == np.int32
        np.testing.assert_array_equal(calib.add_random_samples(a, args[0], seed=3),
                                      j_calib.add_random_samples(a, args[0], seed=3))


# ---------------------------------------------------------------------------
# LET
# ---------------------------------------------------------------------------

def _rand_let(jcfg, seed=1, spread=0.5):
    """Random LET params as tests/test_smooth.py draws them (q <-> k scales
    uniform within each head's rotated block; fc2 shifts zero), in numpy."""
    rng = np.random.default_rng(seed)
    let = {}
    for name, v in j_sm.let_init(jcfg).items():
        v = np.asarray(v)
        if name == "qkt_scale":
            L, H, hd, rd = v.shape[0], jcfg.num_heads, jcfg.head_dim_, jcfg.rotary_dim
            full = np.repeat(np.exp(rng.normal(size=(L, H, 1)) * spread), hd, axis=2)
            full[:, :, rd:] = np.exp(rng.normal(size=(L, H, hd - rd)) * spread)
            let[name] = full.reshape(L, H * hd)
        elif name.endswith("scale"):
            let[name] = v * np.exp(rng.normal(size=v.shape) * spread)
        elif name == "fc2_shift":
            let[name] = v
        else:
            let[name] = rng.normal(size=v.shape) * 0.1
    return {k: v.astype(np.float32) for k, v in let.items()}


@pytest.mark.parametrize("name", ["test-llama", "test-gemma", "test-stablelm"])
def test_let_transforms_match_jax(name):
    """let_init equal; apply_let, fold_let and smoothquant_let_init within
    rel 1e-6; the folded model keeps the FP logits (rel 2e-3, as
    tests/test_smooth.py)."""
    jcfg, jp, cfg, tp = _models(name)
    jl = j_sm.let_init(jcfg)
    tl = smooth.let_init(cfg, device="cpu")
    assert list(tl) == list(jl)
    for k in jl:
        np.testing.assert_array_equal(_np(tl[k]), np.asarray(jl[k]))
    let = _rand_let(jcfg)
    jf = j_sm.fold_let(jp, {k: jnp.asarray(v) for k, v in let.items()}, jcfg)
    tf = smooth.fold_let(tp, from_jax_qstate(let, "cpu"), cfg)
    for path, a, b in _pairs(tf["layers"], jf["layers"]):
        assert _rel(_np(a), b) <= 1e-6, path
    lp = {k: {kk: vv[1] for kk, vv in v.items()} for k, v in tp["layers"].items()}
    one = smooth.apply_let(lp, {k: torch.from_numpy(v[1]) for k, v in let.items()}, cfg)
    for path, a, b in _pairs(one, jax.tree.map(lambda v: v[1], jf["layers"])):
        assert _rel(_np(a), b) <= 1e-6, path

    toks = _tokens(cfg, 2, 12)
    base, _ = M.forward(tp, torch.from_numpy(toks), cfg)
    out, _ = M.forward(tf, torch.from_numpy(toks), cfg)
    assert _rel(_np(out), _np(base)) <= 2e-3

    jpol, tpol = _policies(jcfg, cfg)
    jst = j_cal.run_calibration(jp, toks, jcfg, jpol, batch_size=2)
    tst = calibrate.run_calibration(tp, toks, cfg, tpol, batch_size=2)
    ja, jsh = j_cal.smooth_calib_inputs(jst)
    ta, tsh = calibrate.smooth_calib_inputs(tst, device="cpu")
    for use_shift in (False, True):
        jl0 = j_sm.smoothquant_let_init(jcfg, ja, jsh, jp, alpha=0.5, use_shift=use_shift)
        tl0 = smooth.smoothquant_let_init(cfg, ta, tsh, tp, alpha=0.5, use_shift=use_shift)
        for k in jl0:
            assert _rel(_np(tl0[k]), jl0[k]) <= 1e-6, k


def test_truncate_scale_floors_small_values():
    s = torch.tensor([0.5, 1e-4, -1e-4, -0.5, 0.02], requires_grad=True)
    t = smooth.truncate_scale(s)
    np.testing.assert_allclose(_np(t), [0.5, 1e-2, -1e-2, -0.5, 0.02], atol=1e-8)
    np.testing.assert_array_equal(_np(t), np.asarray(j_sm.truncate_scale(jnp.asarray(_np(s)))))
    (t * 3).sum().backward()
    np.testing.assert_allclose(_np(s.grad), np.full(5, 3.0))


# ---------------------------------------------------------------------------
# the sim and calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["test-llama", "test-gemma", "test-stablelm", "test-mixtral"])
def test_collect_stats_and_sim_logits_match_jax(name):
    """Collect mode: the FP forward (rtol 1e-5) and every site's statistics
    within rel 1e-5 (per channel at the projections' inputs, per expert on
    test-mixtral); sim mode on the calibrated ranges with random LET and LWC
    factors: logits within rel 1e-4 of the JAX qforward."""
    jcfg, jp, cfg, tp = _models(name)
    w = dict(bitwidth=4, is_per_channel=True, is_symmetric=True)
    jpol, tpol = _policies(jcfg, cfg, w)
    toks = _tokens(cfg)
    jfp, _ = JM.forward(jp, jnp.asarray(toks), jcfg)
    tq, _, tst = qmodel.qforward(tp, None, torch.from_numpy(toks), cfg, tpol, mode="collect")
    jq, _, jst = j_qm.qforward(jp, None, jnp.asarray(toks), jcfg, jpol, mode="collect")
    np.testing.assert_allclose(_np(tq), np.asarray(jfp), rtol=1e-5, atol=1e-6)
    assert set(tst) == set(jst)
    for site in jst:
        assert set(tst[site]) == set(jst[site]), site
        for role, e in jst[site].items():
            assert set(tst[site][role]) == set(e), (site, role)
            for k, v in e.items():
                a, b = _np(tst[site][role][k]), np.asarray(v)
                fin = np.isfinite(b)
                np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"{site} {role} {k}")
                assert _rel(a[fin], b[fin]) <= 1e-5, (site, role, k)
    if name == "test-mixtral":
        assert "emin" in tst["mlp.w2"]["input"]

    jstats = j_cal.run_calibration(jp, toks, jcfg, jpol, batch_size=2)
    ranges = j_cal.stats_to_ranges(jstats, jpol)
    qs = {"ranges": jax.tree.map(np.asarray, ranges), "let": _rand_let(jcfg, spread=0.1),
          "lwc": jax.tree.map(lambda a: np.asarray(a) - 1.0, j_qm.lwc_init_all(jp, jpol))}
    jl, _, _ = j_qm.qforward(jp, jax.tree.map(jnp.asarray, qs), jnp.asarray(toks[:2]), jcfg,
                             jpol)
    tlg, _, _ = qmodel.qforward(tp, from_jax_qstate(qs, "cpu"), torch.from_numpy(toks[:2]),
                                cfg, tpol)
    assert _rel(_np(tlg), jl) <= 1e-4


@pytest.mark.parametrize("name", ["test-llama", "test-mixtral"])
def test_calibration_and_act_dict_match_jax(name):
    """run_calibration (two batches merged, with a LET), stats_to_ranges
    (per-expert leaves on test-mixtral), ranges_for_kv_bits, the act_dict
    round trips and ranges_to_act_dict against the JAX package."""
    jcfg, jp, cfg, tp = _models(name)
    jpol, tpol = _policies(jcfg, cfg)
    toks = _tokens(cfg, 6, 16, seed=2)
    let = _rand_let(jcfg, spread=0.2)
    jst = j_cal.run_calibration(jp, toks, jcfg, jpol, let=jax.tree.map(jnp.asarray, let),
                                batch_size=4)
    tst = calibrate.run_calibration(tp, toks, cfg, tpol, let=from_jax_qstate(let, "cpu"),
                                    batch_size=4)
    for site in jst:
        for role, e in jst[site].items():
            for k, v in e.items():
                a, b = tst[site][role][k], np.asarray(v)
                fin = np.isfinite(b)
                assert _rel(a[fin], b[fin]) <= 1e-5, (site, role, k)
    jr = j_cal.stats_to_ranges(jst, jpol)
    tr = calibrate.stats_to_ranges(tst, tpol, device="cpu")
    for path, a, b in _pairs(tr, jax.tree.map(np.asarray, jr)):
        assert _np(a).shape == b.shape and _rel(_np(a), b) <= 1e-5, path
    # from the same statistics the ranges are equal
    same = calibrate.stats_to_ranges(jax.tree.map(np.asarray, jst), tpol, device="cpu")
    for path, a, b in _pairs(same, jax.tree.map(np.asarray, jr)):
        np.testing.assert_array_equal(_np(a), b, err_msg=path)
    jr4 = j_cal.ranges_for_kv_bits(jr, 4)
    tr4 = calibrate.ranges_for_kv_bits(same, 4)
    for path, a, b in _pairs(tr4, jax.tree.map(np.asarray, jr4)):
        np.testing.assert_array_equal(_np(a), b, err_msg=path)

    jd = j_cal.stats_to_act_dict(jst, jcfg)
    td = calibrate.stats_to_act_dict(jax.tree.map(np.asarray, jst), cfg)
    assert td == jd
    back = calibrate.act_dict_to_stats(td, cfg)
    jback = j_cal.act_dict_to_stats(jd, jcfg)
    for path, a, b in _pairs(back, jback):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert calibrate.ranges_to_act_dict(same, tpol, cfg) == \
        j_cal.ranges_to_act_dict(jr, jpol, jcfg)


def test_head_input_absmax_and_smooth_last_scales_match_jax():
    jcfg, jp, cfg, tp = _models("test-llama")
    toks = _tokens(cfg, 4, 12)
    jam = j_cal.head_input_absmax(jp, toks, jcfg, batch_size=2)
    tam = calibrate.head_input_absmax(tp, toks, cfg, batch_size=2)
    assert _rel(_np(tam), jam) <= 1e-5
    js = j_cal.smooth_last_scales(jam, jp["lm_head"]["w"], alpha=0.5)
    ts = calibrate.smooth_last_scales(torch.from_numpy(np.asarray(jam)), tp["lm_head"]["w"],
                                      alpha=0.5)
    assert _rel(_np(ts), js) <= 1e-6


def test_qstate_carries_across_both_ways():
    jcfg, jp, cfg, tp = _models("test-llama")
    jpol, _ = _policies(jcfg, cfg, dict(bitwidth=4, is_per_channel=True))
    toks = _tokens(cfg)
    jq = {"let": j_sm.let_init(jcfg), "lwc": j_qm.lwc_init_all(jp, jpol),
          "ranges": j_cal.stats_to_ranges(j_cal.run_calibration(jp, toks, jcfg, jpol), jpol)}
    jq = jax.tree.map(np.asarray, jq)
    tq = from_jax_qstate({**jq, "unused": None}, "cpu")
    assert "unused" not in tq
    back = qstate_to_numpy(tq)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jq)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_sim_refuses_tf32_matmuls_on_the_card():
    """The fp32 guard reads torch.backends.cuda.matmul.allow_tf32 (the
    flag alone: no card needed to hold it)."""
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="fp32"):
            qmodel.require_fp32_matmuls("cuda")
        qmodel.require_fp32_matmuls("cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        qmodel.require_fp32_matmuls("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
