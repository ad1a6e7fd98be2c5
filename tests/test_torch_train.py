"""The port's training loops (quant/train.py) held against the JAX package's
on the CPU, and the JAX package's own training tests ported port to port.

test-llama cut to 2 layers (hidden 64) on the W4A8 policy (per-channel symmetric
W4, A8), calibrated ranges and the SmoothQuant LET init from the same
params and tokens (numpy seeds; the JAX params carried across by
convert.from_jax_params, the JAX state by convert.from_jax_qstate).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import get_config as j_get_config
from mobilequant_tpu.models import model as JM
from mobilequant_tpu.quant import calibrate as j_cal
from mobilequant_tpu.quant import policy as j_pol
from mobilequant_tpu.quant import qmodel as j_qm
from mobilequant_tpu.quant import quantizer as j_q
from mobilequant_tpu.quant import smooth as j_sm
from mobilequant_tpu.quant import train as j_tr

from mobilequant_tpu_torch.convert import from_jax_params, from_jax_qstate, qstate_to_numpy
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.models import model as M
from mobilequant_tpu_torch.quant import calibrate, policy as pol, qmodel, smooth, train
from mobilequant_tpu_torch.quant import quantizer as q

W4 = dict(bitwidth=4, is_per_channel=True, is_symmetric=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a tree of tensors or arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _setup(layers=None, n=8, T=16):
    jcfg = j_get_config("test-llama")
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("test-llama"), num_layers=jcfg.num_layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    jpol = j_pol.default_policy(jcfg, j_q.QuantConfig(**W4), j_q.QuantConfig(bitwidth=8))
    tpol = pol.default_policy(cfg, q.QuantConfig(**W4), q.QuantConfig(bitwidth=8))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (n, T)).astype(np.int32)
    # the JAX pipeline's state, carried across, so both loops start equal
    st = j_cal.run_calibration(jp, toks, jcfg, jpol, batch_size=4)
    ranges = j_cal.stats_to_ranges(st, jpol)
    let0 = j_sm.smoothquant_let_init(jcfg, *j_cal.smooth_calib_inputs(st), jp)
    return dict(jcfg=jcfg, jp=jp, cfg=cfg, tp=tp, jpol=jpol, tpol=tpol, toks=toks,
                ranges=ranges, let0=let0)


@pytest.fixture(scope="module")
def s():
    return _setup(layers=2)


def _qstates(s, tc_j, tc_t):
    jq = j_tr.init_qstate(s["jp"], s["jcfg"], s["jpol"], tc_j, s["ranges"], let=s["let0"])
    tq = from_jax_qstate(jax.tree.map(np.asarray, jq), "cpu")
    return jq, tq


def _qerr(params, qstate, tokens, cfg, policy):
    t = torch.from_numpy(tokens)
    fp, _, _ = M.forward_hidden(params, t, cfg, apply_final_norm=False)
    qh, _, _ = qmodel.qforward_hidden(params, qstate, t, cfg, policy, apply_final_norm=False)
    return float(torch.mean(torch.square(qh - fp)))


def test_init_qstate_matches_jax(s):
    """The port's own init (its calibration, SmoothQuant init, LWC init)
    against the JAX package's."""
    tc_j, tc_t = j_tr.TrainConfig(), train.TrainConfig()
    jq = jax.tree.map(np.asarray, j_tr.init_qstate(s["jp"], s["jcfg"], s["jpol"], tc_j,
                                                   s["ranges"], let=s["let0"]))
    st = calibrate.run_calibration(s["tp"], s["toks"], s["cfg"], s["tpol"], batch_size=4)
    let0 = smooth.smoothquant_let_init(s["cfg"], *calibrate.smooth_calib_inputs(st, "cpu"),
                                       s["tp"])
    tq = train.init_qstate(s["tp"], s["cfg"], s["tpol"], tc_t,
                           calibrate.stats_to_ranges(st, s["tpol"], "cpu"), let=let0,
                           device="cpu")
    a, b = _flat(tq), _flat(jq)
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == np.float32, k
        if k.startswith("/lwc"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert _rel(a[k], b[k]) <= 1e-5, k
    # identity LET and no LWC / LRL by the config's flags
    tq2 = train.init_qstate(s["tp"], s["cfg"], s["tpol"],
                            train.TrainConfig(use_lwc=False), tq["ranges"], device="cpu")
    assert set(tq2) == {"let", "ranges"}
    np.testing.assert_array_equal(tq2["let"]["qkv_scale"].numpy(), 1.0)


def test_lr_schedule_is_the_jax_cosine_with_warmup():
    """Every group's learning rate at every step equals the JAX _cosine_lr
    of its group (abs 1e-9), warmup included, and the optimizer is AdamW at
    optax's defaults without weight decay."""
    for warmup_frac, total in ((0.25, 12), (0.0, 7)):
        tc = train.TrainConfig(warmup_frac=warmup_frac)
        tree = {"let": {"a": torch.zeros(3)}, "lwc": {"b": torch.zeros(2)},
                "ranges": {"c": torch.zeros(1)}}
        tree = {k: {kk: v.requires_grad_(True) for kk, v in t.items()} for k, t in tree.items()}
        opt = train._Optimizer(tc, tree, total)
        warm = int(warmup_frac * total)
        want = [j_tr._cosine_lr(tc.let_lr, tc.let_min_lr, warm, total),
                j_tr._cosine_lr(tc.lwc_lr, tc.lwc_min_lr, warm, total),
                j_tr._cosine_lr(tc.lrl_lr, tc.lrl_min_lr, warm, total)]
        for step in range(total + 2):
            for g, f in zip(opt.opt.param_groups, want):
                assert abs(g["lr"] - float(f(step))) <= 1e-9, (step, g["lr"], float(f(step)))
            opt.step(sum(p.sum() for p in opt.params))
        g0 = opt.opt.param_groups[0]
        assert g0["betas"] == (0.9, 0.999) and g0["eps"] == 1e-8 and g0["weight_decay"] == 0.0


def _jax_loss(s, tok, fp_h):
    def loss(qs):
        qh, _, _ = j_qm.qforward_hidden(s["jp"], qs, tok, s["jcfg"], s["jpol"],
                                        apply_final_norm=False)
        return jnp.mean(jnp.square(qh - fp_h))
    return loss


def _static_cfg(policy, site, role):
    sq = policy.get(site)
    cfg = getattr(sq, role) if sq is not None else None
    return cfg if cfg is not None and cfg.enabled and not cfg.is_dynamic else None


class _PortProbe(qmodel.QuantOps):
    """The sim, with each static-range site's scale / offset broadcast to the
    tensor's shape first, so that their gradients come back per element (the
    terms of the range leaves' gradients), and each site's integer grid
    clip(round(x / s) + o) recorded."""

    def __init__(self, policy, config):
        super().__init__(policy, config, "sim")
        self.rec, self.layer = [], -1

    def begin_layer(self, extras):
        super().begin_layer(extras)
        self.layer += 1

    def _fq_act(self, site, role, x):
        cfg = _static_cfg(self.policy, site, role)
        if cfg is None:
            return super()._fq_act(site, role, x)
        r = self.ranges[site][role]
        s_e = r["scale"] + torch.zeros_like(x)
        o_e = r["offset"] + torch.zeros_like(x)
        s_e.retain_grad()
        o_e.retain_grad()
        out = q.fake_quant(x, s_e, o_e, cfg)
        out.retain_grad()
        xs = x.detach() / s_e.detach()
        grid = torch.clamp(torch.round(xs) + o_e.detach(), cfg.qmin, cfg.qmax)
        self.rec.append(((site, role, self.layer), s_e, o_e, out, grid, xs))
        return out


class _JaxProbe(j_qm.QuantOps):
    """The JAX sim recording each static-range site's integer grid (as
    j_quantizer.fake_quant rounds it)."""

    def __init__(self, policy, config):
        super().__init__(policy, config, "sim")
        self.rec = []

    def _fq_act(self, site, role, x):
        out = super()._fq_act(site, role, x)
        cfg = _static_cfg(self.policy, site, role)
        if cfg is not None:
            r = self.ranges[site][role]
            self.rec.append(jnp.clip(jnp.round(x.astype(jnp.float32) / r["scale"])
                                     + r["offset"], cfg.qmin, cfg.qmax))
        return out


def _jax_layer_loop(s, qs, tok, fp_h):
    """The JAX forward_hidden's body (embedding, rope, mask, the layers) as a
    Python loop instead of a scan, so that the grids come out as aux."""
    jcfg, ops = s["jcfg"], _JaxProbe(s["jpol"], s["jcfg"])
    B, T = tok.shape
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    x = s["jp"]["embed"]["w"][tok]
    cos, sin = JM.rope_cos_sin(pos, jcfg, x.dtype)
    mask = JM.causal_mask(pos, T, jcfg.neg_inf).astype(x.dtype)
    for l in range(jcfg.num_layers):
        ops.begin_layer(jax.tree.map(lambda a: a[l], qs))
        x, _ = JM.decoder_layer(ops, jax.tree.map(lambda a: a[l], s["jp"]["layers"]), x,
                                cos, sin, mask, jcfg)
    return jnp.mean(jnp.square(x - fp_h)), ops.rec


def test_first_e2e_step_gradients_match_jax_grad(s):
    """d loss / d (let, lwc, ranges) at the initial state on the first batch,
    on the strict policy (the pipeline's).

    The JAX side is jax.grad of the JAX sim (the JAX package's
    decoder_layer and QuantOps) jitted as a layer loop instead of its scan,
    so that its integer grids can be read (its loss equals the scan's within
    rel 1e-6). LET and LWC leaves: within rel 1e-4 of it. A range leaf's gradient
    is a sum over its site's elements of terms that cancel: a scale's term is
    g_i·round(x_i/s) − g_i·x_i/s (g_i the loss's gradient at the site's
    output), an offset's g_i·s − g_i·s wherever the clip does not bite, so
    each framework's sum carries rounding of the order of those paths'
    magnitudes, Σ|g_i|·(|round(x_i/s)| + |x_i/s|) and 2·Σ|g_i|·s, not of the
    gradient itself. Each range entry (site, role, layer) is held to 1e-4 of
    that magnitude (read: <= 1.4e-7), plus, for the elements whose integer
    grid differs between the two (the counted flips: an fp32 ulp of x moves
    x/s by up to ~4e-3 at a 16-bit site, x/s ~ 3·10^4, so XLA's and torch's
    summation orders flip some roundings there), |g_i| times the difference
    (a flip moves that term by g_i a step; the offset's by g_i·s). Flips
    (read): none of the 139,264 elements at the 8-bit sites (held at 1e-4:
    an 8-bit x/s moves by ~1e-5 a ulp), 9 of the 98,304 at the 16-bit ones
    (held at 0.1%)."""
    tc = train.TrainConfig(batch_size=4)
    jq, tq = _qstates(s, j_tr.TrainConfig(batch_size=4), tc)
    tok = s["toks"][:4]
    jfp, _, _ = JM.forward_hidden(s["jp"], jnp.asarray(tok), s["jcfg"], apply_final_norm=False)
    j_loss = _jax_loss(s, jnp.asarray(tok), jfp)(jq)
    (jl_loop, jgrids), jg = jax.jit(jax.value_and_grad(
        lambda qs: _jax_layer_loop(s, qs, jnp.asarray(tok), jfp), has_aux=True))(jq)
    assert abs(float(jl_loop) - float(j_loss)) <= 1e-6 * float(j_loss)

    tfp, _, _ = M.forward_hidden(s["tp"], torch.from_numpy(tok), s["cfg"],
                                 apply_final_norm=False)
    tr = {k: train._trainable(v) for k, v in tq.items()}
    probe = _PortProbe(s["tpol"], s["cfg"])
    qh, _, _ = M.forward_hidden(s["tp"], torch.from_numpy(tok), s["cfg"], probe,
                                layer_extras=tr, apply_final_norm=False)
    loss = torch.mean(torch.square(qh - tfp))
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * float(j_loss)
    loss.backward()
    with torch.no_grad():    # the probe's loss is the e2e loss
        assert float(loss) == float(train.e2e_loss(s["tp"], tq, torch.from_numpy(tok), tfp,
                                                   s["cfg"], s["tpol"], tc))
    a = _flat(train._map(lambda t: t.grad, tr))
    b = _flat(jax.tree.map(np.asarray, jg))
    assert set(a) == set(b)
    for k in b:
        if not k.startswith("/ranges"):
            assert _rel(a[k], b[k]) <= 1e-4, (k, _rel(a[k], b[k]))

    assert len(probe.rec) == len(jgrids)
    flips = {8: [0, 0], 16: [0, 0]}
    for ((site, role, l), s_e, o_e, out, grid, xs), jgrid in zip(probe.rec, jgrids):
        bits = getattr(s["tpol"][site], role).bitwidth
        d = np.abs(grid.numpy() - np.asarray(jgrid))
        g = np.abs(out.grad.numpy())
        flips[bits][0] += int((d > 0).sum())
        flips[bits][1] += d.size
        sc = float(s_e.detach().reshape(-1)[0])
        o = float(o_e.detach().reshape(-1)[0])
        for leaf, mass, allow in (
                ("scale", float((g * (np.abs(grid.numpy() - o) + np.abs(xs.numpy()))).sum()),
                 float((g * d).sum())),
                ("offset", 2.0 * float(g.sum()) * sc, float((g * (d > 0)).sum()) * sc)):
            key = f"/ranges/{site}/{role}/{leaf}"
            gap = abs(float(a[key][l]) - float(b[key][l]))
            assert gap <= 1e-4 * mass + allow, (key, l, gap, mass, allow)
    assert flips[8][0] <= 1e-4 * flips[8][1], flips
    assert flips[16][0] <= 1e-3 * flips[16][1], flips


@pytest.mark.parametrize("grad_clip", [None, 3e-4], ids=["no-clip", "clip"])
def test_e2equant_three_steps_match_jax(s, grad_clip):
    """Three steps (3 batches of 2, one epoch) of LET and LWC from the same
    state: every leaf and the epoch's mean loss within rel 1e-3 of the JAX
    loop's; the clip bites on the let group.

    On the relaxed policy and without LRL, where both loops see the same
    roundings: scripts/quant_train_drift.py reads them 1.0e-5 apart here. The
    strict policy's 16-bit sites flip a few roundings between XLA and torch
    every step (the gradient test above counts them): there the script
    reads 8.4e-5 for e2equant but 4.8e-3 for omniquant. With LRL on, Adam
    turns a range entry whose gradient is cancellation noise into an lr step
    of either sign, and the strict policy's loops land 0.22 (e2equant) and
    0.75 (omniquant) apart. The strict policy and LRL are held step by step,
    by the gradient test."""
    kw = dict(epochs=1, batch_size=2, grad_clip=grad_clip, use_lrl=False)
    jq, tq = _qstates(s, j_tr.TrainConfig(**kw), train.TrainConfig(**kw))
    jpol, tpol = j_pol.relax_16bit(s["jpol"]), pol.relax_16bit(s["tpol"])
    toks = s["toks"][:6]
    if grad_clip is not None:
        tr = {"let": train._trainable(tq["let"])}
        fp, _, _ = M.forward_hidden(s["tp"], torch.from_numpy(toks[:2]), s["cfg"],
                                    apply_final_norm=False)
        train.e2e_loss(s["tp"], {**tq, **tr}, torch.from_numpy(toks[:2]), fp, s["cfg"], tpol,
                       train.TrainConfig(**kw)).backward()
        assert torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.grad) for t in tr["let"].values()])) > grad_clip
    jout, jh = j_tr.e2equant(s["jp"], jq, toks, s["jcfg"], jpol, j_tr.TrainConfig(**kw))
    tout, th = train.e2equant(s["tp"], tq, toks, s["cfg"], tpol, train.TrainConfig(**kw))
    assert _rel(th, jh) <= 1e-3
    a, b = _flat(tout), _flat(jax.tree.map(np.asarray, jout))
    b0 = _flat(jax.tree.map(np.asarray, jq))
    assert set(a) == set(b)
    for k in b:
        assert _rel(a[k], b[k]) <= 1e-3, (k, _rel(a[k], b[k]))
        assert np.array_equal(b[k], b0[k]) == k.startswith("/ranges"), k


def test_omniquant_two_layers_matches_jax(s):
    """Layer by layer over both layers, 2 epochs of 2 batches, LET and LWC,
    on the relaxed policy (for the reasons of the three-step test): every
    leaf of the final state within rel 1e-3 of the JAX loop's
    (scripts/quant_train_drift.py: 7.0e-5)."""
    kw = dict(epochs=2, batch_size=2, use_lrl=False)
    jq, tq = _qstates(s, j_tr.TrainConfig(**kw), train.TrainConfig(**kw))
    jpol, tpol = j_pol.relax_16bit(s["jpol"]), pol.relax_16bit(s["tpol"])
    toks = s["toks"][:4]
    jout, _ = j_tr.omniquant(s["jp"], jq, toks, s["jcfg"], jpol, j_tr.TrainConfig(**kw))
    tout, _ = train.omniquant(s["tp"], tq, toks, s["cfg"], tpol, train.TrainConfig(**kw))
    a, b = _flat(tout), _flat(jax.tree.map(np.asarray, jout))
    assert set(a) == set(b)
    for k in b:
        assert _rel(a[k], b[k]) <= 1e-3, (k, _rel(a[k], b[k]))


def test_finalize_matches_jax(s):
    """LET folded (scales truncated, one below the 1e-2 floor) and the LWC
    clamp, from a trained-looking state: params within rel 1e-6; the
    learned ranges pass through."""
    rng = np.random.default_rng(3)
    jq, _ = _qstates(s, j_tr.TrainConfig(), train.TrainConfig())
    jq = jax.tree.map(np.asarray, jq)
    jq["let"] = {k: (v * np.exp(rng.normal(size=v.shape) * 0.2) if k.endswith("scale")
                     else rng.normal(size=v.shape) * 0.05).astype(np.float32)
                 for k, v in jq["let"].items()}
    jq["let"]["qkv_scale"][0, 0] = 1e-4
    jq["lwc"] = jax.tree.map(lambda v: (v - rng.uniform(0, 4, v.shape)).astype(np.float32),
                             jq["lwc"])
    jp2, jq2 = j_tr.finalize(s["jp"], jax.tree.map(jnp.asarray, jq), s["jcfg"], s["jpol"])
    tp2, tq2 = train.finalize(s["tp"], from_jax_qstate(jq, "cpu"), s["cfg"], s["tpol"])
    a, b = _flat(tp2), _flat(jax.tree.map(np.asarray, jp2))
    assert set(a) == set(b)
    for k in b:
        assert _rel(a[k], b[k]) <= 1e-6, k
    assert set(tq2) == {"ranges"}
    for k, v in _flat(jax.tree.map(np.asarray, jq2)).items():
        np.testing.assert_array_equal(_flat(tq2)[k], v)


# ---------------------------------------------------------------------------
# the JAX package's training tests, port to port
# ---------------------------------------------------------------------------

def test_finalize_matches_online_sim():
    """After folding LET and clamping LWC, the static-range sim on the folded
    weights matches the online sim of the trained state (tests/test_train.py's
    rung: W8, 4 epochs, rtol / atol 5e-3)."""
    jcfg = j_get_config("test-llama")
    cfg = get_config("test-llama")
    tp = from_jax_params(jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0))),
                         "cpu")
    tpol = pol.default_policy(cfg, q.QuantConfig(bitwidth=8), q.QuantConfig(bitwidth=8))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    ranges = calibrate.stats_to_ranges(calibrate.run_calibration(tp, toks, cfg, tpol), tpol,
                                       "cpu")
    tc = train.TrainConfig(epochs=4, batch_size=4)
    q0 = train.init_qstate(tp, cfg, tpol, tc, ranges, device="cpu")
    qs, _ = train.e2equant(tp, q0, toks, cfg, tpol, tc)
    t = torch.from_numpy(toks[:2])
    online, _, _ = qmodel.qforward(tp, qs, t, cfg, tpol)
    tp2, qs2 = train.finalize(tp, qs, cfg, tpol)
    folded, _, _ = qmodel.qforward(tp2, qs2, t, cfg, tpol)
    np.testing.assert_allclose(folded.numpy(), online.numpy(), rtol=5e-3, atol=5e-3)


def test_e2equant_reduces_error_and_resumes(s):
    """Per-epoch checkpoints, and a resume from the epoch-1 checkpoint lands
    in the same ballpark as the uninterrupted run (tests/test_train.py's
    e2e resume test); the loss falls."""
    tc = train.TrainConfig(epochs=4, batch_size=4)
    _, q0 = _qstates(s, j_tr.TrainConfig(), tc)
    saved = {}
    full, hist = train.e2equant(s["tp"], q0, s["toks"], s["cfg"], s["tpol"], tc,
                                checkpoint_cb=lambda e, qs: saved.__setitem__(e, qs))
    assert set(saved) == {0, 1, 2, 3} and hist[-1] < hist[0]
    err0 = _qerr(s["tp"], q0, s["toks"], s["cfg"], s["tpol"])
    err_full = _qerr(s["tp"], full, s["toks"], s["cfg"], s["tpol"])
    assert err_full < err0
    resumed, _ = train.e2equant(s["tp"], saved[1], s["toks"], s["cfg"], s["tpol"],
                                train.TrainConfig(epochs=2, batch_size=4))
    assert _qerr(s["tp"], resumed, s["toks"], s["cfg"], s["tpol"]) < err_full * 3 + 1e-6
    # a checkpoint is a copy: later epochs do not move it
    assert not np.array_equal(saved[1]["let"]["qkv_scale"].numpy(),
                              full["let"]["qkv_scale"].numpy())


def test_omniquant_checkpoint_resume_bit_identical(s):
    """Resume a layerwise run from its layer-0 checkpoint: the final state
    equals the uninterrupted run's bit for bit."""
    tc = train.TrainConfig(epochs=2, batch_size=4)
    _, q0 = _qstates(s, j_tr.TrainConfig(), tc)
    saved = {}
    full, _ = train.omniquant(s["tp"], q0, s["toks"], s["cfg"], s["tpol"], tc,
                              checkpoint_cb=lambda li, qs: saved.__setitem__(li, qs))
    assert set(saved) == set(range(s["cfg"].num_layers))
    resumed, _ = train.omniquant(s["tp"], q0, s["toks"], s["cfg"], s["tpol"], tc,
                                 resume_state=saved[0], resume_layers=1)
    a, b = qstate_to_numpy(full), qstate_to_numpy(resumed)
    for k, v in _flat(a).items():
        np.testing.assert_array_equal(_flat(b)[k], v, err_msg=k)


def test_aug_loss_in_both_loops(s):
    """aug_loss: the e2e loss is exactly doubled (its aug teacher is the
    teacher); in the layerwise loop the aug teacher sees the quantized input
    stream, so the trained state differs from the plain run's; both loops
    reduce the error."""
    tc = train.TrainConfig(epochs=2, batch_size=4, aug_loss=True)
    _, q0 = _qstates(s, j_tr.TrainConfig(), tc)
    tok = torch.from_numpy(s["toks"][:4])
    fp, _, _ = M.forward_hidden(s["tp"], tok, s["cfg"], apply_final_norm=False)
    with torch.no_grad():
        l_aug = train.e2e_loss(s["tp"], q0, tok, fp, s["cfg"], s["tpol"], tc)
        l_one = train.e2e_loss(s["tp"], q0, tok, fp, s["cfg"], s["tpol"],
                               dataclasses.replace(tc, aug_loss=False))
    assert float(l_aug) == 2 * float(l_one)
    err0 = _qerr(s["tp"], q0, s["toks"], s["cfg"], s["tpol"])
    q_e2e, hist = train.e2equant(s["tp"], q0, s["toks"], s["cfg"], s["tpol"], tc)
    assert _qerr(s["tp"], q_e2e, s["toks"], s["cfg"], s["tpol"]) < err0
    assert all(np.isfinite(h) for h in hist)
    q_aug, _ = train.omniquant(s["tp"], q0, s["toks"], s["cfg"], s["tpol"], tc)
    assert _qerr(s["tp"], q_aug, s["toks"], s["cfg"], s["tpol"]) < err0
    q_plain, _ = train.omniquant(s["tp"], q0, s["toks"], s["cfg"], s["tpol"],
                                 dataclasses.replace(tc, aug_loss=False))
    diff = max(float(np.abs(v - _flat(qstate_to_numpy(q_plain))[k]).max())
               for k, v in _flat(qstate_to_numpy(q_aug)).items())
    assert diff > 0


def test_remat_gives_the_same_gradients(s):
    """remat recomputes each layer on the backward pass with that layer's
    quant state: the gradients equal the run without it."""
    _, q0 = _qstates(s, j_tr.TrainConfig(), train.TrainConfig())
    tok = torch.from_numpy(s["toks"][:2])
    fp, _, _ = M.forward_hidden(s["tp"], tok, s["cfg"], apply_final_norm=False)
    grads = []
    for remat in (False, True):
        tr = {k: train._trainable(v) for k, v in q0.items()}
        train.e2e_loss(s["tp"], tr, tok, fp, s["cfg"], s["tpol"],
                       train.TrainConfig(remat=remat)).backward()
        grads.append(_flat(train._map(lambda t: t.grad, tr)))
    for k, v in grads[0].items():
        np.testing.assert_array_equal(grads[1][k], v, err_msg=k)
