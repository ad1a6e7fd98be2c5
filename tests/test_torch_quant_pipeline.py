"""The quantization pipeline end to end, in the JAX CLI's quantize order
(mobilequant_tpu/cli.py cmd_quantize, then cmd_pack's pack), without file
I/O, on test-llama in both packages from the same FP params and tokens:

calibrate -> SmoothQuant LET init (alpha 0.5) -> recalibrate with the LET ->
stats_to_ranges -> init_qstate -> e2equant (epochs 0 or 1) -> finalize ->
head_input_absmax / smooth_last_scales (optional) -> pack (W4A8, the W4
head for smooth_last, else the fp head).

Each package runs its own pipeline: the port takes nothing of the JAX
package's state, only the FP params (carried across by
convert.from_jax_params) and the calibration tokens (data/calib, the same
numpy stream in both).
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
from mobilequant_tpu.quant import quantizer as j_q
from mobilequant_tpu.quant import smooth as j_sm
from mobilequant_tpu.quant import train as j_tr
from mobilequant_tpu.runtime import engine as JE

from mobilequant_tpu_torch.convert import from_jax_packed, from_jax_params
from mobilequant_tpu_torch.data import calib
from mobilequant_tpu_torch.models import get_config
from mobilequant_tpu_torch.quant import calibrate, policy as pol, qmodel, smooth, train
from mobilequant_tpu_torch.quant import quantizer as q
from mobilequant_tpu_torch.runtime import engine as E

W4 = dict(bitwidth=4, is_per_channel=True, is_symmetric=True)
S_MAX = 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree)}


def _jax_pipeline(jp, toks, jcfg, jpol, tc, smooth_last, head_bits):
    st = j_cal.run_calibration(jp, toks, jcfg, jpol, batch_size=tc.batch_size)
    let0 = j_sm.smoothquant_let_init(jcfg, *j_cal.smooth_calib_inputs(st), jp, alpha=0.5)
    st = j_cal.run_calibration(jp, toks, jcfg, jpol, let=let0, batch_size=tc.batch_size)
    qstate = j_tr.init_qstate(jp, jcfg, jpol, tc, j_cal.stats_to_ranges(st, jpol), let=let0)
    if tc.epochs > 0:
        qstate, _ = j_tr.e2equant(jp, qstate, toks, jcfg, jpol, tc)
    params, qfin = j_tr.finalize(jp, qstate, jcfg, jpol)
    s_last = None
    if smooth_last:
        am = j_cal.head_input_absmax(params, toks, jcfg)
        s_last = j_cal.smooth_last_scales(am, params["lm_head"]["w"], alpha=0.5)
    ecfg = JE.EngineConfig(model=jcfg, max_seq_len=S_MAX, weight_bits=4, head_bits=head_bits)
    packed = JE.pack(params, qfin["ranges"], jcfg, jpol, ecfg, smooth_last=s_last)
    return dict(qstate=qstate, params=params, packed=packed, s_last=s_last)


def _port_pipeline(tp, toks, cfg, tpol, tc, smooth_last, head_bits):
    st = calibrate.run_calibration(tp, toks, cfg, tpol, batch_size=tc.batch_size)
    let0 = smooth.smoothquant_let_init(cfg, *calibrate.smooth_calib_inputs(st, "cpu"), tp,
                                       alpha=0.5)
    st = calibrate.run_calibration(tp, toks, cfg, tpol, let=let0, batch_size=tc.batch_size)
    qstate = train.init_qstate(tp, cfg, tpol, tc, calibrate.stats_to_ranges(st, tpol, "cpu"),
                               let=let0, device="cpu")
    if tc.epochs > 0:
        qstate, _ = train.e2equant(tp, qstate, toks, cfg, tpol, tc)
    params, qfin = train.finalize(tp, qstate, cfg, tpol)
    s_last = None
    if smooth_last:
        am = calibrate.head_input_absmax(params, toks, cfg)
        s_last = calibrate.smooth_last_scales(am, params["lm_head"]["w"], alpha=0.5)
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=head_bits)
    packed = E.pack(params, qfin["ranges"], cfg, tpol, ecfg, device="cpu", smooth_last=s_last)
    return dict(qstate=qstate, params=params, qfin=qfin, packed=packed, s_last=s_last,
                ecfg=ecfg)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("test-llama")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config("test-llama")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    toks = calib.synthetic_tokens(cfg.vocab_size, nsamples=4, seqlen=16, seed=0)
    np.testing.assert_array_equal(toks, j_calib.synthetic_tokens(cfg.vocab_size, 4, 16, 0))
    return dict(jcfg=jcfg, jp=jp, cfg=cfg, toks=toks,
                tp=from_jax_params(jax.tree.map(np.asarray, jp), "cpu"),
                jpol=j_pol.default_policy(jcfg, j_q.QuantConfig(**W4), j_q.QuantConfig(bitwidth=8)),
                tpol=pol.default_policy(cfg, q.QuantConfig(**W4), q.QuantConfig(bitwidth=8)))


def _packs(st, epochs, smooth_last):
    kw = dict(epochs=epochs, batch_size=4)
    head_bits = 4 if smooth_last else 16
    j = _jax_pipeline(st["jp"], st["toks"], st["jcfg"], st["jpol"], j_tr.TrainConfig(**kw),
                      smooth_last, head_bits)
    t = _port_pipeline(st["tp"], st["toks"], st["cfg"], st["tpol"], train.TrainConfig(**kw),
                       smooth_last, head_bits)
    return j, t


def _compare_packs(jpacked, tpacked):
    """-> {leaf: (differing integer elements, elements)}; float leaves within
    rel 1e-5, the host ranges too."""
    ref = from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu")
    a, b = _flat({k: v for k, v in tpacked.items() if k != "ranges"}), \
        _flat({k: v for k, v in ref.items() if k != "ranges"})
    assert set(a) == set(b)
    ints = {}
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if np.issubdtype(b[k].dtype, np.integer):
            ints[k] = (int((a[k] != b[k]).sum()), a[k].size)
        else:
            assert _rel(a[k], b[k]) <= 1e-5, (k, _rel(a[k], b[k]))
    for k, v in _flat(ref["ranges"]).items():
        assert _rel(_flat(tpacked["ranges"])[k], v) <= 1e-5, k
    return ints


@pytest.mark.parametrize("smooth_last", [False, True], ids=["plain", "smooth_last"])
def test_epochs0_pack_equals_jax_pack(setup, smooth_last):
    """Calibration, the SmoothQuant LET init and finalize with no training:
    the port's pack of its own ranges equals the JAX pack of the JAX ranges
    leaf for leaf, the integer leaves (the W4 weights, the W4 head) bit for
    bit, the float leaves within rel 1e-5 (their statistics pass through
    fp32 matmuls in both). The port's engine on its own pack holds its own
    sim within rel 2e-3 (tests/test_engine.py:73's rung): with the fp head
    the sim's logits, with the smooth_last head the sim's hidden divided by
    s_last through the same packed head (cmd_pack --verify's comparison)."""
    j, t = _packs(setup, 0, smooth_last)
    ints = _compare_packs(j["packed"], t["packed"])
    assert ints and all(n == 0 for n, _ in ints.values()), ints
    if smooth_last:
        assert _rel(t["s_last"].numpy(), j["s_last"]) <= 1e-5
        assert "head_q" in t["packed"]

    cfg, tok = setup["cfg"], torch.from_numpy(setup["toks"][:2])
    eng, _ = E.forward(t["packed"], tok, cfg, setup["tpol"])
    if smooth_last:
        h, _, _ = qmodel.qforward_hidden(t["params"], t["qfin"], tok, cfg, setup["tpol"])
        sim = E.quantized_head_logits(h / t["s_last"], t["packed"]["head_q"], cfg.vocab_size,
                                      use_kernel=False)
    else:
        sim, _, _ = qmodel.qforward(t["params"], t["qfin"], tok, cfg, setup["tpol"])
    assert _rel(eng.numpy(), sim.numpy()) < 2e-3


def test_epochs1_state_and_pack_match_jax(setup):
    """One e2equant epoch (one step of LET, LWC and LRL from the pipeline's
    init) in both pipelines.

    Adam's first step moves an element by lr·g/(|g| + 1e-8): by lr times
    the gradient's sign, unless |g| is near 1e-8 or its sign is cancellation
    noise (the range entries of the training tests), where the two
    frameworks' gradients, equal to 1e-4 of each leaf's largest (the
    gradient test), move it differently. So every element of the state is
    within rel 1e-3 of the JAX pipeline's (of its leaf's largest), except a
    counted set, each of which is within 2 lr of its group of JAX's: read
    11 of the 1,536 LET elements (held at 2%; the largest gap 0.0075 lr), 0
    of the 3,072 LWC factors, 6 of the 156 range entries (held at 10%; the
    largest 1.2 lr). The packs' integer weights: at most one step apart, on
    at most 0.1% of the elements (read: none differ)."""
    j, t = _packs(setup, 1, False)
    tc = train.TrainConfig()
    lrs = {"let": tc.let_lr, "lwc": tc.lwc_lr, "ranges": tc.lrl_lr}
    share = {"let": 0.02, "lwc": 0.02, "ranges": 0.1}
    a, b = _flat(t["qstate"]), _flat(jax.tree.map(np.asarray, j["qstate"]))
    assert set(a) == set(b)
    for grp, lr in lrs.items():
        off = size = 0
        for k in (k for k in b if k.startswith(f"/{grp}/")):
            gap = np.abs(a[k] - b[k])
            out = gap > 1e-3 * np.abs(b[k]).max()
            assert (gap[out] <= 2 * lr).all(), (k, gap.max() / lr)
            off += int(out.sum())
            size += b[k].size
        assert off <= share[grp] * size, (grp, off, size)
    for k, (n, size, steps) in _compare_packs_int_steps(j["packed"], t["packed"]).items():
        assert steps <= 1 and n <= 1e-3 * size, (k, n, size, steps)


def _compare_packs_int_steps(jpacked, tpacked):
    """-> {integer leaf: (differing elements, elements, the largest
    difference in quantization steps)} (W4 nibbles compared unpacked)."""
    from mobilequant_tpu_torch.ops.qops import unpack_nibbles
    ref = from_jax_packed(jax.tree.map(np.asarray, jpacked), "cpu")
    out = {}
    for name in ("qkv_proj", "o_proj", "w13_proj", "w2"):
        x, y = tpacked["layers"][name]["wq"], ref["layers"][name]["wq"]
        x, y = unpack_nibbles(x).to(torch.int32), unpack_nibbles(y).to(torch.int32)
        d = (x - y).abs()
        out[name] = (int((d > 0).sum()), d.numel(), int(d.max()))
    return out


def test_smooth_last_head_fold(setup):
    """tests/test_engine.py::test_smooth_last_head_fold on the port's own
    pipeline: with an outlier channel in the final norm's weight (channel 3,
    x40), the smooth_last scales shrink that channel, the identity fold
    equals no fold bit for bit, the fold reduces the quantized head's error
    against the fp-head pack, and an fp-head pack refuses the fold."""
    cfg, tpol, toks = setup["cfg"], setup["tpol"], setup["toks"]
    tp = dict(setup["tp"])
    nw = tp["norm"]["w"].clone()
    nw[3] *= 40.0
    tp["norm"] = {"w": nw, "b": tp["norm"]["b"]}
    ranges = calibrate.stats_to_ranges(calibrate.run_calibration(tp, toks, cfg, tpol,
                                                                 batch_size=2), tpol, "cpu")
    ecfg = E.EngineConfig(model=cfg, max_seq_len=S_MAX, head_bits=4)
    am = calibrate.head_input_absmax(tp, toks, cfg, batch_size=2)
    s = calibrate.smooth_last_scales(am, tp["lm_head"]["w"], alpha=0.5)
    assert float(s[3]) > float(s.median()) * 2

    packed_fp = E.pack(tp, ranges, cfg, tpol, E.EngineConfig(model=cfg, max_seq_len=S_MAX),
                       device="cpu")
    packed_q = E.pack(tp, ranges, cfg, tpol, ecfg, device="cpu")
    packed_s = E.pack(tp, ranges, cfg, tpol, ecfg, device="cpu", smooth_last=s)
    packed_1 = E.pack(tp, ranges, cfg, tpol, ecfg, device="cpu", smooth_last=torch.ones_like(s))
    assert torch.equal(packed_1["head_q"]["wq"], packed_q["head_q"]["wq"])
    assert torch.equal(packed_1["norm"]["w"], packed_q["norm"]["w"])

    t = torch.from_numpy(toks)
    ref = E.forward(packed_fp, t, cfg, tpol)[0]
    err_q = float((E.forward(packed_q, t, cfg, tpol)[0] - ref).abs().max())
    err_s = float((E.forward(packed_s, t, cfg, tpol)[0] - ref).abs().max())
    assert err_s < err_q, (err_s, err_q)
    with pytest.raises(ValueError, match="smooth_last"):
        E.pack(tp, ranges, cfg, tpol, E.EngineConfig(model=cfg, max_seq_len=S_MAX),
               device="cpu", smooth_last=s)

    # the JAX pack of the same params, ranges and scales: the same head and norm
    jp = dict(setup["jp"])
    jp["norm"] = {"w": jnp.asarray(nw.numpy()), "b": jp["norm"]["b"]}
    jr = jax.tree.map(lambda v: jnp.asarray(v.numpy()), ranges)
    jpk = JE.pack(jp, jr, setup["jcfg"], setup["jpol"],
                  JE.EngineConfig(model=setup["jcfg"], max_seq_len=S_MAX, weight_bits=4,
                                  head_bits=4), smooth_last=jnp.asarray(s.numpy()))
    ref_pk = from_jax_packed(jax.tree.map(np.asarray, jpk), "cpu")
    for k in ("wq", "scale"):
        np.testing.assert_array_equal(packed_s["head_q"][k].numpy(), ref_pk["head_q"][k].numpy())
    for k in ("w", "b"):
        np.testing.assert_array_equal(packed_s["norm"][k].numpy(), ref_pk["norm"][k].numpy())
