"""The arithmetic of two tensor-core kernels, modelled in PyTorch on the CPU.

csrc/prefill_attention.cu (row 4) and csrc/wonly_matmul.cu (rows 12 / 13)
run on the card only. This file repeats their order of arithmetic in a few
lines each and holds the models against the plain versions that chip_smoke.py
holds the kernels against, with chip_smoke.py's tolerances.

Row 4's scores are the plain version's (the kernel keeps that fp32 order).
Relaxed policy: 64-column tiles taken in 32-column halves with an online
softmax (exp2 of (s − m)·log2 e). Even tiles go to one column group and odd
tiles to the other, merged at the end. P·2^15 is split into fp16 hi and
lo = p − hi against V exact in fp16, summed in fp32. Held to relative 1e-4.
Strict policy: the exact row max, the denominator summed in fp64, then
fake-quantized probabilities through the same split. Held to 32 probability
steps of the output, with the count of probabilities that move.

Rows 12 / 13: the weight side is the centred integer q − c (W4: nibble − 8,
W8: the int8 byte), exact in bf16. x is split into three bf16 terms (fp32 x)
or one (bf16 x). Each group's sum Σ x·(q − c) is formed in fp32; the offset
comes in as the correction (o − c)·Σx, with Σx summed in fp32: grouped, the
groups add sum·s_g − ((o_g − c)·s_g)·Σx_g in order; else
(sum − (o − c)·Σx)·s. Every
edition is held to relative 1e-5: W4 / W8, per tensor / per channel / g128,
fp32 / bf16 x, and packs of one-signed weights, whose offsets lie far outside
the code range (W8: about −1000). The pack's zero-point is a whole number in
the JAX package and the port alike; the wrappers serve any offset.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mobilequant_tpu.models import model as JM
from mobilequant_tpu.models.registry import MODEL_CONFIGS as J_CONFIGS
from mobilequant_tpu.ops import qops as JQ
from mobilequant_tpu.quant import quantizer as JQZ
from mobilequant_tpu.runtime import wonly as JW

from mobilequant_tpu_torch.convert import from_jax_params
from mobilequant_tpu_torch.models.registry import MODEL_CONFIGS
from mobilequant_tpu_torch.ops import qops as Q
from mobilequant_tpu_torch.ops.prefill_attention import prefill_attention_plain
from mobilequant_tpu_torch.ops.qops import f32, int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq
from mobilequant_tpu_torch.ops.wonly_matmul import (
    w4a16_matmul, w4a16_matmul_plain, wonly_matmul_stacked, wonly_matmul_stacked_plain)
from mobilequant_tpu_torch.quant.quantizer import QuantConfig
from mobilequant_tpu_torch.runtime import wonly as W

LOG2E = 1.44269504088896341
PSCALE = 32768.0
# chip_smoke.py's attention meta at the 16-bit sites of the strict policy
META = [0.05, 130.0, 0.04, 126.0, 0.03, 128.0, 1.0, 0.0, 255.0, 1.0, 0.0, 255.0, -40000.0]
STRICT_SITES = [80.0 / 65535, 32768.0, 65535.0, 1.0 / 65535, 0.0, 65535.0]


def _meta(strict):
    m = list(META)
    if strict:
        m[6:12] = STRICT_SITES
    return m


# ---- row 4 ------------------------------------------------------------------

def _scores(q8, k8, m, positions, valid, qk_fq):
    """The masked scores, in the plain version's fp32 order (the kernel keeps
    it bit for bit): (B, Hkv, G, T, S)."""
    B, Hkv, G, T, hd = q8.shape
    S = k8.shape[2]
    oq = f32(np.float32(m[1]) - np.float32(128.0))
    ok = f32(np.float32(m[3]) - np.float32(128.0))
    q2 = q8.reshape(B, Hkv, G * T, hd)
    sc = (int_dot(q2, k8.transpose(-1, -2)) - ok * rowsum_i8(q2)
          - oq * rowsum_i8(k8)[..., 0][:, :, None, :]
          + f32(np.float32(hd) * np.float32(oq) * np.float32(ok)))
    sc = sc * f32(np.float32(m[0]) * np.float32(m[2]))
    if qk_fq:
        sc = _fq(sc, m[6], m[7], m[8])
    sc = sc * (1.0 / math.sqrt(hd))
    col = torch.arange(S)
    vis = (col[None, None, :] <= positions[:, :, None]) & (col[None, None, :] < valid[:, None, None])
    return sc.reshape(B, Hkv, G, T, S) + torch.where(vis, 0.0, m[12])[:, None, None]


def _pv(p, v):
    """p (…, n) fp32 in [0, 1] · v (…, n, hd) int8: p·2^15 as fp16 hi + lo,
    each product exact, the sums in fp32; returns the sum · 2^15."""
    ps = p * PSCALE
    hi = ps.to(torch.float16).to(torch.float32)
    lo = (ps - hi).to(torch.float16).to(torch.float32)
    vf = v.to(torch.float32)
    return torch.matmul(hi, vf) + torch.matmul(lo, vf)


def _prefill_model(q8, k8, v8, m, positions, valid, strict):
    """csrc/prefill_attention.cu's order of arithmetic (B, Hkv, G, T, hd)."""
    ncols = int(min(int(positions.max()) + 1, int(valid.max()), k8.shape[2]))
    ntiles = -(-ncols // 64)
    sc = _scores(q8, k8, m, positions, valid, strict)[..., :64 * ntiles]
    vt = v8[:, :, None, :64 * ntiles]                           # (B, Hkv, 1, S', hd)
    ov = f32(np.float32(m[5]) - np.float32(128.0))
    if strict:
        mx = sc.amax(-1, keepdim=True)
        l = torch.exp(sc - mx).to(torch.float64).sum(-1, keepdim=True).to(torch.float32)
        p = _fq(torch.exp(sc - mx) * (1.0 / torch.clamp(l, min=1e-30)), m[9], m[10], m[11])
        out = (_pv(p, vt) * (1.0 / PSCALE) - ov * p.sum(-1, keepdim=True)) * m[4]
        return out, p
    state = []
    for grp in (0, 1):                  # even tiles, odd tiles: the two column groups
        mr = torch.full(sc.shape[:-1] + (1,), -1e30)
        lr = torch.zeros_like(mr)
        o = torch.zeros(sc.shape[:-1] + (v8.shape[-1],))
        for ti in range(grp, ntiles, 2):
            for hh in (0, 1):
                c0 = 64 * ti + 32 * hh
                s = sc[..., c0:c0 + 32]
                m_new = torch.maximum(mr, s.amax(-1, keepdim=True))
                rsc = torch.exp2((mr - m_new) * LOG2E)
                p = torch.exp2((s - m_new) * LOG2E)
                o = o * rsc + _pv(p, vt[..., c0:c0 + 32, :])
                lr = lr * rsc + p.sum(-1, keepdim=True)
                mr = m_new
        state.append((mr, lr, o))
    (m0, l0, o0), (m1, l1, o1) = state
    mm = torch.maximum(m0, m1)
    sa, sb = torch.exp2((m0 - mm) * LOG2E), torch.exp2((m1 - mm) * LOG2E)
    l = l0 * sa + l1 * sb
    o = o0 * sa + o1 * sb
    return (o * (1.0 / PSCALE) - ov * l) * (1.0 / torch.clamp(l, min=1e-30)) * m[4], None


def _plain_probs(q8, k8, m, positions, valid):
    sc = _scores(q8, k8, m, positions, valid, True)
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    return _fq(e * (1.0 / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)), m[9], m[10], m[11])


@pytest.mark.parametrize("strict", [False, True], ids=["relaxed", "strict"])
@pytest.mark.parametrize("shape", [
    (1, 4, 8, 128, 256, 0, (128,)),          # TinyLlama: T=128 into S=256
    (2, 4, 8, 100, 256, 37, (137, 120)),     # ragged: positions from 37, valid 137 / 120
    (1, 8, 1, 100, 256, 37, (137,)),         # G = 1 (StableLM's grouping)
], ids=["tinyllama-t128", "ragged-g8", "ragged-g1"])
def test_prefill_attention_model_matches_plain(shape, strict):
    B, Hkv, G, T, S, pos0, vals = shape
    rng = np.random.default_rng(T + G + int(strict))
    q8 = torch.from_numpy(rng.integers(-128, 128, (B, Hkv, G, T, 64), dtype=np.int8))
    k8 = torch.from_numpy(rng.integers(-128, 128, (B, Hkv, S, 64), dtype=np.int8))
    v8 = torch.from_numpy(rng.integers(-128, 128, (B, Hkv, S, 64), dtype=np.int8))
    positions = (pos0 + torch.arange(T, dtype=torch.int32))[None].repeat(B, 1)
    valid = torch.tensor(vals, dtype=torch.int32)
    m = _meta(strict)
    out, p = _prefill_model(q8, k8, v8, m, positions, valid, strict)
    ref = prefill_attention_plain(q8, k8, v8, m, positions, valid, strict, strict)
    err = (out - ref).abs().max().item()
    if not strict:
        assert err <= 1e-4 * ref.abs().max().item(), err
        return
    # a probability one ulp off a rounding boundary moves by a whole step:
    # count them, and hold the output to 32 steps (chip_smoke.py's limit)
    pstep = m[9] * (v8.float() - (m[5] - 128.0)).abs().max().item() * m[4]
    pp = _plain_probs(q8, k8, m, positions, valid)[..., :p.shape[-1]]
    moved = int(((p - pp).abs() > 0.5 * m[9]).sum())
    print(f"strict {shape}: {moved} of {p.numel()} probabilities moved a step; "
          f"output error {err / pstep:.2f} steps")
    assert err <= 32 * pstep, (err / pstep, moved)


# ---- rows 12 / 13 -------------------------------------------------------------

def _x_terms(x):
    """fp32 x as three bf16 terms (24 bits); bf16 x as itself."""
    if x.dtype == torch.bfloat16:
        return [x.to(torch.float32)]
    terms, r = [], x.to(torch.float32)
    for _ in range(3):
        t = r.to(torch.bfloat16).to(torch.float32)
        terms.append(t)
        r = r - t
    return terms


def _wonly_model(x, wq, scale, offset, bias):
    """csrc/wonly_matmul.cu's order: per group Σ x·(q − c) over bf16 terms and
    Σx, in fp32; grouped, the groups add sum·s_g − ((o_g − c)·s_g)·Σx in
    order; else (sum − (o − c)·Σx)·s; + bias."""
    K = x.shape[-1]
    w4 = wq.shape[0] * 2 == K
    c = 8.0 if w4 else 0.0
    qc = (Q.unpack_nibbles(wq) if w4 else wq).to(torch.float32) - c
    assert torch.equal(qc, qc.to(torch.bfloat16).to(torch.float32))   # exact in bf16
    N = qc.shape[-1]
    G = scale.shape[0] if scale.dim() == 3 else 1
    sc = scale.reshape(G, N) if scale.dim() else scale.reshape(1, 1).expand(1, N)
    oc = (offset.reshape(G, N) if offset.dim() else offset.reshape(1, 1).expand(1, N)) - c
    terms = _x_terms(x)
    gsz = K // G
    sums, xsum = [], []
    for g in range(G):
        sl = slice(g * gsz, (g + 1) * gsz)
        sums.append(sum(torch.matmul(t[:, sl], qc[sl]) for t in terms))
        xsum.append(x[:, sl].to(torch.float32).sum(-1, keepdim=True))
    if G == 1:
        out = (sums[0] - oc[0] * xsum[0]) * sc[0]
    else:
        out = torch.zeros((x.shape[0], N))
        for g in range(G):
            out = out + sums[g] * sc[g] - (oc[g] * sc[g]) * xsum[g]
    return out if bias is None else out + bias


def _stack(bits, kind, K, N, L, rng, mean=0.0):
    """L packed layers of normal(mean, 0.02) weights: mean 0.5 makes every
    weight one-signed, so the zero-point lies far outside the code range."""
    cfg = QuantConfig(bitwidth=bits, is_per_channel=kind != "tensor",
                      group_size=128 if kind == "g128" else -1)
    ps = [Q.pack_weight(torch.from_numpy(
        (rng.normal(size=(K, N)) * 0.02 + mean).astype(np.float32)), cfg) for _ in range(L)]
    pk = {k: torch.stack([p[k] for p in ps]) for k in ("wq", "scale", "offset")}
    pk["bias"] = torch.from_numpy(rng.normal(size=(L, N)).astype(np.float32) * 0.01)
    return pk


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["x32", "xbf16"])
@pytest.mark.parametrize("kind", ["tensor", "channel", "g128"])
@pytest.mark.parametrize("bits", [4, 8])
def test_wonly_model_matches_plain(bits, kind, xdt):
    """Row 12 at M = 1, 3, 8 on TinyLlama's k/v shape (2048 -> 256), layer 1."""
    rng = np.random.default_rng(bits * 10 + len(kind))
    pk = _stack(bits, kind, 2048, 256, 2, rng)
    for M in (1, 3, 8):
        x = torch.from_numpy(rng.normal(size=(M, 2048)).astype(np.float32)).to(xdt)
        ref = wonly_matmul_stacked_plain(x, pk["wq"], pk["scale"], pk["offset"], pk["bias"], 1)
        out = _wonly_model(x, pk["wq"][1], pk["scale"][1], pk["offset"][1], pk["bias"][1])
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 1e-5, (M, err)


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=["x32", "xbf16"])
@pytest.mark.parametrize("kind", ["tensor", "channel"])
def test_w4a16_model_matches_plain(kind, xdt):
    """Row 13 at M = 1, 8, 100, 128 (q's width, 2048 -> 2048 cut to 512 columns)."""
    rng = np.random.default_rng(13 + len(kind))
    pk = _stack(4, kind, 2048, 512, 1, rng)
    wq, sc, of, b = pk["wq"][0], pk["scale"][0], pk["offset"][0], pk["bias"][0]
    for M in (1, 8, 100, 128):
        x = torch.from_numpy(rng.normal(size=(M, 2048)).astype(np.float32)).to(xdt)
        ref = w4a16_matmul_plain(x, wq, sc, of, b)
        out = _wonly_model(x, wq, sc, of, b)
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        assert err <= 1e-5, (M, err)


@pytest.mark.parametrize("kind", ["tensor", "channel", "g128"])
@pytest.mark.parametrize("bits", [4, 8])
def test_wonly_model_one_sign_packs(bits, kind):
    """Row 12 on packs of one-signed weights (offsets far outside the code
    range: W8 about −1000), where the correction (o − c)·Σx is largest."""
    rng = np.random.default_rng(100 + bits * 10 + len(kind))
    pk = _stack(bits, kind, 2048, 256, 2, rng, mean=0.5)
    assert pk["offset"].abs().max() > 20
    for xdt in (torch.float32, torch.bfloat16):
        for M in (1, 8):
            x = torch.from_numpy(rng.normal(size=(M, 2048)).astype(np.float32)).to(xdt)
            ref = wonly_matmul_stacked_plain(x, pk["wq"], pk["scale"], pk["offset"],
                                             pk["bias"], 1)
            out = _wonly_model(x, pk["wq"][1], pk["scale"][1], pk["offset"][1], pk["bias"][1])
            err = (out - ref).abs().max().item() / ref.abs().max().item()
            assert err <= 1e-5, (xdt, M, err)


def _assert_offsets_whole(offset, what):
    o = np.asarray(offset, dtype=np.float64)
    assert np.array_equal(o, np.round(o)), what


@pytest.mark.parametrize("kind", ["tensor", "channel", "g128"])
@pytest.mark.parametrize("bits", [4, 8])
def test_packs_have_whole_offsets(bits, kind):
    """The JAX package's pack_weight and the port's round the zero-point, so
    every offset is a whole number, per tensor, per channel and g128, W4 and
    W8, one-signed weights too."""
    rng = np.random.default_rng(bits + len(kind))
    kw = dict(bitwidth=bits, is_per_channel=kind != "tensor",
              group_size=128 if kind == "g128" else -1)
    for scale, mean in ((0.02, 0.0), (1.0, 0.0), (0.02, 0.5)):
        w = (rng.normal(size=(512, 64)) * scale + mean).astype(np.float32)
        _assert_offsets_whole(JQ.pack_weight(jnp.asarray(w), JQZ.QuantConfig(**kw))["offset"],
                              ("jax", kw))
        _assert_offsets_whole(Q.pack_weight(torch.from_numpy(w), QuantConfig(**kw))["offset"],
                              ("port", kw))


@pytest.mark.parametrize("bits,gs", [(4, 16), (8, -1), (4, -1), (8, 32)],
                         ids=["w4g16", "w8pc", "w4pc", "w8g32"])
def test_pack_weight_only_offsets_whole(bits, gs):
    """pack_weight_only of the JAX package and of the port (test-llama)."""
    jcfg = J_CONFIGS["test-llama"]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    kw = dict(bitwidth=bits, is_per_channel=True, group_size=gs, is_symmetric=False)
    jpacked = JW.pack_weight_only(jp, jcfg, JQZ.QuantConfig(**kw))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    packed = W.pack_weight_only(tp, MODEL_CONFIGS["test-llama"], QuantConfig(**kw))
    assert set(jpacked["packs"]) == set(packed["packs"])
    for key in packed["packs"]:
        _assert_offsets_whole(jpacked["packs"][key]["offset"], ("jax", key))
        _assert_offsets_whole(packed["packs"][key]["offset"], ("port", key))
    jax.clear_caches()


@pytest.mark.parametrize("shift", [0.5, -1000.25, float("nan")],
                         ids=["half", "far", "nan"])
def test_wrappers_serve_any_offsets(shift):
    """The wrappers take any offset (the kernel corrects by (o − c)·Σx): on
    the CPU they return the plain version's result, and the kernel's model
    holds to it (NaN offsets: NaN in the same columns)."""
    rng = np.random.default_rng(7)
    pk = _stack(4, "channel", 64, 32, 2, rng)
    x = torch.from_numpy(rng.normal(size=(2, 64)).astype(np.float32))
    off = pk["offset"].clone()
    off[1, 0, 3] += shift
    before = (wonly_matmul_stacked.plain_calls, w4a16_matmul.plain_calls)
    out = wonly_matmul_stacked(x, pk["wq"], pk["scale"], off, pk["bias"], 1)
    out13 = w4a16_matmul(x, pk["wq"][1], pk["scale"][1], off[1], pk["bias"][1])
    assert (wonly_matmul_stacked.plain_calls, w4a16_matmul.plain_calls) == (
        before[0] + 1, before[1] + 1)
    ref = wonly_matmul_stacked_plain(x, pk["wq"], pk["scale"], off, pk["bias"], 1)
    assert torch.equal(out.isnan(), ref.isnan()) and torch.equal(out13.isnan(), ref.isnan())
    model = _wonly_model(x, pk["wq"][1], pk["scale"][1], off[1], pk["bias"][1])
    assert torch.equal(model.isnan(), ref.isnan())
    fin = ~ref.isnan()
    err = (model - ref)[fin].abs().max().item() / ref[fin].abs().max().item()
    assert err <= 1e-5, err
    assert torch.equal(out[fin], ref[fin]) and torch.equal(out13[fin], ref[fin])
