"""The arithmetic of the two cluster decode attention kernels, modelled in
PyTorch on the CPU.

csrc/decode_attention.cu (row 15: T = 1 attention over the int8 cache) and
csrc/kv4_attention.cu (row 10: staged T = 1 attention over the nibble-packed
int4 cache) run on the card only. Each splits the positions that one
(sequence, kv head) reads over the ncl blocks of a thread-block cluster and
meets the blocks' statistics in distributed shared memory. This file models
that split over the blocks and the global-max softmax, and holds the model
bit for bit against the plain versions that chip_smoke.py holds the kernels
against (error 0):

  * the read positions split into ncl contiguous stripes of ceil(n / ncl)
    (row 15: rows < n; row 10: words of four packed columns, both nibble
    planes; the staged columns and the self row go to the last block);
  * a max per stripe, then the global max (-FLT_MAX for an empty stripe);
  * the exps against the global max, in fp32;
  * fp64 partial denominators, ΣP and P·V per stripe, added in stripe order
    and rounded once to fp32; P = e / den [fq16] in between where the policy
    needs den first.

The order inside a block (strided thread partials, lane shuffles, warps in
index order) is not modelled: it rests on the same argument (fp64 sums of
terms exact in fp64, rounded once) and on the checks on the card
(chip_smoke.py, scripts/check_decode_attention.py).

Swept: cluster sizes 1..16 (the kernels take up to 8; 16 shows that the
result does not hang on the split), valid lengths 1, 15, 16, 17, a middle
value and S (row 15), positions on both sides of S/2 with 0, 5 and cs staged
columns (row 10), G = 1 and 8, the relaxed policy, the strict one and a
strict meta whose fq16(0) is not 0 (every position read, masked). Last, the
wrappers' cluster-size choice, a function of the shapes and the SM count
only.
"""

import numpy as np
import pytest
import torch

from mobilequant_tpu_torch.ops import qops
from mobilequant_tpu_torch.ops import decode_attention as DA
from mobilequant_tpu_torch.ops import kv4_attention as KV
from mobilequant_tpu_torch.ops.qops import int_dot, rowsum_i8
from mobilequant_tpu_torch.ops.w13_gate import _fq

NEG = float(np.finfo(np.float32).min)
CLUSTERS = [1, 2, 4, 8, 16]
# attention metas (the JAX engine's 13 floats): relaxed; strict (16-bit score
# and probability sites); strict with the pv_bmm input offset below 0, so
# fq16(0) = 3·s is not 0 and every position is read
META = [0.05, 130.0, 0.04, 126.0, 0.03, 128.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, -40000.0]
META4 = [0.02, 130.0, 0.5, 7.25, 0.4, 7.5, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0, -40000.0]
STRICT = [80.0 / 65535, 32768.0, 65535.0, 1.0 / 65535, 0.0, 65535.0]
STRICT_ALL = [80.0 / 65535, 32768.0, 65535.0, 1.0 / 65535, -3.0, 65535.0]
POLICIES = {"relaxed": None, "strict": STRICT, "strict_all_read": STRICT_ALL}


def _meta(base, policy):
    m = list(base)
    if POLICIES[policy] is not None:
        m[6:12] = POLICIES[policy]
    return m


def _stripe(n, ncl, rank):
    """(first, count) of rank's stripe of n positions (the kernels' rule)."""
    per = -(-n // ncl)
    first = min(rank * per, n)
    return first, min(n - first, per)


def _fold(parts):
    """fp64 partials added in stripe order, rounded once to fp32."""
    s = torch.zeros((), dtype=torch.float64)
    for v in parts:
        s = s + v
    return s.to(torch.float32)


# ---- row 15 ------------------------------------------------------------------

def _da_model(q8, k8, v8, meta, valid, ncl):
    """decode_attention in the kernel's order (B, Hkv, G, hd) fp32."""
    B, Hkv, G, hd = q8.shape
    S = k8.shape[2]
    k = DA._consts(meta, hd)
    m = k["m"]
    skip = m[11] <= 0.5 or 0.0 <= m[10] <= m[11]
    out = torch.empty((B, Hkv, G, hd), dtype=torch.float32)
    for b in range(B):
        vlen = int(valid[b])
        n = min(max(vlen, 0), S) if skip else S
        for h in range(Hkv):
            q, kk, vv = q8[b, h], k8[b, h], v8[b, h]
            sc = (int_dot(q, kk.T) - k["ok"] * rowsum_i8(q) - k["oq"] * rowsum_i8(kk).T
                  + k["c_hd"]) * k["sqk"]                          # (G, S), the fp32 epilogue
            if m[8] > 0.5:
                sc = _fq(sc, m[6], m[7], m[8])
            sc = sc * k["inv"]
            rows = torch.arange(S)
            sc = sc + torch.where(rows < vlen, torch.zeros(()), torch.tensor(m[12]))
            parts = [_stripe(n, ncl, r) for r in range(ncl)]
            mx = torch.full((G,), NEG)
            for r0, nr in parts:
                if nr:
                    mx = torch.maximum(mx, sc[:, r0:r0 + nr].amax(-1))
            e = [torch.exp(sc[:, r0:r0 + nr] - mx[:, None]) for r0, nr in parts]
            den = _fold([x.to(torch.float64).sum(-1) for x in e])
            p = [x / den[:, None] for x in e]
            if m[11] > 0.5:
                p = [_fq(x, m[9], m[10], m[11]) for x in p]
            psum = _fold([x.to(torch.float64).sum(-1) for x in p])
            pv = _fold([x.to(torch.float64) @ vv[r0:r0 + nr].to(torch.float64)
                        for x, (r0, nr) in zip(p, parts)])
            out[b, h] = (pv - k["ov"] * psum[:, None]) * m[4]
    return out


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("G", [1, 6, 8])
@pytest.mark.parametrize("ncl", CLUSTERS)
def test_decode_attention_model_matches_plain(ncl, G, policy):
    B, Hkv, S, hd = 2, 2, 64, 64
    rng = np.random.default_rng(100 * ncl + 10 * G + len(policy))
    meta = _meta(META, policy)
    q8 = torch.from_numpy(rng.integers(-128, 128, (B, Hkv, G, hd)).astype(np.int8))
    k8 = torch.from_numpy(rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8))
    v8 = torch.from_numpy(rng.integers(-128, 128, (B, Hkv, S, hd)).astype(np.int8))
    for v0, v1 in ((1, 15), (16, 17), (37, S)):
        valid = torch.tensor([v0, v1], dtype=torch.int32)
        ref = DA.decode_attention_plain(q8, k8, v8, meta, valid)
        got = _da_model(q8, k8, v8, meta, valid, ncl)
        assert torch.isfinite(ref).all()
        assert torch.equal(got, ref), (v0, v1, (got - ref).abs().max())


# ---- row 10 ------------------------------------------------------------------

def _kv4_scores(q8, kp, kcs, sk, k_new, meta, pos, mst, layer, qk_fq):
    """The four score parts of the plain version (lo, hi, staged: masked;
    self), (BH, G, ·) fp32: the kernel keeps their fp32 order."""
    BH, G, hd = q8.shape
    B = pos.shape[0]
    S2 = kp.shape[3]
    cs = sk.shape[2]
    k = KV._consts(meta, hd, qk_fq)
    m = k["m"]
    qs = rowsum_i8(q8)
    posb = pos.to(torch.int64)[:, None].expand(B, BH // B).reshape(BH, 1, 1)
    kpl, kcl = kp[layer], kcs[layer]

    def fq(sc):
        return _fq(sc, m[6], m[7], m[8]) * k["inv"] if qk_fq else sc

    def part(k4, ksum, valid):
        sc = (int_dot(q8, k4) - k["ok"] * qs - k["oqs"] * (ksum[:, None, :] + k["ksh"])
              + k["c_lo"]) * k["cf"]
        return fq(sc) + torch.where(valid, torch.zeros(()), torch.tensor(m[12]))

    col = torch.arange(S2)[None, None, :]
    lo = part(kpl & 0x0F, kcl[:, :S2], col < posb)
    hi = part((kpl >> 4) & 0x0F, kcl[:, S2:], S2 + col < posb)
    skl = sk[layer]
    sc = (int_dot(q8, skl.transpose(-1, -2)) - k["oks"] * qs
          - k["oqs"] * rowsum_i8(skl).transpose(-1, -2) + k["c_st"]) * k["cf"]
    st = fq(sc) + torch.where(torch.arange(cs)[None, None, :] < mst, torch.zeros(()),
                              torch.tensor(m[12]))
    prod = (q8.to(torch.float32) - k["oqs"]) * (k_new.reshape(BH, 1, hd).to(torch.float32)
                                                - k["oks"])
    s_self = prod.to(torch.float64).sum(-1, keepdim=True).to(torch.float32) * k["sqk"]
    if qk_fq:
        s_self = _fq(s_self, m[6], m[7], m[8])
    return lo, hi, st, s_self * k["inv"]


def _kv4_model(q8, kp, vp, kcs, sk, sv, k_new, v_new, meta, pos, mst, layer, qk_fq, pv_fq,
               ncl):
    """kv4_decode_attention in the kernel's order (BH, G, hd) fp32."""
    BH, G, hd = q8.shape
    B = pos.shape[0]
    S2 = kp.shape[3]
    cs = sk.shape[2]
    m = [float(v) for v in meta]
    skip = (not pv_fq) or (0.0 <= m[10] <= m[11])
    lo, hi, st, sf = _kv4_scores(q8, kp, kcs, sk, k_new, meta, pos, mst, layer, qk_fq)
    out = torch.empty((BH, G, hd), dtype=torch.float32)
    for bh in range(BH):
        p = int(pos[bh // (BH // B)])
        nlo = min(max(p, 0), S2) if skip else S2
        nhi = min(max(p - S2, 0), S2) if skip else S2
        nw = -(-nlo // 4)
        vpl = vp[layer, bh]
        # per stripe: its scores (G, n) and V values (n, hd), columns in word order
        parts = []
        for r in range(ncl):
            w0, nwr = _stripe(nw, ncl, r)
            scs, vs = [], []
            for j in range(w0, w0 + nwr):
                c = slice(4 * j, 4 * j + 4)
                scs.append(lo[bh, :, c])
                vs.append((vpl[:, c] & 0x0F).T)
                if 4 * j < nhi:
                    scs.append(hi[bh, :, c])
                    vs.append(((vpl[:, c] >> 4) & 0x0F).T)
            if r == ncl - 1:
                ncs = mst if skip else cs
                scs += [st[bh, :, :ncs], sf[bh]]
                vs += [sv[layer, bh, :ncs] & 0x0F, v_new[bh].reshape(1, hd) & 0x0F]
            parts.append((torch.cat(scs, -1) if scs else torch.empty((G, 0)),
                          torch.cat(vs, 0).to(torch.float64) if vs
                          else torch.empty((0, hd), dtype=torch.float64)))
        mx = torch.full((G,), NEG)
        for s, _ in parts:
            if s.shape[1]:
                mx = torch.maximum(mx, s.amax(-1))
        e = [torch.exp(s - mx[:, None]) for s, _ in parts]
        den = _fold([x.to(torch.float64).sum(-1) for x in e])
        if pv_fq:
            pr = [_fq(x / den[:, None], m[9], m[10], m[11]) for x in e]
            A = _fold([x.to(torch.float64) @ v for x, (_, v) in zip(pr, parts)])
            psum = _fold([x.to(torch.float64).sum(-1) for x in pr])
            out[bh] = (A - m[5] * psum[:, None]) * m[4]
        else:
            A = _fold([x.to(torch.float64) @ v for x, (_, v) in zip(e, parts)])
            out[bh] = (A / den[:, None] - m[5]) * m[4]
    return out


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("G", [1, 6, 8])
@pytest.mark.parametrize("ncl", CLUSTERS)
def test_kv4_attention_model_matches_plain(ncl, G, policy):
    L, B, Hkv, S, hd, cs, layer = 2, 2, 2, 128, 64, 8, 1
    S2, BH = S // 2, B * Hkv
    strict = policy != "relaxed"
    rng = np.random.default_rng(1000 + 100 * ncl + 10 * G + len(policy))
    meta = _meta(META4, policy)
    q8 = torch.from_numpy(rng.integers(-128, 128, (BH, G, hd)).astype(np.int8))
    kp = torch.from_numpy(rng.integers(-128, 128, (L, BH, hd, S2)).astype(np.int8))
    vp = torch.from_numpy(rng.integers(-128, 128, (L, BH, hd, S2)).astype(np.int8))
    kcs = qops.kv_colsums_packed(kp)
    sk = torch.from_numpy(rng.integers(-128, -112, (L, BH, cs, hd)).astype(np.int8))
    sv = torch.from_numpy(rng.integers(-128, -112, (L, BH, cs, hd)).astype(np.int8))
    kn = torch.from_numpy(rng.integers(-128, -112, (BH, hd)).astype(np.int8))
    vn = torch.from_numpy(rng.integers(-128, -112, (BH, hd)).astype(np.int8))
    # chunk starts on both sides of S/2 (the high plane past it), and 0
    for p0, p1, mst in ((3, 0, 0), (17, S2 - 1, 5), (S2 + 5, S - cs, cs), (S2, 41, 5)):
        pos = torch.tensor([p0, p1], dtype=torch.int32)
        args = (q8, kp, vp, kcs, sk, sv, kn, vn, meta, pos, mst, layer)
        ref = KV.kv4_decode_attention_plain(*args, qk_fq_on=strict, pv_fq_on=strict)
        got = _kv4_model(*args, strict, strict, ncl)
        assert torch.isfinite(ref).all()
        assert torch.equal(got, ref), (p0, p1, mst, (got - ref).abs().max())


# ---- the cluster-size choice -------------------------------------------------

CHOICE_SHAPES = [(B, Hkv, S) for B in (1, 2, 8, 32, 64, 128, 512) for Hkv in (1, 4, 32)
                 for S in (16, 64, 1024, 4096, 16384)]


@pytest.mark.parametrize("kernel", ["decode_attention", "kv4"])
def test_cluster_size_choice(kernel):
    """A power of two within the cluster limit, from shapes only; within
    shared memory whenever a size within the limit fits; 1 where B·Hkv fills
    the card and one block a sequence fits; at most two blocks an SM and
    MIN_ROWS positions a block unless shared memory asks for more."""
    for sms in (132, 114, 66):
        for G, hd in ((8, 64), (1, 64), (16, 128)):
            for B, Hkv, S in CHOICE_SHAPES:
                if kernel == "kv4":
                    units = S // 2

                    def smem(n):
                        return KV.kv4_attn_smem(G, S // 2, 32, hd, n)
                    ncl = KV.kv4_cluster_size(B, Hkv, S // 2, 32, sms, G, hd)
                else:
                    units = S

                    def smem(n):
                        return DA.decode_attn_smem(G, S, hd, n)
                    ncl = DA.cluster_size(B, Hkv, S, sms, G, hd)
                assert ncl in CLUSTERS and ncl <= DA.MAX_CLUSTER, (B, Hkv, S, ncl)
                fits = [n for n in CLUSTERS if n <= DA.MAX_CLUSTER and smem(n) <= DA.SMEM_LIMIT]
                if fits:
                    assert smem(ncl) <= DA.SMEM_LIMIT, (B, Hkv, S, ncl)
                if B * Hkv >= sms and smem(1) <= DA.SMEM_LIMIT:
                    assert ncl == 1, (B, Hkv, S, sms)
                if ncl > 1 and smem(ncl // 2) <= DA.SMEM_LIMIT:
                    assert B * Hkv * ncl <= 2 * sms and units >= DA.MIN_ROWS * ncl


def test_cluster_size_fills_small_batches():
    """The chip_smoke shapes: TinyLlama (Hkv 4, S 1024) and StableLM (Hkv 32)
    on 132 SMs."""
    assert [DA.cluster_size(B, 4, 1024, 132, 8, 64) for B in (1, 32, 128)] == [8, 2, 1]
    assert [KV.kv4_cluster_size(B, 4, 512, 32, 132, 8, 64) for B in (1, 32, 128)] == [8, 2, 1]
    assert DA.cluster_size(1, 32, 1024, 132, 1, 64) == 8
