// Staged decode attention over the nibble-packed int4 KV cache.
//
// Replaces mobilequant_tpu/ops/pallas_kv4.py kv4_decode_attention
// (_kv4_attn_kernel). One launch per layer. The packed cache is hd-major,
// (L, B·Hkv, hd, S/2): byte (d, c) holds position c in its low nibble and
// c + S/2 in its high nibble, raw 4-bit values. Four score parts share one
// softmax: cache lo (c < pos), cache hi (c + S/2 < pos), the chunk's staged
// rows (j < m_staged, shifted int8) and the step's own row.
//
// Bound: device-memory bytes (the valid packed K and V columns, their K
// column sums, the staged rows); at decode sizes far less than the time the
// dependent steps of one (sequence, kv head) take, so the design spreads each
// over more SMs. The valid packed columns of one (sequence, kv head) are
// split, in words of four columns, into ncl contiguous stripes, one per block
// of a thread-block cluster of ncl blocks (the wrapper picks ncl from the
// shapes: up to 8 where B·Hkv leaves SMs idle, 1 where it fills the card);
// the last block of the cluster also takes the staged columns and the self
// row. Each block reads its sequence's position on the device (nothing is
// read on the host); a block whose stripe is empty still joins every cluster
// barrier.
//   * scores: a thread per (word, query head), the head fixed by the thread
//     (its q row in registers): four hd-rows of the word's bytes (one 4-byte
//     load each) are transposed into dp4a operands, masked into the low
//     (w & 0x0F0F0F0F) and high ((w >> 4) & 0x0F0F0F0F) nibble planes, so the
//     integer dots are exact; the staged rows a thread per (row, query head)
//     with 16-byte loads; the self row a warp per query head (fp64 sum); the
//     JAX kernel's fp32 epilogue in its order, into fp64 slots of shared
//     memory (which later hold e or P);
//   * softmax in two phases, no online rescaling: the block maxima meet over
//     distributed shared memory (DSMEM) into the global max, every block
//     takes expf(s − m) against it (the plain version's exps) and sums its
//     denominator partial in fp64; strict (the pv_bmm input fake-quant), the
//     partials meet first (rank order, rounded once), P = fq16(e / den) and
//     fp64 partial ΣP;
//   * P·V in the raw V domain: lanes along hd (rows lane, lane + 32, ...),
//     warps along the words; each thread keeps fp64 partials of its (query
//     head, hd) outputs: nibbles become exact doubles by one fp64 add, the
//     products e·v (p·v) are exact in fp64 (fma). A warp's first word loads
//     when the kernel starts. The partials meet over the warps in shared
//     memory, then over the cluster in DSMEM (with the denominator partials
//     in the relaxed policy), rounded once.
// Only valid columns are read: a masked column's exp is exactly 0, so it is
// skipped (the host asks for every column in the strict policy when fq16(0)
// would not be 0). Every non-integer sum is an fp64 sum of terms exact in
// fp64, rounded once to fp32: its order moves it by far less than an fp32
// step, so the plain PyTorch version (ops/kv4_attention.py), which sums in
// another order, gives the same fp32 values.
// tests/test_torch_decode_attention_numerics.py models the split over the
// blocks and the global-max softmax on the CPU; the order inside a block
// (strided thread partials, lane shuffles, warps in index order) rests on
// the fp64 argument and on the checks on the card (chip_smoke.py,
// scripts/check_decode_attention.py). Build with --fmad=false (see
// mqt_common.cuh).
#include "decode_cluster.cuh"

namespace {

namespace dc = mqt::dc;
using mqt::fq16;

// Host-computed fp32 constants, in the plain version's order (kv4_attention._consts).
struct Kv4Consts {
  float oqs, ok, oks, inv, sqk, cf, c_lo, c_st, ksh;
  float qs, qo, qm;     // qk_bmm output fake-quant (scale, offset, clip max)
  float ps, po, pm;     // pv_bmm input fake-quant
  float sv, ov, neg_inf;
};

// grid (ncl, BH), clusters of ncl blocks along x. cst: staged columns (mst
// valid); WW: packed words a stripe may hold. A query head's fp64 slots
// (LDC, even): [0, 4 WW) the stripe's low plane, [4 WW, 8 WW) its high plane,
// then cst staged columns and the self column.
template <int G, int HD>
__global__ void __launch_bounds__(dc::THREADS) kv4_attn_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const float* __restrict__ kcs,
    const int8_t* __restrict__ sk, const int8_t* __restrict__ sv,
    const int8_t* __restrict__ kn, const int8_t* __restrict__ vn,
    const int* __restrict__ pos, float* __restrict__ out, Kv4Consts k, int BH, int hkv,
    int S2, int cst, int mst, int layer, int qk_fq, int pv_fq, int skip, int WW, int LDC) {
  using L = dc::PvLayout<G, HD>;
  constexpr int HW = HD / 4;                    // int words of a q row
  constexpr int DPT = L::DPT, GPT = L::GPT, NCW = L::NCW;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& st = *reinterpret_cast<dc::Stats<G, HD>*>(smem);
  double* pd = reinterpret_cast<double*>(smem + dc::stats_bytes<G, HD>());  // [G][LDC]
  double* red = pd;                             // [WARPS][GPT][HD], after P·V
  const int WC = 4 * WW;                        // columns of a plane in the slots
  const int SELF = 2 * WC + cst;

  dc::Cluster cluster = cooperative_groups::this_cluster();
  const int ncl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const bool last = rank == ncl - 1;            // takes the staged and self columns
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[bh / hkv];
  const int nlo = skip ? min(max(p, 0), S2) : S2;
  const int nhi = skip ? min(max(p - S2, 0), S2) : S2;
  const int ncs = last ? (skip ? mst : cst) : 0;
  const int nw = (nlo + 3) >> 2;                // words holding a read column
  const int per = (nw + ncl - 1) / ncl;
  const int w0 = min(rank * per, nw), nwr = min(nw - w0, per);
  const size_t slab = (size_t)layer * BH + bh;
  const int8_t* kbase = kp + slab * HD * S2 + 4 * w0;
  const int8_t* vbase = vp + slab * HD * S2 + 4 * w0;
  const float* kcl = kcs + slab * 2 * S2 + 4 * w0;

  // P·V: warp (gg, cw) takes words cw, cw + NCW, ... of the stripe for heads
  // [gg·GPT, (gg + 1)·GPT); its first word's V bytes load now
  const int cw = warp % NCW, gg = warp / NCW;
  unsigned vpre[DPT];
#pragma unroll
  for (int jd = 0; jd < DPT; ++jd)
    vpre[jd] = cw < nwr ? (unsigned)mqt::ld_i32(vbase + (size_t)(lane + 32 * jd) * S2 + 4 * cw)
                        : 0u;

  // ---- scores: a thread per (slot, query head) (dc::ScoreMap) -------------------
  using SM = dc::ScoreMap<G>;
  const int g = SM::head();
  int qw[HW];
  const float qsf = (float)dc::load_q_row<HD>(q8 + ((size_t)bh * G + g) * HD, qw);
  float mloc = -3.4028235e38f;

  // cache columns, both nibble planes: a thread per (word, query head)
  for (int it = SM::start(); it < SM::end(nwr); it += SM::STEP) {
    const int jj = SM::slot(it);
    const int c0 = 4 * (w0 + jj);
    const bool do_hi = c0 < nhi;
    int alo[4] = {0, 0, 0, 0}, ahi[4] = {0, 0, 0, 0};
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      int r[4], cw4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = mqt::ld_i32(kbase + (size_t)(d + i) * S2 + 4 * jj);
      mqt::transpose4x4(r, cw4);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        alo[x] = __dp4a(qw[d >> 2], cw4[x] & (int)mqt::NIB, alo[x]);
        ahi[x] = __dp4a(qw[d >> 2], (int)(((unsigned)cw4[x] >> 4) & mqt::NIB), ahi[x]);
      }
    }
    const float4 kl = __ldg(reinterpret_cast<const float4*>(kcl + 4 * jj));
    const float4 kh = __ldg(reinterpret_cast<const float4*>(kcl + S2 + 4 * jj));
    const float ksl[4] = {kl.x, kl.y, kl.z, kl.w}, ksh[4] = {kh.x, kh.y, kh.z, kh.w};
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      if (plane && !do_hi) break;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float t = (float)(plane ? ahi[x] : alo[x]) - k.ok * qsf;
        t = t - k.oqs * ((plane ? ksh[x] : ksl[x]) + k.ksh);
        t = t + k.c_lo;
        float sc = t * k.cf;
        if (qk_fq) sc = fq16(sc, k.qs, k.qo, k.qm) * k.inv;
        sc = sc + ((plane * S2 + c0 + x < p) ? 0.f : k.neg_inf);
        pd[g * LDC + plane * WC + 4 * jj + x] = sc;
        mloc = fmaxf(mloc, sc);
      }
    }
  }

  // staged columns (the last block): a thread per (row, query head)
  for (int it = SM::start(); it < SM::end(ncs); it += SM::STEP) {
    const int jj = SM::slot(it);
    int ks;
    const int acc = dc::row_dot<HD>(sk + (slab * cst + jj) * HD, qw, ks);
    float t = (float)acc - k.oks * qsf;
    t = t - k.oqs * (float)ks;
    t = t + k.c_st;
    float sc = t * k.cf;
    if (qk_fq) sc = fq16(sc, k.qs, k.qo, k.qm) * k.inv;
    sc = sc + (jj < mst ? 0.f : k.neg_inf);
    pd[g * LDC + 2 * WC + jj] = sc;
    mloc = fmaxf(mloc, sc);
  }

  // self score (the last block): a warp per query head, fp64 sum
  if (last) {
    for (int gs = warp; gs < G; gs += dc::WARPS) {
      double s = 0.0;
      for (int d = lane; d < HD; d += 32) {
        const float a = (float)q8[((size_t)bh * G + gs) * HD + d] - k.oqs;
        const float c = (float)kn[(size_t)bh * HD + d] - k.oks;
        s += (double)(a * c);
      }
      const float sf = mqt::warp_sum(s);
      if (lane == 0) {
        float ss = sf * k.sqk;
        if (qk_fq) ss = fq16(ss, k.qs, k.qo, k.qm);
        pd[gs * LDC + SELF] = ss * k.inv;
      }
    }
  }

  // every fp64 slot this thread owns: its cache and staged columns, and the
  // self column of head tid (threads < G of the last block)
  auto each_slot = [&](auto&& f) {
    for (int it = SM::start(); it < SM::end(nwr); it += SM::STEP) {
      const int jj = SM::slot(it);
      double* s = pd + g * LDC + 4 * jj;
#pragma unroll
      for (int x = 0; x < 4; ++x) f(s + x);
      if (4 * (w0 + jj) < nhi)
#pragma unroll
        for (int x = 0; x < 4; ++x) f(s + WC + x);
    }
    for (int it = SM::start(); it < SM::end(ncs); it += SM::STEP)
      f(pd + g * LDC + 2 * WC + SM::slot(it));
    if (last && tid < G) f(pd + tid * LDC + SELF);
  };

  // ---- the global max, the exps and the denominator partials ----------------
  {
    const float bm = dc::block_max<G>(mloc, st.wmx);   // (the self scores are in after it)
    if (tid < G) st.mx[tid] = last ? fmaxf(bm, (float)pd[tid * LDC + SELF]) : bm;
  }
  cluster.sync();
  const float mg = dc::cluster_max(cluster, &st.mx[g], ncl);
  double dl = 0.0;
  each_slot([&](double* s) {
    const float e = expf((float)*s - mg);
    *s = e;
    dl += e;
  });
  {
    const double bd = dc::block_sum<G>(dl, st.wsum);
    if (tid < G) st.den[tid] = bd;
  }
  if (pv_fq) {
    // strict: P = fq16(e / den), partial ΣP
    cluster.sync();
    const float denf = (float)dc::cluster_sum(cluster, &st.den[g], ncl);
    double pl = 0.0;
    each_slot([&](double* s) {
      const float q = fq16((float)*s / denf, k.ps, k.po, k.pm);
      *s = q;
      pl += q;
    });
    const double bp = dc::block_sum<G>(pl, st.wsum);   // (P is complete after it)
    if (tid < G) st.ps[tid] = bp;
  }

  // ---- P·V in the raw V domain: fp64 partials of (query head, hd = lane + 32 jd)
  double acc[GPT][DPT];
#pragma unroll
  for (int gi = 0; gi < GPT; ++gi)
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[gi][jd] = 0.0;
  auto word = [&](int jj, const unsigned (&vw)[DPT]) {
    const bool do_hi = 4 * (w0 + jj) < nhi;
#pragma unroll
    for (int x2 = 0; x2 < 4; x2 += 2) {
      double vl[DPT][2], vh[DPT][2];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd)
#pragma unroll
        for (int xx = 0; xx < 2; ++xx) {
          vl[jd][xx] = dc::u_to_f64((vw[jd] >> (8 * (x2 + xx))) & 0xFu);
          vh[jd][xx] = dc::u_to_f64((vw[jd] >> (8 * (x2 + xx) + 4)) & 0xFu);
        }
#pragma unroll
      for (int gi = 0; gi < GPT; ++gi) {
        const double* s = pd + (gg * GPT + gi) * LDC + 4 * jj + x2;
        const double2 pl = *reinterpret_cast<const double2*>(s);
#pragma unroll
        for (int jd = 0; jd < DPT; ++jd) {
          acc[gi][jd] = fma(pl.x, vl[jd][0], acc[gi][jd]);
          acc[gi][jd] = fma(pl.y, vl[jd][1], acc[gi][jd]);
        }
        if (do_hi) {
          const double2 ph = *reinterpret_cast<const double2*>(s + WC);
#pragma unroll
          for (int jd = 0; jd < DPT; ++jd) {
            acc[gi][jd] = fma(ph.x, vh[jd][0], acc[gi][jd]);
            acc[gi][jd] = fma(ph.y, vh[jd][1], acc[gi][jd]);
          }
        }
      }
    }
  };
  if (cw < nwr) word(cw, vpre);
  for (int jj = cw + NCW; jj < nwr; jj += NCW) {
    unsigned vw[DPT];
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd)
      vw[jd] = (unsigned)mqt::ld_i32(vbase + (size_t)(lane + 32 * jd) * S2 + 4 * jj);
    word(jj, vw);
  }
  for (int jj = cw; jj < ncs; jj += NCW) {
    const int8_t* row = sv + (slab * cst + jj) * HD;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const double v = dc::u_to_f64((unsigned)row[lane + 32 * jd] & 0xFu);
#pragma unroll
      for (int gi = 0; gi < GPT; ++gi)
        acc[gi][jd] = fma(pd[(gg * GPT + gi) * LDC + 2 * WC + jj], v, acc[gi][jd]);
    }
  }
  if (last && cw == 0) {
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) {
      const double v = dc::u_to_f64((unsigned)vn[(size_t)bh * HD + lane + 32 * jd] & 0xFu);
#pragma unroll
      for (int gi = 0; gi < GPT; ++gi)
        acc[gi][jd] = fma(pd[(gg * GPT + gi) * LDC + SELF], v, acc[gi][jd]);
    }
  }
  dc::fold_warps<G, HD, 1, 32>(acc, red, st.pv);
  cluster.sync();

  // ---- the outputs, spread over the cluster ------------------------------------
  //   relaxed (A / den − o_v)·s_v;  strict (A − o_v·ΣP)·s_v
  for (int o = rank + ncl * tid; o < G * HD; o += ncl * dc::THREADS) {
    const float A = (float)dc::cluster_sum(cluster, &st.pv[o], ncl);
    float r;
    if (pv_fq) {
      r = (A - k.ov * (float)dc::cluster_sum(cluster, &st.ps[o / HD], ncl)) * k.sv;
    } else {
      r = (A / (float)dc::cluster_sum(cluster, &st.den[o / HD], ncl) - k.ov) * k.sv;
    }
    out[(size_t)bh * G * HD + o] = r;
  }
  cluster.sync();                               // the others may still read this block
}

template <int G, int HD>
int launch(const void* q8, const void* kp, const void* vp, const void* kcs, const void* sk,
           const void* sv, const void* kn, const void* vn, const void* pos, void* out,
           const Kv4Consts& k, int BH, int hkv, int S2, int cst, int mst, int layer, int qk_fq,
           int pv_fq, int skip, int ncl, cudaStream_t stream) {
  static size_t opted = 0;
  const int WW = (S2 / 4 + ncl - 1) / ncl;
  const int LDC = (8 * WW + cst + 1 + 1) & ~1;
  const size_t smem = dc::stats_bytes<G, HD>()
                      + 8 * (size_t)max(G * LDC, dc::WARPS * dc::PvLayout<G, HD>::GPT * HD);
  return dc::launch_cluster(
      kv4_attn_kernel<G, HD>, opted, ncl, BH, smem, stream, (const int8_t*)q8,
      (const int8_t*)kp, (const int8_t*)vp, (const float*)kcs, (const int8_t*)sk,
      (const int8_t*)sv, (const int8_t*)kn, (const int8_t*)vn, (const int*)pos, (float*)out, k,
      BH, hkv, S2, cst, mst, layer, qk_fq, pv_fq, skip, WW, LDC);
}

}  // namespace

// q8 (BH, G, hd); kp / vp (L, BH, hd, S2); kcs (L, BH, 2 S2) fp32; sk / sv
// (L, BH, cs, hd); kn / vn (BH, hd); pos (B,) with B = BH / hkv; out (BH, G, hd)
// fp32; consts: 18 host floats (Kv4Consts). hd 64 or 128, S2 % 4 == 0,
// G in {1, 2, 4, 6, 8, 16}; ncl blocks (one cluster) a (sequence, kv head), a
// power of two <= 8.
MQT_EXPORT int mqt_kv4_decode_attention(const void* q8, const void* kp, const void* vp,
                                        const void* kcs, const void* sk, const void* sv,
                                        const void* kn, const void* vn, const void* pos,
                                        void* out, const float* consts, int BH, int hkv, int G,
                                        int hd, int S2, int cs, int mst, int layer, int qk_fq,
                                        int pv_fq, int skip, int ncl, void* stream) {
  if ((hd != 64 && hd != 128) || S2 % 4 || hkv < 1 || BH % hkv || mst < 0 || mst > cs
      || ncl < 1 || ncl > dc::MAX_CLUSTER || (ncl & (ncl - 1)))
    return (int)cudaErrorInvalidValue;
  Kv4Consts k;
  float* kf = reinterpret_cast<float*>(&k);
  for (int i = 0; i < (int)(sizeof(Kv4Consts) / sizeof(float)); ++i) kf[i] = consts[i];
  cudaStream_t st = (cudaStream_t)stream;
#define MQT_KV4_CASE(g)                                                                     \
  case g:                                                                                   \
    return hd == 64 ? launch<g, 64>(q8, kp, vp, kcs, sk, sv, kn, vn, pos, out, k, BH, hkv, \
                                    S2, cs, mst, layer, qk_fq, pv_fq, skip, ncl, st)       \
                    : launch<g, 128>(q8, kp, vp, kcs, sk, sv, kn, vn, pos, out, k, BH, hkv, \
                                     S2, cs, mst, layer, qk_fq, pv_fq, skip, ncl, st);
  switch (G) {
    MQT_KV4_CASE(1)
    MQT_KV4_CASE(2)
    MQT_KV4_CASE(4)
    MQT_KV4_CASE(6)
    MQT_KV4_CASE(8)
    MQT_KV4_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MQT_KV4_CASE
}
