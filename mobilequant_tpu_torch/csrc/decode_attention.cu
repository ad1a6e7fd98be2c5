// int8-KV decode attention (T = 1) over one layer of the cache.
//
// Replaces mobilequant_tpu/ops/pallas_attention.py decode_attention
// (_decode_attn_kernel): per (sequence, kv head), the G query heads against
// the cache rows < valid_len (the step's own row already written), with the
// 16-bit score and probability fake-quants when the meta enables them.
//
// Bound: device-memory bytes (the valid K and V rows); at decode sizes far
// less than the time the dependent steps of one (sequence, kv head) take, so
// the design spreads each over more SMs. The valid rows of one (sequence, kv
// head) are split into ncl contiguous stripes, one per block of a
// thread-block cluster of ncl blocks (the wrapper picks ncl from the shapes:
// up to 8 where B·Hkv leaves SMs idle, 1 where it fills the card). Each
// block reads its sequence's valid length on the device (nothing is read on
// the host, so a step stays one asynchronous launch); a block whose stripe is
// empty still joins every cluster barrier.
//   * scores: a thread per (row, query head), the head fixed by the thread
//     (its q row in registers; dc::ScoreMap: lane l takes head l % G, so at
//     G = 6 lanes 30 and 31 idle), the row's K bytes in 16-byte loads, dp4a dots
//     (exact) and the JAX kernel's fp32 epilogue in its order, into fp64
//     slots of shared memory (which later hold P);
//   * softmax in two phases, no online rescaling: the block maxima meet over
//     distributed shared memory (DSMEM) into the global max, every block
//     takes expf(s − m) against it (the plain version's exps), the fp64
//     partial denominators meet in DSMEM (summed in rank order, rounded once
//     to fp32); P = e / den [then fq16] and fp64 partial ΣP;
//   * P·V: lanes along hd (two, four or eight values a lane, one 2-, 4- or
//     8-byte load a row), warps along row pairs; each thread keeps fp64 partials of its
//     (query head, hd) outputs: V bytes become exact doubles by one fp64 add,
//     the products p·v are exact in fp64 (fma). The first two row pairs of a
//     warp are loaded when the kernel starts. The partials meet over the
//     warps in shared memory, then over the cluster in DSMEM, rounded once.
// Rows >= valid_len are not read: their exp is exactly 0 (the host asks for
// every row in the strict policy when fq16(0) would not be 0). Every
// non-integer sum is an fp64 sum of terms exact in fp64, rounded once to
// fp32: its order moves it by far less than an fp32 step, so the plain
// PyTorch version (ops/decode_attention.py), which sums in another order,
// gives the same fp32 values. tests/test_torch_decode_attention_numerics.py
// models the split over the blocks and the global-max softmax on the CPU;
// the order inside a block (strided thread partials, lane shuffles, warps in
// index order) rests on the fp64 argument and on the checks on the card
// (chip_smoke.py, scripts/check_decode_attention.py). Build with
// --fmad=false (see mqt_common.cuh).
#include <type_traits>

#include "decode_cluster.cuh"

namespace {

namespace dc = mqt::dc;
using mqt::fq16;

// Host-computed fp32 constants, in the plain version's order (decode_attention._consts).
struct DaConsts {
  float oq, ok, ov, sqk, c_hd, inv;
  float qs, qo, qm;     // qk_bmm output fake-quant (qm 0: off)
  float ps, po, pm;     // pv_bmm input fake-quant (pm 0: off)
  float sv, neg_inf;
};

// DPT bytes of a row at hd = DPT·lane .. (a zero value is V = 0 below)
template <int DPT>
struct Lane {
  using T = std::conditional_t<DPT == 8, uint2, unsigned>;
};
template <int DPT>
__device__ __forceinline__ typename Lane<DPT>::T ld_lane(const int8_t* row, int lane) {
  if constexpr (DPT == 2) return __ldg(reinterpret_cast<const unsigned short*>(row) + lane);
  else if constexpr (DPT == 4) return __ldg(reinterpret_cast<const unsigned*>(row) + lane);
  else return __ldg(reinterpret_cast<const uint2*>(row) + lane);
}
template <int DPT>
__device__ __forceinline__ typename Lane<DPT>::T lane_zero() {
  if constexpr (DPT == 8) return make_uint2(0u, 0u);
  else return 0u;
}
// byte j of a lane's DPT bytes
template <int DPT>
__device__ __forceinline__ unsigned lane_byte(typename Lane<DPT>::T v, int j) {
  if constexpr (DPT == 8) return (j < 4 ? v.x : v.y) >> (8 * (j & 3));
  else return v >> (8 * j);
}

// grid (ncl, B·Hkv), clusters of ncl blocks along x; W: fp64 slots of a
// query head (the rows a stripe may hold, even)
template <int G, int HD>
__global__ void __launch_bounds__(dc::THREADS) decode_attn_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
    const int8_t* __restrict__ v8, const int* __restrict__ valid, float* __restrict__ out,
    DaConsts k, int hkv, int S, int W, int skip) {
  using L = dc::PvLayout<G, HD>;
  constexpr int HW = HD / 4;                    // int words of a row
  constexpr int DPT = L::DPT, GPT = L::GPT, NCW = L::NCW;
  extern __shared__ __align__(16) unsigned char smem[];
  auto& st = *reinterpret_cast<dc::Stats<G, HD>*>(smem);
  double* pd = reinterpret_cast<double*>(smem + dc::stats_bytes<G, HD>());  // [G][W]
  double* red = pd;                             // [WARPS][GPT][HD], after P·V

  dc::Cluster cluster = cooperative_groups::this_cluster();
  const int ncl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vlen = valid[bh / hkv];
  const int n = skip ? min(max(vlen, 0), S) : S;
  const int per = (n + ncl - 1) / ncl;          // rows of a stripe
  const int r0 = min(rank * per, n), nr = min(n - r0, per);
  const int8_t* kb = k8 + ((size_t)bh * S + r0) * HD;
  const int8_t* vb = v8 + ((size_t)bh * S + r0) * HD;

  // P·V: warp (gg, cw) takes row pairs cw, cw + NCW, ... for heads
  // [gg·GPT, (gg + 1)·GPT); its first two pairs' V bytes load now (a zero
  // word is V = 0 below)
  const int cw = warp % NCW, gg = warp / NCW;
  using VL = typename Lane<DPT>::T;
  VL vpre[2][2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * (cw + u * NCW) + h;
      vpre[u][h] = r < nr ? ld_lane<DPT>(vb + (size_t)r * HD, lane) : lane_zero<DPT>();
    }

  // ---- scores: a thread per (row, query head) (dc::ScoreMap) -----------------
  using SM = dc::ScoreMap<G>;
  const int g = SM::head();
  int qw[HW];
  const float qsf = (float)dc::load_q_row<HD>(q8 + ((size_t)bh * G + g) * HD, qw);
  float mloc = -3.4028235e38f;
  for (int it = SM::start(); it < SM::end(nr); it += SM::STEP) {
    const int r = SM::slot(it);
    int ks;
    const int acc = dc::row_dot<HD>(kb + (size_t)r * HD, qw, ks);
    float t = (float)acc - k.ok * qsf;
    t = t - k.oq * (float)ks;
    t = t + k.c_hd;
    float sc = t * k.sqk;
    if (k.qm > 0.5f) sc = fq16(sc, k.qs, k.qo, k.qm);
    sc = sc * k.inv;
    sc = sc + (r0 + r < vlen ? 0.f : k.neg_inf);
    pd[g * W + r] = sc;
    mloc = fmaxf(mloc, sc);
  }

  // ---- the global max, then exps and the denominator ------------------------
  {
    const float bm = dc::block_max<G>(mloc, st.wmx);
    if (tid < G) st.mx[tid] = bm;
  }
  cluster.sync();
  const float mg = dc::cluster_max(cluster, &st.mx[g], ncl);
  double dl = 0.0;
  for (int it = SM::start(); it < SM::end(nr); it += SM::STEP) {
    const int r = SM::slot(it);
    double* s = pd + g * W + r;
    const float e = expf((float)*s - mg);
    *s = e;
    dl += e;
  }
  {
    const double bd = dc::block_sum<G>(dl, st.wsum);
    if (tid < G) st.den[tid] = bd;
  }
  cluster.sync();
  const float denf = (float)dc::cluster_sum(cluster, &st.den[g], ncl);

  // ---- P = e / den [fq16], partial ΣP ---------------------------------------
  double pl = 0.0;
  for (int it = SM::start(); it < SM::end(nr); it += SM::STEP) {
    const int r = SM::slot(it);
    double* s = pd + g * W + r;
    float p = (float)*s / denf;
    if (k.pm > 0.5f) p = fq16(p, k.ps, k.po, k.pm);
    *s = p;
    pl += p;
  }
  if ((nr & 1) && tid < G) pd[tid * W + nr] = 0.0;    // the odd stripe's pair partner
  {
    const double bp = dc::block_sum<G>(pl, st.wsum);  // (P is complete after it)
    if (tid < G) st.ps[tid] = bp;
  }

  // ---- P·V: fp64 partials of (query head, hd = DPT·lane + j) -----------------
  double acc[GPT][DPT];
#pragma unroll
  for (int gi = 0; gi < GPT; ++gi)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[gi][j] = 0.0;
  const int npair = (nr + 1) >> 1;
  auto pair = [&](int pi, VL va, VL vb2) {
    double xa[DPT], xb[DPT];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      xa[j] = dc::s8_to_f64(lane_byte<DPT>(va, j));
      xb[j] = dc::s8_to_f64(lane_byte<DPT>(vb2, j));
    }
#pragma unroll
    for (int gi = 0; gi < GPT; ++gi) {
      const double2 pp = *reinterpret_cast<const double2*>(pd + (gg * GPT + gi) * W + 2 * pi);
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        acc[gi][j] = fma(pp.x, xa[j], acc[gi][j]);
        acc[gi][j] = fma(pp.y, xb[j], acc[gi][j]);
      }
    }
  };
  if (cw < npair) pair(cw, vpre[0][0], vpre[0][1]);
  if (cw + NCW < npair) pair(cw + NCW, vpre[1][0], vpre[1][1]);
  for (int pi = cw + 2 * NCW; pi < npair; pi += NCW) {
    const VL va = ld_lane<DPT>(vb + (size_t)(2 * pi) * HD, lane);
    const VL vb2 = 2 * pi + 1 < nr ? ld_lane<DPT>(vb + (size_t)(2 * pi + 1) * HD, lane)
                                   : lane_zero<DPT>();
    pair(pi, va, vb2);
  }
  dc::fold_warps<G, HD, DPT, 1>(acc, red, st.pv);
  cluster.sync();

  // ---- the outputs, spread over the cluster: (P·V − o'_v·ΣP)·s_v -------------
  for (int o = rank + ncl * tid; o < G * HD; o += ncl * dc::THREADS) {
    const float pv = (float)dc::cluster_sum(cluster, &st.pv[o], ncl);
    const float ps = (float)dc::cluster_sum(cluster, &st.ps[o / HD], ncl);
    out[(size_t)bh * G * HD + o] = (pv - k.ov * ps) * k.sv;
  }
  cluster.sync();                               // the others may still read this block
}

template <int G, int HD>
int launch(const void* q8, const void* k8, const void* v8, const void* valid, void* out,
           const DaConsts& k, int BH, int hkv, int S, int skip, int ncl, cudaStream_t st) {
  static size_t opted = 0;
  const int W = ((S + ncl - 1) / ncl + 1) & ~1;
  const size_t smem = dc::stats_bytes<G, HD>()
                      + 8 * (size_t)max(G * W, dc::WARPS * dc::PvLayout<G, HD>::GPT * HD);
  return dc::launch_cluster(decode_attn_kernel<G, HD>, opted, ncl, BH, smem, st,
                            (const int8_t*)q8, (const int8_t*)k8, (const int8_t*)v8,
                            (const int*)valid, (float*)out, k, hkv, S, W, skip);
}

}  // namespace

// q8 (B, hkv, G, hd); k8 / v8 (B, hkv, S, hd); valid (B,); out (B, hkv, G, hd)
// fp32; consts: 14 host floats (DaConsts). hd 64, 128 or 256, G in {1, 2, 4,
// 6, 8, 16}; ncl blocks (one cluster) a (sequence, kv head), a power of two <= 8.
MQT_EXPORT int mqt_decode_attention(const void* q8, const void* k8, const void* v8,
                                    const void* valid, void* out, const float* consts, int B,
                                    int hkv, int G, int hd, int S, int skip, int ncl,
                                    void* stream) {
  if ((hd != 64 && hd != 128 && hd != 256) || S < 1 || hkv < 1 || ncl < 1 || ncl > dc::MAX_CLUSTER
      || (ncl & (ncl - 1)))
    return (int)cudaErrorInvalidValue;
  DaConsts k;
  float* kf = reinterpret_cast<float*>(&k);
  for (int i = 0; i < (int)(sizeof(DaConsts) / sizeof(float)); ++i) kf[i] = consts[i];
  cudaStream_t st = (cudaStream_t)stream;
  const int BH = B * hkv;
#define MQT_DA_CASE(g)                                                                     \
  case g:                                                                                  \
    return hd == 64    ? launch<g, 64>(q8, k8, v8, valid, out, k, BH, hkv, S, skip, ncl, st) \
           : hd == 128 ? launch<g, 128>(q8, k8, v8, valid, out, k, BH, hkv, S, skip, ncl, st) \
                       : launch<g, 256>(q8, k8, v8, valid, out, k, BH, hkv, S, skip, ncl, st);
  switch (G) {
    MQT_DA_CASE(1)
    MQT_DA_CASE(2)
    MQT_DA_CASE(4)
    MQT_DA_CASE(6)
    MQT_DA_CASE(8)
    MQT_DA_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MQT_DA_CASE
}
