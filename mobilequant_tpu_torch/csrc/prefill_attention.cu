// Causal int8-KV prefill attention:
//   scores = ((q − o'_q)·(k − o'_k))·s_q·s_k -> [fq16] -> ·1/√hd
//            + (col <= pos && col < valid ? 0 : neg_inf)
//   probs  = softmax over the row -> [fq16]
//   out    = (P·v_shifted − o'_v·ΣP)·s_v                      (fp32)
// q (B,Hkv,G,T,hd) int8 and out (B,Hkv,G,T,hd) fp32 are addressed through
// strides, so the caller passes views of its (B,T,H,hd) buffers without a
// copy; k/v are one layer of the cache, (B,Hkv,S,hd) contiguous int8.
//
// Replaces mobilequant_tpu/ops/pallas_prefill_attention.py: prefill_attention
// (_prefill_attn_online_kernel for pv_fq = false, _prefill_attn_kernel for
// pv_fq = true).
//
// Bound: operations (QK as int8 dp4a, exp and P·V in fp32) over the causal
// half of the score matrix; K/V bytes are read once per Q tile. Design: one
// block per (batch, kv head, Q tile of 64 / G positions), all G query heads
// of the kv head in the block (64 rows, two threads per row, each owning
// alternate score columns and half of the head dims), looping over 64-column
// K/V tiles up to the tile's causal bound only. Relaxed policy: one pass with
// an online softmax. Strict policy: the prob fake-quant needs the normalised
// probability, and a (64, S) score row buffer does not fit shared memory at
// long S, so the scores are recomputed in three passes: the exact row max,
// the denominator, then normalised, fake-quantized probabilities into P·V
// (an online denominator, rescaled tile by tile, rounds differently enough
// to move prob fake-quant steps at S = 1024).
#include <math.h>

#include "mqt_common.cuh"

namespace {

constexpr int ROWS = 64;            // G · BQ query rows per block
constexpr int THREADS = 2 * ROWS;   // two threads per row
constexpr int BS = 64;              // K/V columns per tile
constexpr int HD = 64;              // head dim
constexpr int QW = HD / 4;          // int32 words per q / k row
constexpr int KPAD = QW + 1;
constexpr int VHALF = HD / 2 + 4;   // padded half-row of V (bank spread)

struct Meta {
  float sq, oq, sk, ok, sv, ov;     // offsets already shifted by −128
  float qks, qko, qkq;              // qk_bmm output fq (scale, offset, qmax)
  float pvs, pvo, pvq;              // pv_bmm input fq
  float neg_inf;
};

struct Strides {
  long long b, h, g, t;             // elements
};

using mqt::fq16;

__global__ void __launch_bounds__(THREADS)
prefill_attn_kernel(const int8_t* __restrict__ q, Strides qs,
                    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                    const int* __restrict__ positions,
                    const int* __restrict__ valid, float* __restrict__ out,
                    Strides os, Meta mt, int Hkv, int G, int T, int S,
                    int qk_fq, int pv_fq) {
  __shared__ int ks_[BS][KPAD];
  __shared__ int ksum[BS];
  __shared__ float vs[BS][2 * VHALF];
  __shared__ int pos_s[ROWS];

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int BQ = ROWS / G;
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int t0 = blockIdx.y * BQ;
  const int g = r / BQ, tq = r % BQ, t = t0 + tq;
  const bool row_ok = t < T;

  if (tid < BQ) pos_s[tid] = (t0 + tid < T) ? positions[(size_t)b * T + t0 + tid] : -1;
  __syncthreads();
  int pmax = -1;
  for (int i = 0; i < BQ; ++i) pmax = max(pmax, pos_s[i]);
  const int pos = row_ok ? pos_s[tq] : -1;
  const int vb = valid[b];
  const int ncols = max(0, min(min(pmax + 1, vb), S));
  const int ntiles = (ncols + BS - 1) / BS;

  // this row's q (both threads of the pair hold the whole row)
  int qw[QW];
  int qsum_i = 0;
  {
    const int8_t* qp = q + b * qs.b + h * qs.h + g * qs.g + (long long)(row_ok ? t : 0) * qs.t;
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      qw[i] = row_ok ? mqt::ld_i32(qp + 4 * i) : 0;
      qsum_i = __dp4a(qw[i], 0x01010101, qsum_i);
    }
  }
  const float qsum = (float)qsum_i;
  const float inv_sqrt = 1.0f / sqrtf((float)HD);
  const float hdoo = (float)HD * mt.oq * mt.ok;
  const float sqk = mt.sq * mt.sk;
  const int8_t* kb = k + ((size_t)b * Hkv + h) * (size_t)S * HD;
  const int8_t* vbp = v + ((size_t)b * Hkv + h) * (size_t)S * HD;

  float sc[BS / 2];
  float acc[HD / 2];
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) acc[j] = 0.0f;
  float m = -1e30f, l = 0.0f, psum = 0.0f;

  auto load_tile = [&](int s0, bool with_v) {
    // K: 64 rows x 16 words; V: 64 rows x 64 bytes -> fp32
    for (int idx = tid; idx < BS * QW; idx += THREADS) {
      const int s = idx / QW, wd = idx % QW;
      ks_[s][wd] = (s0 + s < S) ? mqt::ld_i32(kb + (size_t)(s0 + s) * HD + 4 * wd) : 0;
    }
    if (with_v) {
      for (int idx = tid; idx < BS * QW; idx += THREADS) {
        const int s = idx / QW, wd = idx % QW;
        const int word = (s0 + s < S) ? mqt::ld_i32(vbp + (size_t)(s0 + s) * HD + 4 * wd) : 0;
        const int d0 = 4 * wd;
        const int base = (d0 < HD / 2) ? d0 : VHALF + d0 - HD / 2;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          vs[s][base + e] = (float)(int8_t)((word >> (8 * e)) & 0xFF);
      }
    }
    __syncthreads();
    if (tid < BS) {
      int s_ = 0;
#pragma unroll
      for (int wd = 0; wd < QW; ++wd) s_ = __dp4a(ks_[tid][wd], 0x01010101, s_);
      ksum[tid] = s_;
    }
    __syncthreads();
  };

  // scores of this thread's columns s = 2 i + half of the tile at s0
  auto scores = [&](int s0) {
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) {
      const int s = 2 * i + half;
      int a = 0;
#pragma unroll
      for (int wd = 0; wd < QW; ++wd) a = __dp4a(qw[wd], ks_[s][wd], a);
      float x = ((float)a - mt.ok * qsum - mt.oq * (float)ksum[s] + hdoo) * sqk;
      if (qk_fq) x = fq16(x, mt.qks, mt.qko, mt.qkq);
      x = x * inv_sqrt;
      const int col = s0 + s;
      x = x + ((col <= pos && col < vb) ? 0.0f : mt.neg_inf);
      sc[i] = x;
    }
  };

  auto pv_accum = [&](const float* p) {
    // p[i] is this thread's column 2 i + half; the partner holds 2 i + 1 − half
    const float* vrow_base = &vs[0][half * VHALF];
#pragma unroll 4
    for (int i = 0; i < BS / 2; ++i) {
      const float mine = p[i];
      const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
      const float p0 = half ? other : mine;    // column 2 i
      const float p1 = half ? mine : other;    // column 2 i + 1
      const float* v0 = vrow_base + (2 * i) * (2 * VHALF);
      const float* v1 = v0 + 2 * VHALF;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = acc[j] + p0 * v0[j];
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = acc[j] + p1 * v1[j];
    }
  };

  if (!pv_fq) {
    for (int ti = 0; ti < ntiles; ++ti) {
      const int s0 = ti * BS;
      load_tile(s0, true);
      scores(s0);
      float tmax = -1e30f;
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) tmax = fmaxf(tmax, sc[i]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m, tmax);
      const float rsc = expf(m - m_new);
      float esum = 0.0f;
#pragma unroll
      for (int i = 0; i < BS / 2; ++i) {
        sc[i] = expf(sc[i] - m_new);
        esum += sc[i];
      }
      esum += __shfl_xor_sync(0xffffffffu, esum, 1);
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) acc[j] = acc[j] * rsc;
      pv_accum(sc);
      l = l * rsc + esum;
      m = m_new;
      __syncthreads();
    }
    const float linv = 1.0f / fmaxf(l, 1e-30f);
    if (row_ok) {
      float* op = out + b * os.b + h * os.h + g * os.g + (long long)t * os.t + half * (HD / 2);
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) op[j] = (acc[j] - mt.ov * l) * linv * mt.sv;
    }
    return;
  }

  // strict: pass 1, the exact row max
  for (int ti = 0; ti < ntiles; ++ti) {
    const int s0 = ti * BS;
    load_tile(s0, false);
    scores(s0);
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) m = fmaxf(m, sc[i]);
    __syncthreads();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  // pass 2: the denominator, sum of exp(s - m) as the JAX kernel forms it
  for (int ti = 0; ti < ntiles; ++ti) {
    const int s0 = ti * BS;
    load_tile(s0, false);
    scores(s0);
    float esum = 0.0f;
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) esum += expf(sc[i] - m);
    l += esum + __shfl_xor_sync(0xffffffffu, esum, 1);
    __syncthreads();
  }
  const float linv = 1.0f / fmaxf(l, 1e-30f);
  // pass 3: normalised, fake-quantized probabilities into P·V
  for (int ti = 0; ti < ntiles; ++ti) {
    const int s0 = ti * BS;
    load_tile(s0, true);
    scores(s0);
    float ps = 0.0f;
#pragma unroll
    for (int i = 0; i < BS / 2; ++i) {
      float p = expf(sc[i] - m) * linv;
      p = fq16(p, mt.pvs, mt.pvo, mt.pvq);
      sc[i] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    psum += ps;
    pv_accum(sc);
    __syncthreads();
  }
  if (row_ok) {
    float* op = out + b * os.b + h * os.h + g * os.g + (long long)t * os.t + half * (HD / 2);
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) op[j] = (acc[j] - mt.ov * psum) * mt.sv;
  }
}

}  // namespace

// meta_host: the JAX engine's 13-float attention meta
// [sq, oq, sk, ok, sv, ov, qk_out s, o, qmax, pv_in s, o, qmax, neg_inf]
// (offsets unshifted, as there). q_strides / o_strides: 4 int64 element
// strides each (b, kv head, group, t) of q and out.
MQT_EXPORT int mqt_prefill_attention(const void* q, const void* q_strides,
                                     const void* k, const void* v,
                                     const void* positions, const void* valid,
                                     void* out, const void* o_strides,
                                     const void* meta_host, int B, int Hkv,
                                     int G, int T, int S, int hd, int qk_fq,
                                     int pv_fq, void* stream) {
  if (hd != HD || G < 1 || ROWS % G != 0) return (int)cudaErrorInvalidValue;
  const float* mh = (const float*)meta_host;
  const long long* qsp = (const long long*)q_strides;
  const long long* osp = (const long long*)o_strides;
  Meta mt;
  mt.sq = mh[0];
  mt.oq = mh[1] - 128.0f;
  mt.sk = mh[2];
  mt.ok = mh[3] - 128.0f;
  mt.sv = mh[4];
  mt.ov = mh[5] - 128.0f;
  mt.qks = mh[6];
  mt.qko = mh[7];
  mt.qkq = mh[8];
  mt.pvs = mh[9];
  mt.pvo = mh[10];
  mt.pvq = mh[11];
  mt.neg_inf = mh[12];
  Strides qs{qsp[0], qsp[1], qsp[2], qsp[3]};
  Strides os{osp[0], osp[1], osp[2], osp[3]};
  const int BQ = ROWS / G;
  dim3 grid(B * Hkv, (T + BQ - 1) / BQ);
  prefill_attn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, qs, (const int8_t*)k, (const int8_t*)v,
      (const int*)positions, (const int*)valid, (float*)out, os, mt, Hkv, G, T,
      S, qk_fq, pv_fq);
  return (int)cudaGetLastError();
}
