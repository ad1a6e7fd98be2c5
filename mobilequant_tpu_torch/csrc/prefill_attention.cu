// Causal int8-KV prefill attention on the tensor cores:
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
// Bound: operations over the causal half of the score matrix (Q·Kᵀ in int8
// and P·V in fp16 on the tensor cores, one exp a score on the SFUs); K/V bytes
// are few (a tile is read once per query tile, from L2 after the first). The
// scalar edition this replaces ran Q·Kᵀ as dp4a and P·V as fp32 FMAs on the
// CUDA cores, two threads a row. Design: one block per (batch, kv head, query
// tile of BQ = ⌊64 / G⌋ positions, the longest rows first), the G query heads
// of the kv head packed into the tile's first G·BQ rows (all 64 where G
// divides 64; 60 at G = 6, the last 4 idle: no q loaded, every column
// masked, nothing written, as the JAX kernel's padded queries at position
// −1): four row warps of 16 rows, twice
// (two column groups: tile 2 i to one, 2 i + 1 to the other, their row
// states merged at the end). K/V tiles of 64 columns stream a pair at a time
// through a four-stage cp.async ring (rows padded to 80 bytes: conflict-free
// ldmatrix and fragment reads), only up to the tile's causal bound; a warp
// skips the tiles past its rows' last position, works on a tile in two
// 32-column halves (fewer live registers), and masks element by element only
// the tiles that reach past a row's position or `valid`.
//   * Q·Kᵀ: int8 mma.sync m16n8k32, K fragments by ldmatrix; the int32 sum is
//     the exact integer dp4a gave. Each key's Σk comes from the same K
//     fragments times a fragment of ones, and the epilogue keeps the scalar
//     kernel's fp32 operation order (the int32 sums, below 2^22, made floats
//     exactly), so every score is the float the scalar kernel made.
//   * P·V: fp16 mma.sync m16n8k16 with fp32 accumulation. V stays int8 in
//     shared memory; a lane pairs the bytes of two key rows with prmt and
//     makes them fp16 exactly (0x6400 | (v + 128), minus 1152). P (in [0, 1])
//     is scaled by 2^15 (exact) and split into two fp16 terms, hi and
//     lo = p − hi, each through its own MMA: 22 bits of p, so against the
//     plain version's fp32 P·V the output differs by about 2^-22 of Σ p·|v|
//     (relative 1e-6 and below), not by whole probability steps.
//   * Relaxed policy: one pass, an online softmax in registers (row max and
//     sum over the quad of lanes that holds a row), p = exp2f((s − m)·log2 e)
//     (within a few ulp of expf; the tolerance is relative 1e-4). Strict
//     policy: the prob fake-quant needs the normalised probability, and an
//     online denominator, rescaled tile by tile, moves prob steps at S = 1024,
//     so three passes recompute the scores on the tensor cores (the exact row
//     max; the denominator, sum of expf(s − m) in fp64 without rescaling;
//     then the fake-quantized probabilities into P·V), the first two over K
//     tiles only. Against the plain version the strict output then moves by
//     the probabilities that a one-ulp difference in the denominator carries
//     across a rounding step.
//   * Head dims: the kernel is a template on HD (64, 128, 256; RB = HD + 16
//     keeps the ldmatrix rows conflict-free). A warp holds its 16 rows' q
//     fragments (HD / 32 k-steps) and P·V accumulators for DCG dims (HD / 8
//     fp32 fragments of 4). Up to HD 128 the two column groups split the K/V
//     tiles as above. At HD 256 the accumulators of 256 dims would not fit
//     beside the q fragments, so the column groups split the head dim
//     instead: both walk every tile and compute the same scores and softmax
//     statistics (Q·Kᵀ twice, the same arithmetic in the same order, so the
//     same values), each runs P·V for its 128 dims and writes them, and no
//     merge is needed. The K/V ring lives in dynamic shared memory (45 /
//     78 / 144 KB at HD 64 / 128 / 256, one block an SM at 256).
#include <math.h>
#include <cuda_fp16.h>

#include "mqt_common.cuh"

namespace {

constexpr int ROWS = 64;             // G · BQ (<= 64) live query rows a block, 16 a row warp
constexpr int THREADS = 256;         // 4 row warps x 2 column groups
constexpr int BS = 64;               // K/V columns a tile
constexpr int NST = 4;               // cp.async ring stages: two pairs of tiles
constexpr float PSCALE = 32768.0f;   // p · 2^15 before the fp16 split (exact)
constexpr unsigned FULL = 0xffffffffu;
constexpr int ONES = 0x01010101;     // an int8 fragment of ones
constexpr float LOG2E = 1.44269504088896341f;

// an int32 of magnitude below 2^22 as the float it equals (exact; the
// integer adder and FADD instead of the quarter-rate I2F conversion)
__device__ __forceinline__ float i2f(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

struct Meta {
  float sq, oq, sk, ok, sv, ov;     // offsets already shifted by −128
  float qks, qko, qkq;              // qk_bmm output fq (scale, offset, qmax)
  float pvs, pvo, pvq;              // pv_bmm input fq
  float neg_inf;
  float inv_sqrt;                   // fp32 of 1 / √hd (the plain version's constant)
};

// The edition of head dim HD: rows of RB bytes in the ring; DSPLIT column
// groups share a row's dims (2 at HD 256) or split the tiles (1); a warp's
// P·V covers DCG dims in NT fragments of 8 columns; KST k32 steps of Q·Kᵀ.
template <int HD>
struct Ed {
  static_assert(HD == 64 || HD == 128 || HD == 256, "head dim 64, 128 or 256");
  static constexpr int RB = HD + 16;
  static constexpr int DSPLIT = HD > 128 ? 2 : 1;
  static constexpr int DCG = HD / DSPLIT;
  static constexpr int NT = DCG / 8;
  static constexpr int KST = HD / 32;
  static constexpr int CPR = HD / 16;          // 16-byte chunks a row
  static constexpr size_t RING = (size_t)NST * BS * RB;
  // K ring, V ring, the column groups' exchange (xch), the rows' positions
  // (-1 for an idle row or one past T)
  static constexpr size_t SMEM = 2 * RING + 2 * 4 * 32 * 2 * sizeof(double) + ROWS * 4;
};

// NT bytes of a V row (8 or 16) as NT / 4 words
template <int NT>
__device__ __forceinline__ void ld_words(const int8_t* p, uint32_t (&w)[NT / 4]) {
  if constexpr (NT == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    w[0] = r.x;
    w[1] = r.y;
  } else {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    w[0] = r.x;
    w[1] = r.y;
    w[2] = r.z;
    w[3] = r.w;
  }
}

struct Strides {
  long long b, h, g, t;             // elements
};

using mqt::fq16;

// (x0, x1) · 2^15 as fp16 pairs hi and lo = x − hi (low half = x0)
__device__ __forceinline__ void split_f16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  x0 = x0 * PSCALE;
  x1 = x1 * PSCALE;
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// bytes 0 and 2 of w (v + 128 each) as the fp16 pair (v_a, v_b)
__device__ __forceinline__ uint32_t byte_pair_f16(uint32_t w, unsigned sel) {
  const uint32_t b = __byte_perm(w, 0x64646464u, sel);       // 1024 + v + 128
  const __half2 r = __hsub2(*reinterpret_cast<const __half2*>(&b),
                            __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int HD, bool QK_FQ, bool PV_FQ>
__global__ void __launch_bounds__(THREADS)
prefill_attn_kernel(const int8_t* __restrict__ q, Strides qs,
                    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
                    const int* __restrict__ positions,
                    const int* __restrict__ valid, float* __restrict__ out,
                    Strides os, Meta mt, int Hkv, int G, int T, int S) {
  using E = Ed<HD>;
  constexpr int RB = E::RB, DSPLIT = E::DSPLIT, NT = E::NT, KST = E::KST, CPR = E::CPR;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t (*ks_)[BS * RB] = reinterpret_cast<int8_t (*)[BS * RB]>(smem);
  int8_t (*vs_)[BS * RB] = reinterpret_cast<int8_t (*)[BS * RB]>(smem + E::RING);
  // the column groups' row maxima / sums
  double (*xch)[4][32][2] = reinterpret_cast<double (*)[4][32][2]>(smem + 2 * E::RING);
  int* pos_s = reinterpret_cast<int*>(smem + 2 * E::RING + 2 * 4 * 32 * 2 * sizeof(double));

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, cg = tid >> 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int BQ = ROWS / G, GB = G * BQ;               // rows >= GB are idle
  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // the longest rows first

  // row r: query head r / BQ at position t0 + r % BQ
  if (tid < ROWS) {
    const int rt = t0 + tid % BQ;
    pos_s[tid] = (tid < GB && rt < T) ? positions[(size_t)b * T + rt] : -1;
  }
  __syncthreads();
  int pmax = -1;
  for (int i = 0; i < BQ; ++i) pmax = max(pmax, pos_s[i]);
  const int vb = valid[b];
  const int ncols = max(0, min(min(pmax + 1, vb), S));
  const int ntiles = (ncols + BS - 1) / BS;

  // this lane's rows 16 warp + gq (i = 0) and + 8 (i = 1): their q fragments
  // (KST k32 steps), positions and q·o'_k terms
  int qa[KST][4];
  float okq[2];
  int wmax = -1, wmin = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + gq + 8 * i, rt = t0 + r % BQ;
    const bool ok = r < GB && rt < T;
    const int rpos = pos_s[r];
    const int8_t* qp = q + b * qs.b + h * qs.h + (ok ? r / BQ : 0) * qs.g
                       + (long long)(ok ? rt : 0) * qs.t;
    int s = 0;
#pragma unroll
    for (int kk = 0; kk < KST; ++kk) {
      const int w0 = ok ? mqt::ld_i32(qp + 32 * kk + 4 * tq) : 0;
      const int w1 = ok ? mqt::ld_i32(qp + 32 * kk + 16 + 4 * tq) : 0;
      qa[kk][i] = w0;           // a0 / a1: k 4t..
      qa[kk][2 + i] = w1;       // a2 / a3: k 16 + 4t..
      s = __dp4a(w0, 0x01010101, __dp4a(w1, 0x01010101, s));
    }
    s += __shfl_xor_sync(FULL, s, 1);
    s += __shfl_xor_sync(FULL, s, 2);
    okq[i] = mt.ok * (float)s;
    wmax = max(wmax, rpos);
    if (ok) wmin = min(wmin, rpos);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wmax = max(wmax, __shfl_xor_sync(FULL, wmax, o));
    wmin = min(wmin, __shfl_xor_sync(FULL, wmin, o));
  }

  const float inv_sqrt = mt.inv_sqrt;
  const float hdoo = (float)HD * mt.oq * mt.ok;
  const float sqk = mt.sq * mt.sk;

  // K (and V) tiles 2 it and 2 it + 1 into ring stages (2 it) % NST, + 1: 64
  // rows x CPR chunks of 16 B each, rows past S zero-filled
  auto load_pair = [&](int it, bool with_v) {
#pragma unroll
    for (int c = tid; c < 2 * BS * CPR; c += THREADS) {
      const int ti = 2 * it + c / (BS * CPR), r = (c / CPR) % BS, ch = c % CPR;
      if (ti >= ntiles) break;
      const int st = ti % NST, s0 = ti * BS;
      const bool ok = s0 + r < S;
      const size_t off = ((size_t)bh * S + (ok ? s0 + r : 0)) * HD + 16 * ch;
      mqt::cp_async16(&ks_[st][r * RB + 16 * ch], k + off, ok);
      if (with_v) mqt::cp_async16(&vs_[st][r * RB + 16 * ch], v + off, ok);
    }
  };
  // one pass over the tiles, a pair at a time: column group cg runs
  // body(tile, stage) on tile 2 it + cg (at HD 256 on both tiles, in order)
  // while the next pair's loads are in flight
  auto pass = [&](bool with_v, auto&& body) {
    const int npairs = (ntiles + 1) / 2;
    if (npairs > 0) load_pair(0, with_v);
    mqt::cp_async_commit();
    for (int it = 0; it < npairs; ++it) {
      mqt::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < npairs) load_pair(it + 1, with_v);
      mqt::cp_async_commit();
      if constexpr (DSPLIT == 1) {
        const int ti = 2 * it + cg;
        if (ti < ntiles && ti * BS <= wmax) body(ti, ti % NST);
      } else {
#pragma unroll 1
        for (int u = 0; u < 2; ++u) {
          const int ti = 2 * it + u;
          if (ti < ntiles && ti * BS <= wmax) body(ti, ti % NST);
        }
      }
    }
    mqt::cp_async_wait<0>();
    __syncthreads();
  };
  // the other column group's value of this lane's row i (exchanged through xch)
  auto other = [&](double v, int i) {
    xch[cg][warp][lane][i] = v;
    __syncthreads();
    const double r = xch[1 - cg][warp][lane][i];
    __syncthreads();
    return r;
  };

  // the warp's scores of half hh (32 columns) of tile ti: sc[n][0..1] row gq,
  // columns s0 + 32 hh + 8 n + 2 tq, + 1; sc[n][2..3] row gq + 8
  float sc[4][4];
  auto scores = [&](int ti, int st, int hh) {
    const int s0 = ti * BS;
    const bool full = s0 + BS - 1 <= wmin && s0 + BS <= vb;
    const int8_t* kt = ks_[st] + 32 * hh * RB;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      int acc[4] = {0, 0, 0, 0}, ks[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kq = 0; kq < KST / 2; ++kq) {   // 64 dims a K fragment load
        int kf[4];
        mqt::ldsm_x4(kf, kt + (8 * n + (lane & 7)) * RB + 64 * kq + 16 * (lane >> 3));
        // and Σk of this lane's keys 2 tq, 2 tq + 1: the same K fragments times ones
        mqt::mma_s8(acc, qa[2 * kq][0], qa[2 * kq][1], qa[2 * kq][2], qa[2 * kq][3], kf[0],
                    kf[1]);
        mqt::mma_s8(ks, ONES, ONES, ONES, ONES, kf[0], kf[1]);
        mqt::mma_s8(acc, qa[2 * kq + 1][0], qa[2 * kq + 1][1], qa[2 * kq + 1][2],
                    qa[2 * kq + 1][3], kf[2], kf[3]);
        mqt::mma_s8(ks, ONES, ONES, ONES, ONES, kf[2], kf[3]);
      }
      const float oqk[2] = {mt.oq * i2f(ks[0]), mt.oq * i2f(ks[1])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = e & 1;
        float x = ((i2f(acc[e]) - okq[i]) - oqk[c] + hdoo) * sqk;
        if (QK_FQ) x = fq16(x, mt.qks, mt.qko, mt.qkq);
        x = x * inv_sqrt;
        if (!full) {          // the row's position: from shared memory (-1 if idle)
          const int r = 16 * warp + gq + 8 * i, col = s0 + 32 * hh + 8 * n + 2 * tq + c;
          const int rpos = pos_s[r];
          x = x + ((col <= rpos && col < vb) ? 0.0f : mt.neg_inf);
        }
        sc[n][e] = x;
      }
    }
  };

  // o (16 rows x DCG dims from dbase, fp32 · 2^15) += P (sc, fp16 hi + lo) ·
  // V (half hh of stage st). o[n][0] row gq, dim dbase + 2 NT tq + n; o[n][1]
  // dim dbase + 2 NT tq + NT + n; [2], [3] row gq + 8
  const int dbase = DSPLIT == 2 ? cg * E::DCG : 0;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  auto pv = [&](int st, int hh) {
    const int8_t* vt = vs_[st] + 32 * hh * RB;
#pragma unroll
    for (int j = 0; j < 2; ++j) {           // keys 16 j .. 16 j + 15 of the half
      uint32_t ah[4], al[4];
      split_f16(sc[2 * j][0], sc[2 * j][1], ah[0], al[0]);
      split_f16(sc[2 * j][2], sc[2 * j][3], ah[1], al[1]);
      split_f16(sc[2 * j + 1][0], sc[2 * j + 1][1], ah[2], al[2]);
      split_f16(sc[2 * j + 1][2], sc[2 * j + 1][3], ah[3], al[3]);
      // V rows 16 j + 2 tq, + 1 (b0) and + 8, + 9 (b1), dims dbase + NT gq ..
      // + NT − 1
      const int8_t* vr = vt + (16 * j + 2 * tq) * RB + dbase + NT * gq;
      uint32_t r0[NT / 4], r1[NT / 4], r2[NT / 4], r3[NT / 4];
      ld_words<NT>(vr, r0);
      ld_words<NT>(vr + RB, r1);
      ld_words<NT>(vr + 8 * RB, r2);
      ld_words<NT>(vr + 9 * RB, r3);
#pragma unroll
      for (int w = 0; w < NT / 4; ++w) {     // dims NT gq + 4 w .. + 3: n-tiles 4 w + e
        const uint32_t a = r0[w] ^ 0x80808080u, c = r1[w] ^ 0x80808080u;
        const uint32_t d = r2[w] ^ 0x80808080u, f = r3[w] ^ 0x80808080u;
        const uint32_t p01[2] = {__byte_perm(a, c, 0x5140), __byte_perm(a, c, 0x7362)};
        const uint32_t p23[2] = {__byte_perm(d, f, 0x5140), __byte_perm(d, f, 0x7362)};
        uint32_t b0[4], b1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned sel = (e & 1) ? 0x4342 : 0x4140;
          b0[e] = byte_pair_f16(p01[e >> 1], sel);
          b1[e] = byte_pair_f16(p23[e >> 1], sel);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) mqt::mma_f16(o[4 * w + e], ah, b0[e], b1[e]);
#pragma unroll
        for (int e = 0; e < 4; ++e) mqt::mma_f16(o[4 * w + e], al, b0[e], b1[e]);
      }
    }
  };

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.0f, 0.0f}, psum[2] = {0.0f, 0.0f};
  if (!PV_FQ) {
    pass(true, [&](int ti, int st) {
#pragma unroll 1
     for (int hh = 0; hh < 2; ++hh) {
      scores(ti, st, hh);
      float tmax[2] = {-1e30f, -1e30f};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], sc[n][e]);
      float rsc[2], esum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(FULL, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(FULL, tmax[i], 2));
        const float m_new = fmaxf(m[i], tmax[i]);
        rsc[i] = exp2f((m[i] - m_new) * LOG2E);
        m[i] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = exp2f((sc[n][e] - m[e >> 1]) * LOG2E);
          esum[e >> 1] += sc[n][e];
        }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = o[n][e] * rsc[e >> 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        esum[i] += __shfl_xor_sync(FULL, esum[i], 1);
        esum[i] += __shfl_xor_sync(FULL, esum[i], 2);
        l[i] = l[i] * rsc[i] + esum[i];
      }
      pv(st, hh);
     }
    });
  } else {
    // pass 1: the exact row max
    pass(false, [&](int ti, int st) {
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        scores(ti, st, hh);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], sc[n][e]);
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(FULL, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(FULL, m[i], 2));
      if constexpr (DSPLIT == 1) m[i] = fmaxf(m[i], (float)other(m[i], i));
    }
    // pass 2: the denominator, sum of exp(s − m) in fp64, without rescaling
    double ld[2] = {0.0, 0.0};
    pass(false, [&](int ti, int st) {
      double esum[2] = {0.0, 0.0};
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        scores(ti, st, hh);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) esum[e >> 1] += (double)expf(sc[n][e] - m[e >> 1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        esum[i] += __shfl_xor_sync(FULL, esum[i], 1);
        esum[i] += __shfl_xor_sync(FULL, esum[i], 2);
        ld[i] += esum[i];
      }
    });
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if constexpr (DSPLIT == 1) {
        const double ot = other(ld[i], i);
        l[i] = (float)(cg == 0 ? ld[i] + ot : ot + ld[i]);   // group 0's part first
      } else {
        l[i] = (float)ld[i];                                  // every tile in each group
      }
    }
    const float linv[2] = {1.0f / fmaxf(l[0], 1e-30f), 1.0f / fmaxf(l[1], 1e-30f)};
    // pass 3: normalised, fake-quantized probabilities into P·V
    pass(true, [&](int ti, int st) {
      float ps[2] = {0.0f, 0.0f};
#pragma unroll 1
      for (int hh = 0; hh < 2; ++hh) {
        scores(ti, st, hh);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = expf(sc[n][e] - m[e >> 1]) * linv[e >> 1];
            p = fq16(p, mt.pvs, mt.pvo, mt.pvq);
            sc[n][e] = p;
            ps[e >> 1] += p;
          }
        pv(st, hh);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(FULL, ps[i], 1);
        ps[i] += __shfl_xor_sync(FULL, ps[i], 2);
        psum[i] += ps[i];
      }
    });
  }

  if constexpr (DSPLIT == 1) {
    // column group 1 hands its rows' state to group 0 through the (idle)
    // ring: xb[field][row warp][lane], fields o (4 NT), m, l, psum (2 each)
    constexpr int FM = 4 * NT;
    float* xb = reinterpret_cast<float*>(&ks_[0][0]);
    auto xat = [&](int f) -> float& { return xb[(f * 4 + warp) * 32 + lane]; };
    if (cg == 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xat(4 * n + e) = o[n][e];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xat(FM + i) = m[i];
        xat(FM + 2 + i) = l[i];
        xat(FM + 4 + i) = psum[i];
      }
    }
    __syncthreads();
    if (cg == 1) return;
    float sa[2], sb[2];         // the two groups' weights (relaxed: their maxima)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (PV_FQ) {
        sa[i] = sb[i] = 1.0f;
        psum[i] = psum[i] + xat(FM + 4 + i);
      } else {
        const float m1 = xat(FM + i), mm = fmaxf(m[i], m1);
        sa[i] = exp2f((m[i] - mm) * LOG2E);
        sb[i] = exp2f((m1 - mm) * LOG2E);
        l[i] = l[i] * sa[i] + xat(FM + 2 + i) * sb[i];
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = PV_FQ ? o[n][e] + xat(4 * n + e)
                        : o[n][e] * sa[e >> 1] + xat(4 * n + e) * sb[e >> 1];
  }

  // rows gq and gq + 8: dims dbase + 2 NT tq .. + 2 NT − 1
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + gq + 8 * i, rt = t0 + r % BQ;
    if (r >= GB || rt >= T) continue;
    float y[2 * NT];
    const float linv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float acc = o[n][2 * i + c] * (1.0f / PSCALE);
        y[NT * c + n] = PV_FQ ? (acc - mt.ov * psum[i]) * mt.sv
                              : (acc - mt.ov * l[i]) * linv * mt.sv;
      }
    float* op = out + b * os.b + h * os.h + (r / BQ) * os.g + (long long)rt * os.t + dbase
                + 2 * NT * tq;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j)
      reinterpret_cast<float4*>(op)[j] = make_float4(y[4 * j], y[4 * j + 1], y[4 * j + 2],
                                                     y[4 * j + 3]);
  }
}

template <int HD, bool QK_FQ, bool PV_FQ>
int launch(dim3 grid, cudaStream_t st, const int8_t* q, Strides qs, const int8_t* k,
           const int8_t* v, const int* positions, const int* valid, float* out, Strides os,
           const Meta& mt, int Hkv, int G, int T, int S) {
  auto* kern = prefill_attn_kernel<HD, QK_FQ, PV_FQ>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Ed<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, THREADS, Ed<HD>::SMEM, st>>>(q, qs, k, v, positions, valid, out, os, mt, Hkv,
                                            G, T, S);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(bool qk_fq, bool pv_fq, dim3 grid, cudaStream_t st, const int8_t* q,
              Strides qs, const int8_t* k, const int8_t* v, const int* positions,
              const int* valid, float* out, Strides os, const Meta& mt, int Hkv, int G,
              int T, int S) {
  if (qk_fq)
    return pv_fq ? launch<HD, true, true>(grid, st, q, qs, k, v, positions, valid, out, os,
                                          mt, Hkv, G, T, S)
                 : launch<HD, true, false>(grid, st, q, qs, k, v, positions, valid, out, os,
                                           mt, Hkv, G, T, S);
  return pv_fq ? launch<HD, false, true>(grid, st, q, qs, k, v, positions, valid, out, os, mt,
                                         Hkv, G, T, S)
               : launch<HD, false, false>(grid, st, q, qs, k, v, positions, valid, out, os,
                                          mt, Hkv, G, T, S);
}

}  // namespace

// meta_host: the JAX engine's 13-float attention meta
// [sq, oq, sk, ok, sv, ov, qk_out s, o, qmax, pv_in s, o, qmax, neg_inf]
// (offsets unshifted, as there), then the fp32 of 1 / √hd. q_strides /
// o_strides: 4 int64 element strides each (b, kv head, group, t) of q and
// out; out's dims contiguous and 16-byte aligned. hd 64, 128 or 256;
// 1 <= G <= 64 (a block takes ⌊64 / G⌋ positions of each query head).
MQT_EXPORT int mqt_prefill_attention(const void* q, const void* q_strides,
                                     const void* k, const void* v,
                                     const void* positions, const void* valid,
                                     void* out, const void* o_strides,
                                     const void* meta_host, int B, int Hkv,
                                     int G, int T, int S, int hd, int qk_fq,
                                     int pv_fq, void* stream) {
  if ((hd != 64 && hd != 128 && hd != 256) || G < 1 || G > ROWS)
    return (int)cudaErrorInvalidValue;
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
  mt.inv_sqrt = mh[13];
  Strides qs{qsp[0], qsp[1], qsp[2], qsp[3]};
  Strides os{osp[0], osp[1], osp[2], osp[3]};
  const int BQ = ROWS / G;
  dim3 grid(B * Hkv, (T + BQ - 1) / BQ);
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t *qp = (const int8_t*)q, *kp = (const int8_t*)k, *vp = (const int8_t*)v;
  const int *pp = (const int*)positions, *vl = (const int*)valid;
  float* o = (float*)out;
  if (hd == 64)
    return launch_hd<64>(qk_fq, pv_fq, grid, st, qp, qs, kp, vp, pp, vl, o, os, mt, Hkv, G, T, S);
  if (hd == 128)
    return launch_hd<128>(qk_fq, pv_fq, grid, st, qp, qs, kp, vp, pp, vl, o, os, mt, Hkv, G, T,
                          S);
  return launch_hd<256>(qk_fq, pv_fq, grid, st, qp, qs, kp, vp, pp, vl, o, os, mt, Hkv, G, T, S);
}
