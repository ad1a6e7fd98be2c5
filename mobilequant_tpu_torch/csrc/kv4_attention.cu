// Staged decode attention over the nibble-packed int4 KV cache.
//
// Replaces mobilequant_tpu/ops/pallas_kv4.py kv4_decode_attention
// (_kv4_attn_kernel). One launch per layer, one block per (sequence, kv head)
// with its G query heads. The packed cache is hd-major, (L, B·Hkv, hd, S/2):
// byte (d, c) holds position c in its low nibble and c + S/2 in its high
// nibble, raw 4-bit values. Four score parts share one softmax: cache lo
// (c < pos), cache hi (c + S/2 < pos), the chunk's staged rows (j < m_staged,
// shifted int8) and the step's own row.
//
// Bound: device-memory bytes (the valid packed K and V columns, their K
// column sums, the staged rows); a decode step's attention is far below the
// card's operation rate. Design, for a first version that is right:
//   * scores: each thread takes four packed columns at a time; four hd-rows of
//     their bytes (one 4-byte load each, neighbouring threads on neighbouring
//     words) are transposed into dp4a operands for both nibble planes, so the
//     integer dots are exact; the epilogue repeats the JAX kernel's fp32
//     affine bracket in its order and writes every score to shared memory;
//   * only valid columns are read: a masked column's exp is exactly 0, so it
//     is skipped (the host asks for every column in the strict policy when
//     fq16(0) would not be 0);
//   * softmax: a warp per query head; the denominator and ΣP are summed in
//     fp64 and rounded once to fp32;
//   * P·V: a warp per hd row of the packed V (lanes along S, coalesced), fp64
//     accumulators per query head, rounded once after a warp reduction.
// The fp64-then-round sums make the result independent of the summation
// order, so the plain PyTorch version (ops/kv4_attention.py) computes the
// same fp32 values. Build with --fmad=false (see mqt_common.cuh).
#include "mqt_common.cuh"

namespace {

constexpr int KV4_THREADS = 256;

// Host-computed fp32 constants, in the plain version's order (kv4_attention._consts).
struct Kv4Consts {
  float oqs, ok, oks, inv, sqk, cf, c_lo, c_st, ksh;
  float qs, qo, qm;     // qk_bmm output fake-quant (scale, offset, clip max)
  float ps, po, pm;     // pv_bmm input fake-quant
  float sv, ov, neg_inf;
};

using mqt::fq16;
using mqt::warp_max;
using mqt::warp_sum;

template <int G>
__global__ void __launch_bounds__(KV4_THREADS) kv4_attn_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const float* __restrict__ kcs,
    const int8_t* __restrict__ sk, const int8_t* __restrict__ sv,
    const int8_t* __restrict__ kn, const int8_t* __restrict__ vn,
    const int* __restrict__ pos, float* __restrict__ out, Kv4Consts k, int BH, int hkv,
    int hd, int S2, int cs, int mst, int layer, int qk_fq, int pv_fq, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hw = hd >> 2;                       // int words of a q row
  const int ldc = 2 * S2 + cs + 1;              // score columns of a q head
  int* qw = reinterpret_cast<int*>(smem);       // [G][hw]
  float* lg = reinterpret_cast<float*>(smem + G * hd);        // [G][ldc]
  int* qsum = reinterpret_cast<int*>(lg + G * ldc);           // [G]
  float* den_s = reinterpret_cast<float*>(qsum + G);          // [G]
  float* psum_s = den_s + G;                                  // [G]

  const int bh = blockIdx.x, b = bh / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int p = pos[b];
  const int nlo = skip ? min(max(p, 0), S2) : S2;
  const int nhi = skip ? min(max(p - S2, 0), S2) : S2;
  const int nlo4 = (nlo + 3) & ~3, nhi4 = (nhi + 3) & ~3;
  const int ncs = skip ? mst : cs;
  const int cself = 2 * S2 + cs;
  const size_t slab = ((size_t)layer * BH + bh);

  for (int i = tid; i < G * hw; i += blockDim.x) qw[i] = mqt::ld_i32(q8 + (size_t)bh * G * hd + 4 * i);
  __syncthreads();
  if (tid < G) {
    int s = 0;
    for (int w = 0; w < hw; ++w) s = __dp4a(qw[tid * hw + w], 0x01010101, s);
    qsum[tid] = s;
  }
  __syncthreads();

  // ---- cache scores, both nibble planes ----------------------------------
  const int8_t* kbase = kp + slab * hd * S2;
  const float* kcl = kcs + slab * 2 * S2;
  for (int j = tid; j < (nlo4 >> 2); j += blockDim.x) {
    const int c0 = 4 * j;
    const bool do_hi = c0 < nhi4;
    int alo[G][4], ahi[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int x = 0; x < 4; ++x) alo[g][x] = ahi[g][x] = 0;
    for (int d = 0; d < hd; d += 4) {
      int r[4], cw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) r[i] = mqt::ld_i32(kbase + (size_t)(d + i) * S2 + c0);
      mqt::transpose4x4(r, cw);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int lo = cw[x] & (int)mqt::NIB;
        const int hi = (int)(((unsigned)cw[x] >> 4) & mqt::NIB);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int qv = qw[g * hw + (d >> 2)];
          alo[g][x] = __dp4a(qv, lo, alo[g][x]);
          if (do_hi) ahi[g][x] = __dp4a(qv, hi, ahi[g][x]);
        }
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int c = c0 + x;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float qs = (float)qsum[g];
        for (int plane = 0; plane < (do_hi ? 2 : 1); ++plane) {
          const float acc = (float)(plane ? ahi[g][x] : alo[g][x]);
          const float ks = kcl[plane * S2 + c];
          float t = acc - k.ok * qs;
          t = t - k.oqs * (ks + k.ksh);
          t = t + k.c_lo;
          float sc = t * k.cf;
          if (qk_fq) sc = fq16(sc, k.qs, k.qo, k.qm) * k.inv;
          sc = sc + ((plane * S2 + c < p) ? 0.f : k.neg_inf);
          lg[g * ldc + plane * S2 + c] = sc;
        }
      }
    }
  }

  // ---- staged scores ------------------------------------------------------
  for (int i = tid; i < G * ncs; i += blockDim.x) {
    const int g = i / ncs, jj = i - g * ncs;
    const int8_t* row = sk + (slab * cs + jj) * hd;
    int acc = 0, ks = 0;
    for (int w = 0; w < hw; ++w) {
      const int kw = mqt::ld_i32(row + 4 * w);
      acc = __dp4a(qw[g * hw + w], kw, acc);
      ks = __dp4a(kw, 0x01010101, ks);
    }
    float t = (float)acc - k.oks * (float)qsum[g];
    t = t - k.oqs * (float)ks;
    t = t + k.c_st;
    float sc = t * k.cf;
    if (qk_fq) sc = fq16(sc, k.qs, k.qo, k.qm) * k.inv;
    sc = sc + (jj < mst ? 0.f : k.neg_inf);
    lg[g * ldc + 2 * S2 + jj] = sc;
  }

  // ---- self score: a warp per q head, fp64 sum -------------------------------
  const int8_t* qb = reinterpret_cast<const int8_t*>(qw);
  for (int g = warp; g < G; g += nwarps) {
    double s = 0.0;
    for (int d = lane; d < hd; d += 32) {
      const float a = (float)qb[g * hd + d] - k.oqs;
      const float c = (float)kn[(size_t)bh * hd + d] - k.oks;
      s += (double)(a * c);
    }
    const float sf = warp_sum(s);
    if (lane == 0) {
      float ss = sf * k.sqk;
      if (qk_fq) ss = fq16(ss, k.qs, k.qo, k.qm);
      lg[g * ldc + cself] = ss * k.inv;
    }
  }
  __syncthreads();

  // ---- partwise softmax: shared max, per-part exp, one denominator ------------
  for (int g = warp; g < G; g += nwarps) {
    float* row = lg + g * ldc;
    float mx = row[cself];
    for (int c = lane; c < nlo4; c += 32) mx = fmaxf(mx, row[c]);
    for (int c = lane; c < nhi4; c += 32) mx = fmaxf(mx, row[S2 + c]);
    for (int c = lane; c < ncs; c += 32) mx = fmaxf(mx, row[2 * S2 + c]);
    mx = warp_max(mx);
    double den = 0.0;
    for (int c = lane; c < nlo4; c += 32) { const float e = expf(row[c] - mx); row[c] = e; den += e; }
    for (int c = lane; c < nhi4; c += 32) {
      const float e = expf(row[S2 + c] - mx); row[S2 + c] = e; den += e;
    }
    for (int c = lane; c < ncs; c += 32) {
      const float e = expf(row[2 * S2 + c] - mx); row[2 * S2 + c] = e; den += e;
    }
    __syncwarp();
    if (lane == 0) { const float e = expf(row[cself] - mx); row[cself] = e; den += e; }
    const float denf = warp_sum(den);
    float psf = 0.f;
    if (pv_fq) {
      double ps = 0.0;
      for (int c = lane; c < nlo4; c += 32) {
        const float q = fq16(row[c] / denf, k.ps, k.po, k.pm); row[c] = q; ps += q;
      }
      for (int c = lane; c < nhi4; c += 32) {
        const float q = fq16(row[S2 + c] / denf, k.ps, k.po, k.pm); row[S2 + c] = q; ps += q;
      }
      for (int c = lane; c < ncs; c += 32) {
        const float q = fq16(row[2 * S2 + c] / denf, k.ps, k.po, k.pm);
        row[2 * S2 + c] = q; ps += q;
      }
      if (lane == 0) {
        const float q = fq16(row[cself] / denf, k.ps, k.po, k.pm); row[cself] = q; ps += q;
      }
      psf = warp_sum(ps);
    }
    if (lane == 0) { den_s[g] = denf; psum_s[g] = psf; }
  }
  __syncthreads();

  // ---- P·V in the raw V domain: a warp per hd row ----------------------------
  const int8_t* vbase = vp + slab * hd * S2;
  for (int d = warp; d < hd; d += nwarps) {
    double acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0;
    const int8_t* vrow = vbase + (size_t)d * S2;
    for (int j = lane; j < (nlo4 >> 2); j += 32) {
      const unsigned w4 = (unsigned)mqt::ld_i32(vrow + 4 * j);
      const bool do_hi = 4 * j < nhi4;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = 4 * j + x;
        const unsigned byte = (w4 >> (8 * x)) & 0xFFu;
        const double vlo = (double)(byte & 0xFu), vhi = (double)(byte >> 4);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] += (double)lg[g * ldc + c] * vlo;
          if (do_hi) acc[g] += (double)lg[g * ldc + S2 + c] * vhi;
        }
      }
    }
    for (int jj = lane; jj < ncs; jj += 32) {
      const double vs = (double)(sv[(slab * cs + jj) * hd + d] & 0x0F);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += (double)lg[g * ldc + 2 * S2 + jj] * vs;
    }
    if (lane == 0) {
      const double vr = (double)(vn[(size_t)bh * hd + d] & 0x0F);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += (double)lg[g * ldc + cself] * vr;
    }
    float A[G];
#pragma unroll
    for (int g = 0; g < G; ++g) A[g] = warp_sum(acc[g]);
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float o = pv_fq ? (A[g] - k.ov * psum_s[g]) * k.sv : (A[g] / den_s[g] - k.ov) * k.sv;
        out[((size_t)bh * G + g) * hd + d] = o;
      }
    }
  }
}

template <int G>
int launch(const void* q8, const void* kp, const void* vp, const void* kcs, const void* sk,
           const void* sv, const void* kn, const void* vn, const void* pos, void* out,
           const Kv4Consts& k, int BH, int hkv, int hd, int S2, int cs, int mst, int layer,
           int qk_fq, int pv_fq, int skip, size_t smem, cudaStream_t stream) {
  static size_t opted = 48 * 1024;   // dynamic shared memory allowed so far
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(kv4_attn_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  kv4_attn_kernel<G><<<BH, KV4_THREADS, smem, stream>>>(
      (const int8_t*)q8, (const int8_t*)kp, (const int8_t*)vp, (const float*)kcs,
      (const int8_t*)sk, (const int8_t*)sv, (const int8_t*)kn, (const int8_t*)vn,
      (const int*)pos, (float*)out, k, BH, hkv, hd, S2, cs, mst, layer, qk_fq, pv_fq, skip);
  return (int)cudaGetLastError();
}

}  // namespace

// q8 (BH, G, hd); kp / vp (L, BH, hd, S2); kcs (L, BH, 2 S2) fp32; sk / sv
// (L, BH, cs, hd); kn / vn (BH, hd); pos (B,) with B = BH / hkv; out (BH, G, hd)
// fp32; consts: 18 host floats (Kv4Consts). hd % 4 == 0, S2 % 4 == 0,
// G in {1, 2, 4, 8, 16}.
MQT_EXPORT int mqt_kv4_decode_attention(const void* q8, const void* kp, const void* vp,
                                        const void* kcs, const void* sk, const void* sv,
                                        const void* kn, const void* vn, const void* pos,
                                        void* out, const float* consts, int BH, int hkv, int G,
                                        int hd, int S2, int cs, int mst, int layer, int qk_fq,
                                        int pv_fq, int skip, void* stream) {
  if (hd % 4 || hd > 128 || S2 % 4 || hkv < 1 || BH % hkv || mst < 0 || mst > cs)
    return (int)cudaErrorInvalidValue;
  Kv4Consts k;
  float* kf = reinterpret_cast<float*>(&k);
  for (int i = 0; i < (int)(sizeof(Kv4Consts) / sizeof(float)); ++i) kf[i] = consts[i];
  const size_t smem = (size_t)G * hd + 4 * (size_t)G * (2 * S2 + cs + 1) + 12 * (size_t)G;
  cudaStream_t st = (cudaStream_t)stream;
#define MQT_KV4_CASE(g)                                                                   \
  case g:                                                                                 \
    return launch<g>(q8, kp, vp, kcs, sk, sv, kn, vn, pos, out, k, BH, hkv, hd, S2, cs, \
                     mst, layer, qk_fq, pv_fq, skip, smem, st);
  switch (G) {
    MQT_KV4_CASE(1)
    MQT_KV4_CASE(2)
    MQT_KV4_CASE(4)
    MQT_KV4_CASE(8)
    MQT_KV4_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MQT_KV4_CASE
}
