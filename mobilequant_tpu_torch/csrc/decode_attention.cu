// int8-KV decode attention (T = 1) over one layer of the cache.
//
// Replaces mobilequant_tpu/ops/pallas_attention.py decode_attention
// (_decode_attn_kernel): per (sequence, kv head), the G query heads against
// the cache rows < valid_len (the step's own row already written), with the
// 16-bit score and probability fake-quants when the meta enables them.
//
// Bound: device-memory bytes (the valid K and V rows). Design, for a first
// version that is right: one block per (sequence, kv head); a thread per
// cache row loads it with 16-byte loads, computes its G integer dots and its
// row sum with dp4a (exact) and the JAX kernel's fp32 score epilogue in its
// order, writing the scores to shared memory; a warp per query head takes the
// max, the exps, the denominator and ΣP (fp64 sums, rounded once); P·V takes
// one (query head, hd lane) output per thread and walks the rows in order with
// an fp64 accumulator. Rows >= valid_len are not read: their exp is exactly 0
// (the host asks for every row in the strict policy when fq16(0) would not be
// 0). With the fp64-then-round sums the result does not depend on the
// summation order, so the plain PyTorch version (ops/decode_attention.py)
// computes the same fp32 values. Build with --fmad=false (see mqt_common.cuh).
#include "mqt_common.cuh"

namespace {

constexpr int DA_THREADS = 256;

// Host-computed fp32 constants, in the plain version's order (decode_attention._consts).
struct DaConsts {
  float oq, ok, ov, sqk, c_hd, inv;
  float qs, qo, qm;     // qk_bmm output fake-quant (qm 0: off)
  float ps, po, pm;     // pv_bmm input fake-quant (pm 0: off)
  float sv, neg_inf;
};

using mqt::fq16;
using mqt::warp_max;
using mqt::warp_sum;

template <int G>
__global__ void __launch_bounds__(DA_THREADS) decode_attn_kernel(
    const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
    const int8_t* __restrict__ v8, const int* __restrict__ valid, float* __restrict__ out,
    DaConsts k, int hkv, int hd, int S, int skip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hw = hd >> 2;
  int* qw = reinterpret_cast<int*>(smem);                       // [G][hw]
  float* lg = reinterpret_cast<float*>(smem + G * hd);          // [G][S]
  int* qsum = reinterpret_cast<int*>(lg + G * S);               // [G]
  float* den_s = reinterpret_cast<float*>(qsum + G);            // [G]
  float* psum_s = den_s + G;                                    // [G]

  const int bh = blockIdx.x, b = bh / hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int vlen = valid[b];
  const int n = skip ? min(max(vlen, 0), S) : S;
  const int8_t* kb = k8 + (size_t)bh * S * hd;
  const int8_t* vb = v8 + (size_t)bh * S * hd;

  for (int i = tid; i < G * hw; i += blockDim.x) qw[i] = mqt::ld_i32(q8 + (size_t)bh * G * hd + 4 * i);
  __syncthreads();
  if (tid < G) {
    int s = 0;
    for (int w = 0; w < hw; ++w) s = __dp4a(qw[tid * hw + w], 0x01010101, s);
    qsum[tid] = s;
  }
  __syncthreads();

  // ---- scores: a thread per cache row ----------------------------------------
  for (int s = tid; s < n; s += blockDim.x) {
    const int8_t* row = kb + (size_t)s * hd;
    int acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0;
    int ks = 0;
    for (int w4 = 0; w4 < hw; w4 += 4) {
      const int4 kv = __ldg(reinterpret_cast<const int4*>(row + 4 * w4));
      const int kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ks = __dp4a(kw[i], 0x01010101, ks);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = __dp4a(qw[g * hw + w4 + i], kw[i], acc[g]);
      }
    }
    const float ksf = (float)ks;
    const float mask = s < vlen ? 0.f : k.neg_inf;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float t = (float)acc[g] - k.ok * (float)qsum[g];
      t = t - k.oq * ksf;
      t = t + k.c_hd;
      float sc = t * k.sqk;
      if (k.qm > 0.5f) sc = fq16(sc, k.qs, k.qo, k.qm);
      sc = sc * k.inv;
      lg[g * S + s] = sc + mask;
    }
  }
  __syncthreads();

  // ---- softmax: a warp per query head -------------------------------------------
  for (int g = warp; g < G; g += nwarps) {
    float* row = lg + g * S;
    float mx = -3.4028235e38f;
    for (int s = lane; s < n; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    double den = 0.0;
    for (int s = lane; s < n; s += 32) { const float e = expf(row[s] - mx); row[s] = e; den += e; }
    const float denf = warp_sum(den);
    double ps = 0.0;
    for (int s = lane; s < n; s += 32) {
      float p = row[s] / denf;
      if (k.pm > 0.5f) p = fq16(p, k.ps, k.po, k.pm);
      row[s] = p;
      ps += p;
    }
    const float psf = warp_sum(ps);
    if (lane == 0) { den_s[g] = denf; psum_s[g] = psf; }
  }
  __syncthreads();

  // ---- P·V: one (query head, hd lane) output per thread ---------------------------
  for (int o = tid; o < G * hd; o += blockDim.x) {
    const int g = o / hd, d = o - g * hd;
    const float* prow = lg + g * S;
    double acc = 0.0;
    for (int s = 0; s < n; ++s) acc += (double)prow[s] * (double)vb[(size_t)s * hd + d];
    const float pv = (float)acc;
    out[((size_t)bh * G + g) * hd + d] = (pv - k.ov * psum_s[g]) * k.sv;
  }
}

template <int G>
int launch(const void* q8, const void* k8, const void* v8, const void* valid, void* out,
           const DaConsts& k, int BH, int hkv, int hd, int S, int skip, size_t smem,
           cudaStream_t stream) {
  static size_t opted = 48 * 1024;   // dynamic shared memory allowed so far
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(decode_attn_kernel<G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  decode_attn_kernel<G><<<BH, DA_THREADS, smem, stream>>>(
      (const int8_t*)q8, (const int8_t*)k8, (const int8_t*)v8, (const int*)valid, (float*)out,
      k, hkv, hd, S, skip);
  return (int)cudaGetLastError();
}

}  // namespace

// q8 (B, hkv, G, hd); k8 / v8 (B, hkv, S, hd); valid (B,); out (B, hkv, G, hd)
// fp32; consts: 14 host floats (DaConsts). hd % 16 == 0, G in {1, 2, 4, 8, 16}.
MQT_EXPORT int mqt_decode_attention(const void* q8, const void* k8, const void* v8,
                                    const void* valid, void* out, const float* consts, int B,
                                    int hkv, int G, int hd, int S, int skip, void* stream) {
  if (hd % 16 || hd > 128 || S < 1 || hkv < 1) return (int)cudaErrorInvalidValue;
  DaConsts k;
  float* kf = reinterpret_cast<float*>(&k);
  for (int i = 0; i < (int)(sizeof(DaConsts) / sizeof(float)); ++i) kf[i] = consts[i];
  const size_t smem = (size_t)G * hd + 4 * (size_t)G * S + 12 * (size_t)G;
  cudaStream_t st = (cudaStream_t)stream;
#define MQT_DA_CASE(g) \
  case g:              \
    return launch<g>(q8, k8, v8, valid, out, k, B * hkv, hkv, hd, S, skip, smem, st);
  switch (G) {
    MQT_DA_CASE(1)
    MQT_DA_CASE(2)
    MQT_DA_CASE(4)
    MQT_DA_CASE(8)
    MQT_DA_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MQT_DA_CASE
}
