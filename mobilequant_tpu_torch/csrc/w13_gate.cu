// Prefill w1|w3 projection with the gated-activation epilogue:
//   h8 (M, K) shifted int8 × W4 w13 (K/2, 2F) or W8 w13 (K, 2F): column j of
//   w1 and column F + j of w3 -> affine bracket -> w1 / w3 output fake-quant
//   -> SiLU as g1 · fq(1 / (1 + exp(−g1))) (or gelu_tanh) -> fq
//   -> gate multiply -> w2-input quantization -> (M, F) shifted int8.
//
// Replaces mobilequant_tpu/ops/pallas_mlp.py: w13_gate_stacked
// (_w13_gate_kernel), both of its editions (wbits 4 and 8). The meta vector
// is the JAX engine's _mlp_block_meta (indices 0..15 used); site_on switches
// the four optional fake-quant sites.
//
// Bound: at prefill M the integer operations of the 2F-wide matmul. Design:
// the shared W4A8 / W8A8 tile core (templated on the weight bits) with a
// split column map (tile columns 0..63 read w1 columns j0.., columns 64..127
// read w3 columns F + j0..), so one block holds both operands of its 64 gate
// outputs; the (M, 2F) fp32 intermediate never leaves shared memory.
#include "mqt_common.cuh"

namespace {

using namespace mqt;

constexpr int HALF = TBN / 2;

struct GateArgs {
  float m[16];
  int s_w1, s_sig, s_act, s_w3;
  int gelu;
};

__device__ __forceinline__ float fq(float x, float s, float o, float qmax) {
  float q = rintf(x / s) + o;
  q = fminf(fmaxf(q, 0.0f), qmax);
  return qmax > 0.5f ? (q - o) * s : x;
}

template <int WB>
__global__ void __launch_bounds__(TTHREADS)
w13_gate_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                Affine aff, GateArgs ga, int8_t* __restrict__ out, int* ws,
                int M, int K, int F, int ks, int cps) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ntn = gridDim.x;
  const int tile = blockIdx.y * ntn + blockIdx.x;
  const int ntiles = ntn * gridDim.y;
  const int j0 = blockIdx.x * HALF, m0 = blockIdx.y * TBM;
  const int N2 = 2 * F;
  const int nchunks = (K >> 1) / TBKP;
  const int c0 = blockIdx.z * cps, c1 = min(nchunks, c0 + cps);
  ColMap cm{j0, F + j0, HALF, HALF, HALF};   // F % 64 == 0 (checked by the caller)
  int acc[4][8] = {};
  int rs = 0;
  tile_mma<WB>(x, w, M, K, N2, m0, cm, c0, c1, sm, acc, rs);
  if (!splitk_reduce(ws, ntiles, tile, ks, M, N2, m0, cm, sm, acc, rs)) return;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nl = tx + 16 * j;
      float y = aff(acc[i][j], cm.gcol(nl), (float)sm.rsum[m]);
      if (nl < HALF) {
        if (ga.s_w1) y = fq(y, ga.m[2], ga.m[3], ga.m[4]);
      } else {
        if (ga.s_w3) y = fq(y, ga.m[11], ga.m[12], ga.m[13]);
      }
      sm.u.y[m][nl] = y;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TBM * HALF; idx += TTHREADS) {
    const int m = idx / HALF, n = idx % HALF, gm = m0 + m;
    if (gm >= M) continue;
    const float g1 = sm.u.y[m][n];
    const float g3 = sm.u.y[m][HALF + n];
    float act;
    if (!ga.gelu) {
      float sig = 1.0f / (1.0f + expf(-g1));
      if (ga.s_sig) sig = fq(sig, ga.m[5], ga.m[6], ga.m[7]);
      act = g1 * sig;
    } else {
      const float t = 0.7978845608028654f * (g1 + 0.044715f * g1 * g1 * g1);
      act = 0.5f * g1 * (1.0f + tanhf(t));
    }
    if (ga.s_act) act = fq(act, ga.m[8], ga.m[9], ga.m[10]);
    const float prod = act * g3;
    float q = rintf(prod / ga.m[14]) + ga.m[15];
    q = fminf(fmaxf(q, 0.0f), 255.0f) - 128.0f;
    out[(size_t)gm * F + j0 + n] = (int8_t)(int)q;
  }
}

}  // namespace

MQT_EXPORT int mqt_w13_gate(const void* x, const void* w, const void* scale,
                            const void* offset, const void* colsum,
                            const void* bias, const void* meta_host, void* out,
                            void* ws, int M, int K, int F, int sstride,
                            int s_w1, int s_sig, int s_act, int s_w3, int gelu,
                            int wbits, void* stream) {
  const float* meta = (const float*)meta_host;
  Affine aff;
  aff.scale = (const float*)scale;
  aff.offset = (const float*)offset;
  aff.colsum = (const float*)colsum;
  aff.bias = (const float*)bias;
  aff.sstride = sstride;
  aff.xs = meta[0];
  aff.ox = meta[1] - 128.0f;
  aff.kox = (float)K * aff.ox;
  GateArgs ga;
  for (int i = 0; i < 16; ++i) ga.m[i] = meta[i];
  ga.s_w1 = s_w1;
  ga.s_sig = s_sig;
  ga.s_act = s_act;
  ga.s_w3 = s_w3;
  ga.gelu = gelu;
  const int tn = F / HALF, tm = (M + TBM - 1) / TBM;
  const int nchunks = (K >> 1) / TBKP;
  int ks, cps;
  pick_split(tn * tm, nchunks, 4, ks, cps);
  dim3 grid(tn, tm, ks);
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (wbits == 8)
    w13_gate_kernel<8><<<grid, TTHREADS, 0, st>>>(xp, wp, aff, ga, (int8_t*)out, (int*)ws,
                                                   M, K, F, ks, cps);
  else if (wbits == 4)
    w13_gate_kernel<4><<<grid, TTHREADS, 0, st>>>(xp, wp, aff, ga, (int8_t*)out, (int*)ws,
                                                   M, K, F, ks, cps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
