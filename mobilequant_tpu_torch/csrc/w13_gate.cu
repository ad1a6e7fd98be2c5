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
// Bound: at prefill M the weight bytes and the integer operations of the
// 2F-wide matmul (TinyLlama at M = 128: 11.5 MB, 3.4 us; 5.9 G int8
// operations, 3.0 us on the tensor cores). Design: the int8 tensor-core tile
// core (tc_tile.cuh: mma.sync m16n8k32 over a four-stage cp.async ring of
// activation and weight chunks, the W4 nibbles unpacked in registers once per
// chunk) over 64-row x 128-column tiles whose column map is split (columns
// 0..63 read w1 columns j0.., 64..127 read w3 columns F + j0..), so one block
// holds both operands of its 64 gate outputs and the (M, 2F) fp32
// intermediate never leaves shared memory. Split-K only where the tiles
// alone leave SMs idle (M <= 64), through the self-cleaning workspace.
#include "tc_tile.cuh"

namespace {

using namespace mqt;

constexpr int HALF = TC_BN / 2;

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
__global__ void __launch_bounds__(TC_THREADS, 2)
w13_gate_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                Affine aff, GateArgs ga, int8_t* __restrict__ out, int* ws,
                int M, int K, int F, int ks, int cps) {
  extern __shared__ int4 ring_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(ring_raw);
  __shared__ int rsum[TC_BM];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int ntiles = gridDim.x * gridDim.y;
  const int j0 = blockIdx.x * HALF, m0 = blockIdx.y * TC_BM;
  const int N2 = 2 * F;
  const int nchunks = ((K >> 1) + TC_KP - 1) / TC_KP;
  const int c0 = blockIdx.z * cps, c1 = min(nchunks, c0 + cps);
  ColMap cm{j0, F + j0, HALF, HALF, HALF};   // F % 64 == 0 (checked by the caller)
  TcAcc acc;
  tc_tile<WB>(x, w, M, K, N2, m0, cm, c0, c1, ring, rsum, acc);
  if (ks > 1 && !tc_workspace_reduce(ws, ntiles, tile, M, N2, m0, cm, acc, rsum, &last, ks))
    return;

  // the affine bracket and the w1 / w3 output sites on the accumulators,
  // staged as fp32 in the (now free) ring
  float(*y)[TC_BN + 1] = reinterpret_cast<float(*)[TC_BN + 1]>(ring);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = tc_row(mt, e), nl = tc_col(c, e);
        float v = aff(acc.d[mt][c][e], cm.gcol(nl), (float)rsum[m]);
        if (nl < HALF) {
          if (ga.s_w1) v = fq(v, ga.m[2], ga.m[3], ga.m[4]);
        } else {
          if (ga.s_w3) v = fq(v, ga.m[11], ga.m[12], ga.m[13]);
        }
        y[m][nl] = v;
      }
  __syncthreads();

  for (int idx = tid; idx < TC_BM * HALF; idx += TC_THREADS) {
    const int m = idx / HALF, n = idx % HALF, gm = m0 + m;
    if (gm >= M) continue;
    const float g1 = y[m][n];
    const float g3 = y[m][HALF + n];
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

template <int WB>
int launch_w13_gate(dim3 grid, const int8_t* x, const int8_t* w, const Affine& aff,
                    const GateArgs& ga, int8_t* out, int* ws, int M, int K, int F, int ks,
                    int cps, cudaStream_t st) {
  constexpr int smem = tc_smem_bytes<WB>();
  cudaError_t e = cudaFuncSetAttribute(w13_gate_kernel<WB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  w13_gate_kernel<WB><<<grid, TC_THREADS, smem, st>>>(x, w, aff, ga, out, ws, M, K, F, ks, cps);
  return (int)cudaGetLastError();
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
  const int tn = F / HALF, tm = (M + TC_BM - 1) / TC_BM;
  const int nchunks = ((K >> 1) + TC_KP - 1) / TC_KP;
  int ks, cps;
  tc_pick_split(tn * tm, nchunks, ks, cps);
  dim3 grid(tn, tm, ks);
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  cudaStream_t st = (cudaStream_t)stream;
  if (wbits == 8)
    return launch_w13_gate<8>(grid, xp, wp, aff, ga, (int8_t*)out, (int*)ws, M, K, F, ks, cps,
                              st);
  if (wbits == 4)
    return launch_w13_gate<4>(grid, xp, wp, aff, ga, (int8_t*)out, (int*)ws, M, K, F, ks, cps,
                              st);
  return (int)cudaErrorInvalidValue;
}
