// Shared pieces of the cooperative fused kernels (fused_layer.cu: the B <= 8
// decode step, the B = 1 layer and the M <= 8 MLP block; fused_rows.cu: the
// B = 16..128 staged decode step, the o-tail and the M > 8 MLP block): the
// argument block both take, the fp32 fake-quant helpers, the fp64 warp and
// block sums, the generation-counted grid barrier and the cooperative launch.
//
// Every launch is cooperative and persistent (cudaLaunchCooperativeKernel,
// one or two blocks per SM, all resident) so that a grid-wide barrier can
// separate dependent stages. Buffers written inside a launch are read with
// __ldcg (L2), never through the non-coherent read-only path.
#pragma once

#include <cstddef>

#include "mqt_common.cuh"

// One layer-stacked projection pack: wq (L, kin/2, n) unsigned block nibbles
// (bits 4) or (L, kin, n) shifted int8 (bits 8); scale/offset element
// l·s_l + col·s_c (s_c 0: per tensor, the W8 packs' o and w2); colsum/bias
// (L, n).
struct MqtStackedW4 {
  const int8_t* wq;
  const float* scale;
  const float* offset;
  const float* colsum;
  const float* bias;       // or null
  long long s_l;
  int s_c;
  int kin;
  int n;
  int bits;                // 4 or 8
};

struct MqtFusedArgs {
  const float* x_in;       // (M, K) layer input (decode) / residual (MLP block, o-tail)
  float* x_out;            // (M, K)
  int8_t* kv_new;          // (l1 - l0, B, 2 Hkv, hd)
  float* logits;           // (B, Vp) or null (no head stage)
  const int* pos;          // (B,) cache position (chunk: chunk-start position)
  const float* cs;         // (B, 2, hd) cos | sign-baked sin
  const float* meta;       // (L, 65) layer metas (decode)
  const float* ofq;        // (L, 4, Nq) qkv output fake-quant rows
  const float* anw;        // (L, K) attention norm
  const float* anb;
  const float* mnw;        // (L, K) MLP norm
  const float* mnb;
  const int8_t* kcache;    // (L, B, Hkv, S, hd)
  const int8_t* vcache;
  const int8_t* hwq;       // the head: (K/2, Vp) W4 or (K, Vp) W8 (hbits)
  const float* hscale;     // (Vp,)
  const float* hoffset;    // (Vp,)
  const float* fnw;        // (K,) final norm
  const float* fnb;
  float* yq;               // scratch (B, Nq)
  float* resid;            // scratch (M, K)
  int8_t* a8;              // scratch (B, Ko); the o-tail's input (M, Ko)
  int8_t* act8;            // scratch (M, F)
  int* ws;                 // int32 workspace, all zero between launches
  unsigned* bar;           // grid barrier words (count, generation)
  unsigned long long* trace;  // null, or 2 + 5 (l1 - l0) stage-end timestamps (ns)
  const float* kcs;        // (L, B, Hkv, S) K column sums of the caches (chunk)
  const int8_t* sk;        // (L, B, Hkv, ncs, hd) staged K columns (chunk)
  const int8_t* sv;
  int8_t* h8;              // scratch (M, K) norm outputs (row kernels)
  float* sx;               // scratch (M,) dynamic head scales (row kernels)
  MqtStackedW4 qkv, o, w13, w2;
  int M, K, Hq, Hkv, hd, rot, S, F, Vp, L, l0, l1, gelu;
  int ln;                  // every norm LayerNorm (mean-centred, with a bias), else RMSNorm
  int ncs, mst;            // staged columns: allocated, valid (chunk)
  int qk_fq, pv_fq;        // the qk_bmm output / pv_bmm input fake-quant enables
  int hbits;               // the head's weight bits, 4 or 8 (with logits)
  float inv_sqrt_hd;
  float mlp_meta[46];      // MLP-block meta, then the o-tail's 14 entries
};

// the ctypes mirror in ops/mlp_block.py (FusedArgs) must lay out the same
static_assert(sizeof(MqtStackedW4) == 64, "MqtStackedW4 layout");
static_assert(offsetof(MqtFusedArgs, qkv) == 248, "MqtFusedArgs layout");
static_assert(offsetof(MqtFusedArgs, M) == 504, "MqtFusedArgs layout");
static_assert(offsetof(MqtFusedArgs, ln) == 556, "MqtFusedArgs layout");
static_assert(offsetof(MqtFusedArgs, inv_sqrt_hd) == 580, "MqtFusedArgs layout");
static_assert(offsetof(MqtFusedArgs, mlp_meta) == 584, "MqtFusedArgs layout");
static_assert(sizeof(MqtFusedArgs) == 768, "MqtFusedArgs layout");

namespace {

using namespace mqt;
using Args = MqtFusedArgs;
using W4 = MqtStackedW4;

constexpr int FT = 256;          // threads per block
constexpr int NW = FT / 32;      // warps per block
constexpr int META = 65;         // layer meta: 33 attention + 32 MLP entries
constexpr int AM = 33;           // offset of the MLP section
constexpr int CNT = 8192;        // tile arrival counters at the workspace head
constexpr int KV_CHUNK = 256;    // cache rows staged in shared memory at a time

__device__ __forceinline__ float fqm(float x, float s, float o, float qmax) {
  float q = rintf(x / s) + o;
  q = fminf(fmaxf(q, 0.0f), qmax);
  return qmax > 0.5f ? (q - o) * s : x;
}

__device__ __forceinline__ float quant_u8s(float x, float s, float o) {
  float q = rintf(x / s) + o;
  return fminf(fmaxf(q, 0.0f), 255.0f) - 128.0f;
}

// layer l's weight matrix of a stacked pack: kin/2 packed rows (WB 4) or kin
// rows (WB 8) of n bytes
template <int WB>
__device__ __forceinline__ const int8_t* layer_w(const W4& p, int l) {
  return p.wq + (size_t)l * (WB == 4 ? p.kin >> 1 : p.kin) * p.n;
}

// the fp32 affine bracket of layer l, column col
__device__ __forceinline__ float affine(const W4& p, int l, int acc, int col,
                                        float rowsum, float xs, float ox, float kox) {
  const size_t si = (size_t)l * p.s_l + (size_t)col * p.s_c;
  const size_t ci = (size_t)l * p.n + col;
  const float ow = __ldg(p.offset + si), sw = __ldg(p.scale + si);
  float y = (float)acc - ox * __ldg(p.colsum + ci) - ow * rowsum + kox * ow;
  y = y * (xs * sw);
  if (p.bias) y = y + __ldg(p.bias + ci);
  return y;
}

// Grid-wide barrier: arrival count bar[0] (back at zero after every use) and
// a generation word bar[1]. Needs every block resident (cooperative launch).
__device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Column map of a matvec tile: local column n < split is colA + n, else
// colB + (n - split); na / nb are the valid counts of the two parts.
struct Tile {
  int colA, colB, split, na, nb;
  __device__ __forceinline__ int gcol(int n) const {
    return n < split ? colA + n : colB + (n - split);
  }
  __device__ __forceinline__ bool valid(int n) const {
    return n < split ? n < na : (n - split) < nb;
  }
};

// Copy nbytes (a multiple of 16) of read-only rows into shared memory.
__device__ __forceinline__ void stage_rows(int8_t* dst, const int8_t* src, int nbytes) {
  __syncthreads();
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < (nbytes >> 4); i += FT) d4[i] = __ldg(s4 + i);
  __syncthreads();
}

// Block-wide fp64 sum and fp32 max (every thread gets the result).
__device__ __forceinline__ float block_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double t = 0.0;
  for (int w = 0; w < NW; ++w) t += scratch[w];
  return (float)t;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = scratch[0];
  for (int w = 1; w < NW; ++w) t = fmaxf(t, scratch[w]);
  return t;
}

// With a.trace set, block 0 stamps the global timer at the start and after
// every stage's barrier (every stage then ends in a barrier).
__device__ __forceinline__ void stamp(const Args& a, int i) {
  if (a.trace && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.trace[i] = t;
  }
}

template <typename KernelT>
int launch_coop(KernelT kern, const Args& a, int kmax, size_t smem, cudaStream_t st) {
  int dev = 0;
  cudaGetDevice(&dev);
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int occ = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, FT, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms * (occ < 2 ? occ : 2);
  Args acopy = a;
  void* params[] = {(void*)&acopy, (void*)&kmax};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(FT), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
