// Weight-only (W4A16 / W8A16) matmul: fp x (M, K) × an integer weight
// dequantized in registers -> fp32 (M, N)
//   out[m, n] = Σ_k x[m, k] · (q[k, n] − offset[g(k), n]) · scale[g(k), n] + bias[n]
//
// Replaces two kernels of mobilequant_tpu/ops/pallas_matmul.py:
//   * wonly_matmul_stacked (_wonly_kernel_stacked): x (M <= 8, K) × layer
//     `layer` of a stacked W4 / W8 pack, per-tensor, per-channel or grouped
//     scales — the weight-only decode matmul (runtime/wonly.py);
//   * w4a16_matmul (_w4a16_kernel): x (any M, K) × one W4 (K/2, N) matrix,
//     per-channel scales (L = 1, the M axis tiled by 8 on grid.z).
//
// Layouts (the JAX package's). W4: unsigned block nibbles, (K/2, N), N
// contiguous; packed row r holds k = r (low nibble) and k = r + K/2 (high
// nibble), 0..15. W8: shifted int8 (K, N). Scale / offset: an fp32 (G, N)
// plane per layer read through strides: per tensor (sn = 0), per channel
// (G = 1), grouped along K (G groups of K/G rows; for W4 the groups split at
// the nibble half, so G is even and the high rows read groups [G/2, G)).
// x: fp32 or bf16 rows; bias: fp32 (N,) per layer, or none.
//
// Bound: device-memory bytes. At M <= 8 the weight bytes dominate (a
// TinyLlama W4 g128 layer: 22.02 MB of nibbles and 2.75 MB of scales and
// offsets for 2·M·K·N flops). Design: each thread reads 16 bytes of one
// packed row along N (16 columns; a half-warp reads 256 contiguous bytes),
// 16 row slots a block over a K slice of at most 256 packed rows, so the
// block's x rows (low and high halves) are staged in shared memory once as
// fp32. The dequantization repeats the plain version's fp32 arithmetic per
// element ((q − o)·s, no contraction under --fmad=false; the small integer
// becomes a float exactly through the 2^23 bit pattern), and the M sums are
// explicit fma. Scales and offsets stay in registers while a thread's rows
// stay in one group. K splits over enough blocks to fill the card; each
// split writes its partial (M, 256) tile, and the last block of a column
// tile adds the splits in order, then the bias: no float atomics, so a call
// is deterministic. The layer is a pointer offset from an int argument.
#include "mqt_common.cuh"

namespace {

constexpr int WO_THREADS = 256;
constexpr int WO_SLOTS = 16;     // row slots of a block
constexpr int WO_COLS = 16;      // columns of a thread: 16 bytes of W4 / W8
constexpr int WO_TN = 256;       // columns of a block (16 threads x 16)
constexpr int WO_MAXR = 256;     // packed rows of a K split at most

struct WoArgs {
  const void* x;
  const uint8_t* wq;       // this layer's (K or K/2, N)
  const float* scale;      // this layer's plane
  const float* offset;
  const float* bias;       // this layer's (N,), or null
  float* out;
  float* part;             // (ks, M, N) split partials
  int* cnt;                // one self-cleaning counter a (column, row) tile
  int xbf16, sg, sn, gsz;  // gsz: K rows per group (K when not grouped)
  int M, K, N, Kr, rps, ks;
};

template <int MR>
struct WoSmem {
  union {
    float x[MR][2][WO_MAXR];          // the split's x rows: low / high half
    float red[WO_SLOTS][WO_TN + 1];   // per row slot column sums, one m at a time
  } u;
  int last;
};

__device__ __forceinline__ float ld_x(const WoArgs& a, int m, int k) {
  const size_t i = (size_t)m * a.K + k;
  if (a.xbf16)   // bf16 -> fp32 is exact: the high 16 bits of the float
    return __uint_as_float((uint32_t)((const uint16_t*)a.x)[i] << 16);
  return ((const float*)a.x)[i];
}

// 16 columns of a scale / offset row (sn = 0: one value for all)
__device__ __forceinline__ void ld16(const float* p, int sn, float v[WO_COLS]) {
  if (sn == 0) {
    const float s = __ldg(p);
#pragma unroll
    for (int c = 0; c < WO_COLS; ++c) v[c] = s;
    return;
  }
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < WO_COLS / 4; ++j) {
    const float4 t = __ldg(q + j);
    v[4 * j] = t.x;
    v[4 * j + 1] = t.y;
    v[4 * j + 2] = t.z;
    v[4 * j + 3] = t.w;
  }
}

// a small unsigned integer (< 2^23) as an exact float
__device__ __forceinline__ float u2f(uint32_t u) {
  return __uint_as_float(0x4B000000u | u) - 8388608.0f;
}

// grid (column tiles, K splits, row tiles of MR)
template <int BITS, int MR, bool GROUPED>
__global__ void __launch_bounds__(WO_THREADS)
wonly_kernel(const WoArgs a) {
  __shared__ WoSmem<MR> sm;
  const int tid = threadIdx.x, cx = tid & 15, ry = tid >> 4;
  const int n0 = blockIdx.x * WO_TN;
  const int col = n0 + cx * WO_COLS;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MR;
  const int mrows = min(MR, a.M - m0);
  const int r0 = split * a.rps, r1 = min(a.Kr, r0 + a.rps), nr = r1 - r0;
  const int half = a.K >> 1;
  const bool valid = col < a.N;

  for (int i = tid; i < MR * nr; i += WO_THREADS) {
    const int m = i / nr, j = i - m * nr;
    float lo = 0.0f, hi = 0.0f;
    if (m < mrows) {
      lo = ld_x(a, m0 + m, r0 + j);
      if (BITS == 4) hi = ld_x(a, m0 + m, half + r0 + j);
    }
    sm.u.x[m][0][j] = lo;
    if (BITS == 4) sm.u.x[m][1][j] = hi;
  }
  __syncthreads();

  float acc[MR][WO_COLS];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < WO_COLS; ++c) acc[m][c] = 0.0f;

  constexpr bool TWO = BITS == 4 && GROUPED;   // the high rows read other groups
  float slo[WO_COLS], olo[WO_COLS], shi[TWO ? WO_COLS : 1], ohi[TWO ? WO_COLS : 1];
  int gcur = -1;
  if (valid && !GROUPED) {
    ld16(a.scale + (size_t)col * a.sn, a.sn, slo);
    ld16(a.offset + (size_t)col * a.sn, a.sn, olo);
  }
  for (int r = r0 + ry; valid && r < r1; r += WO_SLOTS) {
    if (GROUPED) {
      const int g = r / a.gsz;
      if (g != gcur) {
        gcur = g;
        ld16(a.scale + (size_t)g * a.sg + (size_t)col * a.sn, a.sn, slo);
        ld16(a.offset + (size_t)g * a.sg + (size_t)col * a.sn, a.sn, olo);
        if (TWO) {
          const int gh = (r + half) / a.gsz;
          ld16(a.scale + (size_t)gh * a.sg + (size_t)col * a.sn, a.sn, shi);
          ld16(a.offset + (size_t)gh * a.sg + (size_t)col * a.sn, a.sn, ohi);
        }
      }
    }
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(a.wq + (size_t)r * a.N + col));
    const uint32_t w4[4] = {wv.x, wv.y, wv.z, wv.w};
    const int j = r - r0;
    float xl[MR], xh[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      xl[m] = sm.u.x[m][0][j];
      xh[m] = BITS == 4 ? sm.u.x[m][1][j] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < WO_COLS; ++c) {
      const uint32_t byte = (w4[c >> 2] >> (8 * (c & 3))) & 0xFFu;
      if (BITS == 8) {
        // the stored int8 value (uint8 − 128 for asymmetric packs)
        const float w = (u2f(byte ^ 0x80u) - 128.0f - olo[c]) * slo[c];
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[m][c] = __fmaf_rn(xl[m], w, acc[m][c]);
      } else {
        const float wl = (u2f(byte & 0x0Fu) - olo[c]) * slo[c];
        const float wh = TWO ? (u2f(byte >> 4) - ohi[TWO ? c : 0]) * shi[TWO ? c : 0]
                             : (u2f(byte >> 4) - olo[c]) * slo[c];
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          acc[m][c] = __fmaf_rn(xl[m], wl, acc[m][c]);
          acc[m][c] = __fmaf_rn(xh[m], wh, acc[m][c]);
        }
      }
    }
  }
  __syncthreads();            // the x rows are dead: the union turns into red

  // the 16 row slots' sums of one m at a time; thread t owns column n0 + t,
  // stored at red[.][(t % 16)·16 + t / 16]
  const int ncol = n0 + tid;
  const bool own = ncol < a.N;
  float tot[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    tot[m] = 0.0f;
    if (m < mrows) {
#pragma unroll
      for (int c = 0; c < WO_COLS; ++c) sm.u.red[ry][c * 16 + cx] = acc[m][c];
      __syncthreads();
      const int p = (tid & 15) * 16 + (tid >> 4);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < WO_SLOTS; ++i) s += sm.u.red[i][p];
      tot[m] = s;
      __syncthreads();
    }
  }
  if (a.ks > 1) {
    if (own)
      for (int m = 0; m < mrows; ++m)
        a.part[((size_t)split * a.M + m0 + m) * a.N + ncol] = tot[m];
    __threadfence();
    __syncthreads();
    int* cnt = a.cnt + blockIdx.z * gridDim.x + blockIdx.x;
    if (tid == 0) sm.last = atomicAdd(cnt, 1) == a.ks - 1;
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    if (own)
      for (int m = 0; m < mrows; ++m) {
        float s = 0.0f;
        for (int sp = 0; sp < a.ks; ++sp)
          s += __ldcg(&a.part[((size_t)sp * a.M + m0 + m) * a.N + ncol]);
        tot[m] = s;
      }
    if (tid == 0) *cnt = 0;
  }
  if (own)
#pragma unroll
    for (int m = 0; m < MR; ++m)
      if (m < mrows)
        a.out[(size_t)(m0 + m) * a.N + ncol] = a.bias ? tot[m] + a.bias[ncol] : tot[m];
}

template <int BITS, int MR>
void launch(const WoArgs& a, bool grouped, dim3 grid, cudaStream_t st) {
  if (grouped) wonly_kernel<BITS, MR, true><<<grid, WO_THREADS, 0, st>>>(a);
  else wonly_kernel<BITS, MR, false><<<grid, WO_THREADS, 0, st>>>(a);
}

template <int BITS>
void launch_bits(const WoArgs& a, int mr, bool grouped, dim3 grid, cudaStream_t st) {
  if (mr <= 1) launch<BITS, 1>(a, grouped, grid, st);
  else if (mr <= 2) launch<BITS, 2>(a, grouped, grid, st);
  else if (mr <= 4) launch<BITS, 4>(a, grouped, grid, st);
  else launch<BITS, 8>(a, grouped, grid, st);
}

}  // namespace

// x (M, K) fp32 (xbf16 = 0) or bf16 (1); wq the stacked (L, K/2, N) W4 or
// (L, K, N) W8 bytes (bits 4 / 8); scale / offset fp32 with layer stride sl,
// group stride sg and column stride sn (0: per tensor), `groups` groups
// along K (1: not grouped); bias fp32 (L, N) or null; out (M, N) fp32; part
// a float workspace of ks·M·N; cnt an int workspace of ceil(N/256)·
// ceil(M/8) zeros (left zero again). The K split: ks splits of rps packed
// rows (rps % 16 == 0, rps <= 256). N % 16 == 0; the grid's row tile is 8
// rows above M = 8.
MQT_EXPORT int mqt_wonly_matmul(const void* x, int xbf16, const void* wq, int bits,
                                const void* scale, const void* offset, int sl, int sg,
                                int sn, int groups, const void* bias, void* out,
                                void* part, void* cnt, int M, int K, int N, int layer,
                                int rps, int ks, void* stream) {
  const int Kr = bits == 4 ? K / 2 : K;
  if (M < 1 || K < 2 || N % 16 || (bits != 4 && bits != 8) || groups < 1 || K % groups
      || (bits == 4 && (K % 2 || (groups > 1 && groups % 2))) || rps % 16 || rps > WO_MAXR
      || rps < 16 || ks < 1 || (long long)rps * ks < Kr || (long long)rps * (ks - 1) >= Kr)
    return (int)cudaErrorInvalidValue;
  WoArgs a;
  a.x = x;
  a.wq = (const uint8_t*)wq + (size_t)layer * Kr * N;
  a.scale = (const float*)scale + (size_t)layer * sl;
  a.offset = (const float*)offset + (size_t)layer * sl;
  a.bias = bias ? (const float*)bias + (size_t)layer * N : nullptr;
  a.out = (float*)out;
  a.part = (float*)part;
  a.cnt = (int*)cnt;
  a.xbf16 = xbf16;
  a.sg = sg;
  a.sn = sn;
  a.gsz = K / groups;
  a.M = M;
  a.K = K;
  a.N = N;
  a.Kr = Kr;
  a.rps = rps;
  a.ks = ks;
  const int mr = M < 8 ? M : 8;
  dim3 grid((N + WO_TN - 1) / WO_TN, ks, (M + 7) / 8);
  const bool grouped = groups > 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 4) launch_bits<4>(a, mr, grouped, grid, st);
  else launch_bits<8>(a, mr, grouped, grid, st);
  return (int)cudaGetLastError();
}
