// W4A8 matmul: shifted-int8 x (M, K) × unsigned-block-nibble W4 (K/2, N)
//   -> fp32 (M, N) = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum + K·o'_x·o_w] + bias
//
// Replaces mobilequant_tpu/ops/pallas_matmul.py: w4a8_matmul (_w4a8_kernel)
// and w4a8_matmul_stacked (_w4a8_kernel_stacked). The stacked form is a layer
// offset on the weight pointer, taken by the caller: no copy.
//
// Bound: at decode (M <= 8) the packed weight bytes (K/2·N) dominate, so the
// kernel is bound by device-memory bandwidth. The M <= 8 path streams every
// weight byte once, coalesced along N (a warp reads 128 contiguous bytes of a
// packed row), unpacks nibbles in registers (a 4x4 byte transpose puts 4
// consecutive k of one column in one word for __dp4a) and splits K over
// enough blocks to fill the card; int32 partials meet in a self-cleaning
// workspace, the last block of a column tile runs the epilogue. At prefill
// (M > 8) the work is integer operations: the int8 tensor-core tile core
// (tc_tile.cuh: mma.sync m16n8k32 on 64 x 128 tiles over a four-stage
// cp.async ring, the nibbles unpacked in registers), split over K by the
// caller's plan (ops/w4a8_matmul.tile_plan) where the tiles leave SMs idle:
// tc_matmul_kernel, whose K splits of a tile are one thread-block cluster
// and meet in shared memory (tc_cluster_reduce), each block finishing a
// share of the tile's rows. Weight rows whose width is not a multiple of 16
// bytes take the tile's 4-byte-copy edition (V16 false).
#include "tc_tile.cuh"

namespace {

using namespace mqt;

constexpr int GV_THREADS = 256;   // 8 warps along K
constexpr int GV_COLS = 128;      // 32 lanes x 4 columns

template <int MR>
struct GemvSmem {
  int red[8][MR][GV_COLS];
  int rsum[MR];
  int last;
};

template <int MR>
__global__ void __launch_bounds__(GV_THREADS)
w4a8_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 Affine aff, float* __restrict__ out, int* ws, int M, int K,
                 int N, int ks, int gpb) {
  __shared__ GemvSmem<MR> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int ntiles = gridDim.x;
  const int K2 = K >> 1, ngroups = K2 >> 2;
  const int n = tile * GV_COLS + lane * 4;
  const bool valid = n < N;
  const int g0 = split * gpb;
  const int g1 = min(ngroups, g0 + gpb);

  int acc[MR][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

#pragma unroll 2
  for (int g = g0 + warp; g < g1; g += 8) {
    int r[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = valid ? ld_i32(w + (size_t)(4 * g + i) * N + n) : 0;
    transpose4x4(r, c);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= M) break;
      const int xl = ld_i32(x + (size_t)m * K + 4 * g);
      const int xh = ld_i32(x + (size_t)m * K + K2 + 4 * g);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        acc[m][cc] = __dp4a(c[cc] & (int)NIB, xl, acc[m][cc]);
        acc[m][cc] = __dp4a((int)(((unsigned)c[cc] >> 4) & NIB), xh, acc[m][cc]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) sm.red[warp][m][lane * 4 + cc] = acc[m][cc];
  if (tid < MR) sm.rsum[tid] = 0;
  __syncthreads();

  // thread t < 128 owns column tile*128 + t
  int tot[MR];
  const int t = tid;
  const int col = tile * GV_COLS + t;
  const bool own = t < GV_COLS && col < N;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    tot[m] = 0;
    if (t < GV_COLS)
#pragma unroll
      for (int wv = 0; wv < 8; ++wv) tot[m] += sm.red[wv][m][t];
  }
  if (ks > 1) {
    int* cnt = ws;
    int* wacc = ws + 65 * ntiles;   // tc_workspace_reduce's layout
    if (own)
      for (int m = 0; m < M; ++m) atomicAdd(&wacc[(size_t)m * N + col], tot[m]);
    __threadfence();
    __syncthreads();
    if (tid == 0) sm.last = (atomicAdd(&cnt[tile], 1) == ks - 1);
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    if (own)
      for (int m = 0; m < M; ++m) {
        int* p = &wacc[(size_t)m * N + col];
        tot[m] = __ldcg(p);
        *p = 0;
      }
    if (tid == 0) cnt[tile] = 0;
  }
  // full row sums of x (K <= a few thousand bytes per row, cached)
  for (int m = 0; m < M; ++m) {
    int s = 0;
    for (int k4 = tid; k4 < (K >> 2); k4 += GV_THREADS)
      s = __dp4a(ld_i32(x + (size_t)m * K + 4 * k4), 0x01010101, s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) atomicAdd(&sm.rsum[m], s);
  }
  __syncthreads();
  if (own)
    for (int m = 0; m < M; ++m)
      out[(size_t)m * N + col] = aff(tot[m], col, (float)sm.rsum[m]);
}

template <int MR>
void launch_gemv(const int8_t* x, const int8_t* w, Affine aff, float* out, int* ws,
                 int M, int K, int N, cudaStream_t st) {
  const int tiles = (N + GV_COLS - 1) / GV_COLS;
  const int ngroups = (K >> 1) >> 2;
  int ks, gpb;
  // four blocks per SM, at least one 4-row group per warp and block
  pick_split(2 * tiles, ngroups, 8, ks, gpb);
  dim3 grid(tiles, ks);
  w4a8_gemv_kernel<MR><<<grid, GV_THREADS, 0, st>>>(x, w, aff, out, ws, M, K, N, ks, gpb);
}

}  // namespace

// ws: the decode path's int32 split-K workspace (M <= 8) of at least
// 65·ceil(N/128) + M·N ints, all zero (the kernel leaves it zero again). ks,
// cps: the tile path's K split (M > 8): ks blocks of cps 64-packed-row
// chunks a column tile, one thread-block cluster (ops/w4a8_matmul.tile_plan).
MQT_EXPORT int mqt_w4a8_matmul(const void* x, const void* w, const void* scale,
                               const void* offset, const void* colsum,
                               const void* bias, void* out, void* ws, int M,
                               int K, int N, int sstride, float x_scale,
                               float x_offset, int ks, int cps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Affine aff;
  aff.scale = (const float*)scale;
  aff.offset = (const float*)offset;
  aff.colsum = (const float*)colsum;
  aff.bias = (const float*)bias;
  aff.sstride = sstride;
  aff.xs = x_scale;
  aff.ox = x_offset - 128.0f;
  aff.kox = (float)K * aff.ox;
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  float* op = (float*)out;
  int* wsp = (int*)ws;
  if (M <= 1) launch_gemv<1>(xp, wp, aff, op, wsp, M, K, N, st);
  else if (M <= 2) launch_gemv<2>(xp, wp, aff, op, wsp, M, K, N, st);
  else if (M <= 4) launch_gemv<4>(xp, wp, aff, op, wsp, M, K, N, st);
  else if (M <= 8) launch_gemv<8>(xp, wp, aff, op, wsp, M, K, N, st);
  else return tc_matmul<4, false>(xp, wp, aff, op, M, K, N, ks, cps, st);
  return (int)cudaGetLastError();
}
