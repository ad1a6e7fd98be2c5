// W8A8 matmul for decode-sized rows: shifted-int8 x (M <= 32, K) × W8 (K, N)
//   -> fp32 (M, N) = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum + K·o'_x·o_w] + bias
//
// Replaces mobilequant_tpu/ops/pallas_matmul.py: w8a8_matmul (_w8a8_kernel).
// The JAX engine sends W8 projections of at most 32 rows here under its
// "all" kernel set; the wrapper's stacked form is a layer offset on the
// weight pointer, taken by the caller: no copy.
//
// W8 layout: the JAX package's shifted int8 (K, N), N contiguous (uint8 − 128
// with the zero-point shifted the same way for asymmetric packs); scale and
// offset per tensor (stride 0) or per column.
//
// Bound: device-memory bytes. At M <= 32 the K·N weight bytes dominate (the
// int8 work is 2·M·K·N operations, far below the tensor cores' rate for the
// bytes read). The M <= 8 path streams every weight byte once, coalesced
// along N (a warp reads 128 contiguous bytes of a row), puts 4 consecutive k
// of one column in one word with a 4x4 byte transpose for __dp4a and splits
// K over enough blocks to fill the card; int32 partials meet in the
// self-cleaning workspace and the last block of a column tile runs the
// epilogue. 8 < M <= 32 runs the W8 edition of the shared 64 x 128 dp4a tile
// core (mqt_common.cuh) with split-K.
#include "mqt_common.cuh"

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

// Grid (column tiles, K splits); block: 8 warps over 4-row groups of W, each
// lane 4 adjacent columns.
template <int MR>
__global__ void __launch_bounds__(GV_THREADS)
w8a8_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 Affine aff, float* __restrict__ out, int* ws, int M, int K,
                 int N, int ks, int gpb) {
  __shared__ GemvSmem<MR> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int ntiles = gridDim.x;
  const int ngroups = K >> 2;
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
      const int xv = ld_i32(x + (size_t)m * K + 4 * g);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[m][cc] = __dp4a(c[cc], xv, acc[m][cc]);
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
    int* wacc = ws + 65 * ntiles;   // the tile kernels' workspace layout
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
  // full row sums of x
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

// 8 < M <= 32: the W8 edition of the shared tile core, split-K
__global__ void __launch_bounds__(TTHREADS)
w8a8_tile_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 Affine aff, float* __restrict__ out, int* ws, int M, int K,
                 int N, int ks, int cps) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ntn = gridDim.x;
  const int tile = blockIdx.y * ntn + blockIdx.x;
  const int ntiles = ntn * gridDim.y;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int nchunks = (K >> 1) / TBKP;
  const int c0 = blockIdx.z * cps, c1 = min(nchunks, c0 + cps);
  ColMap cm{n0, 0, TBN, min(TBN, N - n0), 0};
  int acc[4][8] = {};
  int rs = 0;
  tile_mma<8>(x, w, M, K, N, m0, cm, c0, c1, sm, acc, rs);
  if (!splitk_reduce(ws, ntiles, tile, ks, M, N, m0, cm, sm, acc, rs)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i, gm = m0 + m;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nl = tx + 16 * j;
      if (!cm.valid(nl)) continue;
      out[(size_t)gm * N + n0 + nl] = aff(acc[i][j], n0 + nl, (float)sm.rsum[m]);
    }
  }
}

template <int MR>
void launch_gemv(const int8_t* x, const int8_t* w, Affine aff, float* out, int* ws,
                 int M, int K, int N, cudaStream_t st) {
  const int tiles = (N + GV_COLS - 1) / GV_COLS;
  const int ngroups = K >> 2;
  int ks, gpb;
  // four blocks per SM, at least one 4-row group per warp and block
  pick_split(2 * tiles, ngroups, 8, ks, gpb);
  dim3 grid(tiles, ks);
  w8a8_gemv_kernel<MR><<<grid, GV_THREADS, 0, st>>>(x, w, aff, out, ws, M, K, N, ks, gpb);
}

}  // namespace

// ws: an int32 split-K workspace of at least 65·ceil(N/128)·ceil(M/64) + M·N
// ints, all zero (the kernel leaves it zero again). K % 64 == 0, N % 4 == 0,
// 1 <= M <= 32.
MQT_EXPORT int mqt_w8a8_matmul(const void* x, const void* w, const void* scale,
                               const void* offset, const void* colsum,
                               const void* bias, void* out, void* ws, int M,
                               int K, int N, int sstride, float x_scale,
                               float x_offset, void* stream) {
  if (M < 1 || M > 32 || K % 64 || N % 4) return (int)cudaErrorInvalidValue;
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
  else {
    const int tn = (N + TBN - 1) / TBN, tm = (M + TBM - 1) / TBM;
    const int nchunks = (K >> 1) / TBKP;
    int ks, cps;
    pick_split(tn * tm, nchunks, 4, ks, cps);
    dim3 grid(tn, tm, ks);
    w8a8_tile_kernel<<<grid, TTHREADS, 0, st>>>(xp, wp, aff, op, wsp, M, K, N, ks, cps);
  }
  return (int)cudaGetLastError();
}
