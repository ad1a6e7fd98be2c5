// The int8 tensor-core tile core: a 64-row x 128-column W4A8 / W8A8 tile on
// mma.sync.m16n8k32 (s8 x s8 -> s32), fed by a four-stage cp.async ring of
// activation and weight chunks: the port's one int8 tile core. w13_gate.cu,
// qkv_rope.cu, the matvec stages of the row kernels (fused_rows.cuh) and
// tc_matmul_kernel below (w4a8_matmul.cu above 8 rows, w8a8_matmul.cu at
// every row count) run it.
//
// A chunk is 64 packed rows j0.. (W4: low nibbles k = j0.., high nibbles
// k = K/2 + j0..; W8: rows j0.. and K/2 + j0.., twice the bytes), so both
// editions share the activation chunk: per tile row, 64 bytes of k = j0..
// then 64 of k = K/2 + j0.. (one 128-byte shared row). The integer sum is
// exact in any k order; only the pairing of x[k] with w[k] matters.
//
// Shared layouts (no bank conflicts on the fragment loads):
//   x chunk: row r's 16-byte unit u at unit u ^ (r & 7) (ldmatrix reads 8
//     consecutive rows of one unit);
//   w chunk: packed row r (W8: then the K/2 rows at 64 + r) of 128 bytes,
//     unit u at u ^ (2·((r >> 2) & 3)) (lane (g, t) reads rows 4t..4t+3 of
//     word column g of its warp's 32 columns).
// The B fragments come from the weights as stored: lane (g, t) loads the 4
// rows 4t.. (and 16 + 4t..) of columns 4g..4g+3, transposes them in
// registers (transpose4x4), and so holds column 4g + c of n8 tile c, k 4t..
// 4t+3: the four n8 tiles of a warp cover its 32 columns with mma column n
// = tile column 4n + c. W4 nibbles are unpacked there, once per chunk.
//
// Warps: 2 (32 rows each, two 16-row A blocks) x 4 (32 columns each).
#pragma once

#include <cooperative_groups.h>

#include "mqt_common.cuh"

namespace mqt {

constexpr int TC_BM = 64;            // tile rows
constexpr int TC_BN = 128;           // tile columns
constexpr int TC_KP = 64;            // packed rows a chunk
constexpr int TC_THREADS = 256;
constexpr int TC_STAGES = 4;
constexpr int TC_XB = TC_BM * 128;   // activation chunk bytes

template <int WB>
__host__ __device__ constexpr int tc_stage_bytes() {
  return TC_XB + (WB == 4 ? 1 : 2) * TC_KP * TC_BN;
}
template <int WB>
__host__ __device__ constexpr int tc_smem_bytes() { return TC_STAGES * tc_stage_bytes<WB>(); }

struct TcAcc {
  int d[2][4][4];   // [16-row block][n8 tile][fragment]
  int rs[2];        // row-sum partials of rows tid / 8 and 32 + tid / 8
};

// (row, column) of fragment e of d[mt][c] in the tile
__device__ __forceinline__ int tc_row(int mt, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp >> 2) * 32 + mt * 16 + (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int tc_col(int c, int e) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return (warp & 3) * 32 + 4 * (2 * (lane & 3) + (e & 1)) + c;
}

// 4 bytes global -> shared (through L1: cp.async.cg copies 16 only); pred
// false fills them with zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

// Issue the cp.async copies of chunk ch (rows past M, packed rows past K/2
// and invalid column units are zero-filled). V16: the weight rows are
// 16-byte aligned (N % 16 == 0) and the tile's valid column counts (cm.na,
// cm.nb) multiples of 16, so weights move in 16-byte units; else (N % 4 == 0
// only) in 4-byte units into the same layout, the counts multiples of 4.
template <int WB, bool V16>
__device__ __forceinline__ void tc_load(int8_t* st, const int8_t* __restrict__ x,
                                        const int8_t* __restrict__ w, int M, int K, int N,
                                        int m0, const ColMap& cm, int ch) {
  const int K2 = K >> 1, j0 = ch * TC_KP;
  for (int i = threadIdx.x; i < TC_BM * 8; i += TC_THREADS) {
    const int r = i >> 3, u = i & 7, kk = j0 + 16 * (u & 3);
    const bool ok = m0 + r < M && kk < K2;
    const int8_t* src = ok ? x + (size_t)(m0 + r) * K + (u < 4 ? 0 : K2) + kk : x;
    cp_async16(st + r * 128 + ((u ^ (r & 7)) << 4), src, ok);
  }
  constexpr int WR = WB == 4 ? TC_KP : 2 * TC_KP;
  int8_t* ws = st + TC_XB;
  if constexpr (V16) {
    for (int i = threadIdx.x; i < WR * 8; i += TC_THREADS) {
      const int r = i >> 3, u = i & 7, j = j0 + (r & (TC_KP - 1));
      const bool ok = j < K2 && cm.valid(16 * u);
      const int8_t* src = ok ? w + (size_t)((r < TC_KP ? 0 : K2) + j) * N + cm.gcol(16 * u) : w;
      cp_async16(ws + r * 128 + ((u ^ (((r >> 2) & 3) << 1)) << 4), src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < WR * 32; i += TC_THREADS) {
      const int r = i >> 5, n = 4 * (i & 31), j = j0 + (r & (TC_KP - 1));
      const bool ok = j < K2 && cm.valid(n);
      const int8_t* src = ok ? w + (size_t)((r < TC_KP ? 0 : K2) + j) * N + cm.gcol(n) : w;
      cp_async4(ws + r * 128 + (((n >> 4) ^ (((r >> 2) & 3) << 1)) << 4) + (n & 15), src, ok);
    }
  }
}

// acc += the chunk in stage st. SKIP: a warp skips the products of its
// 16-row blocks at or past `rows` (the tile's valid rows: zeros, never read);
// the row kernels take it (tiles of 16-32 valid rows at B = 16, 32), the
// prefill tiles do not (the branches slowed their full tiles 1-10% on an H100)
template <int WB, bool SKIP>
__device__ __forceinline__ void tc_chunk(const int8_t* st, TcAcc& acc, int rows) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int8_t* ws = st + TC_XB;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int r = (tid >> 3) + 32 * p;
    const int4 v = *reinterpret_cast<const int4*>(st + r * 128 + 16 * (tid & 7));
    acc.rs[p] = __dp4a(v.w, 0x01010101, __dp4a(v.z, 0x01010101,
                __dp4a(v.y, 0x01010101, __dp4a(v.x, 0x01010101, acc.rs[p]))));
  }
  const int wofs = ((((2 * wn + (g >> 2)) ^ (t << 1))) << 4) + 4 * (g & 3);
  if (SKIP && wm * 32 >= rows) return;
#pragma unroll
  for (int s = 0; s < 2; ++s) {                  // two k32 steps of packed rows
    int bl[2][4], bh[2][4];                      // [b0 / b1][n8 tile]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int rw[4], cw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rw[i] = *reinterpret_cast<const int*>(ws + (s * 32 + 16 * h + 4 * t + i) * 128 + wofs);
      transpose4x4(rw, cw);
      if constexpr (WB == 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          bl[h][c] = cw[c] & (int)NIB;
          bh[h][c] = (int)(((unsigned)cw[c] >> 4) & NIB);
        }
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) bl[h][c] = cw[c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[i] = *reinterpret_cast<const int*>(
              ws + (TC_KP + s * 32 + 16 * h + 4 * t + i) * 128 + wofs);
        transpose4x4(rw, bh[h]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (SKIP && wm * 32 + mt * 16 >= rows) continue;
      const int R = wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int U = 2 * s + (lane >> 4);
      int al[4], ah[4];
      ldsm_x4(al, st + R * 128 + ((U ^ (R & 7)) << 4));
      ldsm_x4(ah, st + R * 128 + (((U + 4) ^ (R & 7)) << 4));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mma_s8(acc.d[mt][c], al[0], al[1], al[2], al[3], bl[0][c], bl[1][c]);
        mma_s8(acc.d[mt][c], ah[0], ah[1], ah[2], ah[3], bh[0][c], bh[1][c]);
      }
    }
  }
}

// acc = x[m0.., chunks [c0, c1)] · W[., tile columns] over the ring in smem
// (tc_smem_bytes<WB>() bytes); rsum[r] gets the tile rows' partial row sums
// over the same chunks. Ends with the ring free (every copy landed, every
// thread past its last read). V16: as tc_load; SKIP: as tc_chunk.
template <int WB, bool V16 = true, bool SKIP = false>
__device__ void tc_tile(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int M,
                        int K, int N, int m0, const ColMap& cm, int c0, int c1,
                        int8_t* smem, int* rsum, TcAcc& acc) {
  constexpr int SB = tc_stage_bytes<WB>();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.d[mt][c][e] = 0;
  acc.rs[0] = acc.rs[1] = 0;
#pragma unroll
  for (int p = 0; p < TC_STAGES - 1; ++p) {
    if (c0 + p < c1) tc_load<WB, V16>(smem + p * SB, x, w, M, K, N, m0, cm, c0 + p);
    cp_async_commit();
  }
  for (int ch = c0; ch < c1; ++ch) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    // the stage of chunk ch - 1, which every thread has finished reading
    const int nx = ch + TC_STAGES - 1;
    if (nx < c1)
      tc_load<WB, V16>(smem + ((nx - c0) % TC_STAGES) * SB, x, w, M, K, N, m0, cm, nx);
    cp_async_commit();
    tc_chunk<WB, SKIP>(smem + ((ch - c0) % TC_STAGES) * SB, acc, M - m0);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    int v = acc.rs[p];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if ((threadIdx.x & 7) == 0) rsum[(threadIdx.x >> 3) + 32 * p] = v;
  }
  __syncthreads();
}

// Split-K meeting of tc_tile partials through a self-cleaning int32
// workspace (w13_gate.cu), all zero between launches: arrival counters
// [0, ntiles), row sums [ntiles, 65 ntiles), accumulators (M, Nws) from
// 65 ntiles. Every block adds its partials; the last block of the tile reads
// the totals back into acc / rsum and zeroes what it read. False in every
// other block.
__device__ __forceinline__ bool tc_workspace_reduce(int* ws, int ntiles, int tile, int M,
                                                 int Nws, int m0, const ColMap& cm,
                                                 TcAcc& acc, int* rsum, int* last, int ks) {
  int* cnt = ws;
  int* wrs = ws + ntiles + tile * TC_BM;
  int* wacc = ws + 65 * ntiles;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + tc_row(mt, e), n = tc_col(c, e);
        if (gm < M && cm.valid(n)) atomicAdd(&wacc[(size_t)gm * Nws + cm.gcol(n)], acc.d[mt][c][e]);
      }
  if (threadIdx.x < TC_BM) atomicAdd(&wrs[threadIdx.x], rsum[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = (atomicAdd(&cnt[tile], 1) == ks - 1);
  __syncthreads();
  if (!*last) return false;
  __threadfence();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + tc_row(mt, e), n = tc_col(c, e);
        if (gm >= M || !cm.valid(n)) continue;
        int* p = &wacc[(size_t)gm * Nws + cm.gcol(n)];
        acc.d[mt][c][e] = __ldcg(p);
        *p = 0;
      }
  __syncthreads();
  if (threadIdx.x < TC_BM) {
    rsum[threadIdx.x] = __ldcg(&wrs[threadIdx.x]);
    wrs[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) cnt[tile] = 0;
  __syncthreads();
  return true;
}

// The K splits of a tile as one thread-block cluster (rows 1-3 and 14;
// cluster dims (1, 1, ks), ks <= TC_MAX_KS, the portable limit): each block
// stages its partial tile (tc_stage) and keeps its row sums (tc_tile's rsum)
// in its shared memory; tc_cluster_reduce then gives block z the totals of
// rows z, z + ks, ... below `rows` (tc_rows_of: the tile's valid rows, or
// all 64), summed over every split's shared memory (DSMEM), written over its
// own staged rows, which no other block reads. Integer sums are exact in any
// order. No workspace, no atomics.
constexpr int TC_MAX_KS = 8;
constexpr int TC_LD = TC_BN + 1;    // staged row stride (ints): conflict-free fragment stores

// the fragments as a 64 x TC_BN int tile, row stride TC_LD, in the free ring
__device__ __forceinline__ void tc_stage(const TcAcc& acc, int* st) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[tc_row(mt, e) * TC_LD + tc_col(c, e)] = acc.d[mt][c][e];
  __syncthreads();
}

// the rows a block of split z of ks finishes: z, z + ks, ... (< rows <= TC_BM)
__device__ __forceinline__ int tc_rows_of(int z, int ks, int rows = TC_BM) {
  return (rows - z + ks - 1) / ks;
}

__device__ __forceinline__ void tc_cluster_reduce(int* st, int* rsum, int ks,
                                                  int rows = TC_BM) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int z = (int)cluster.block_rank(), nr = tc_rows_of(z, ks, rows), nel = nr * TC_BN;
  cluster.sync();                    // every split's tile staged
  constexpr int U = 4;               // elements a thread has in flight
  for (int i0 = threadIdx.x; i0 < nel; i0 += U * TC_THREADS) {
    int v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * TC_THREADS, off = (z + ks * (i / TC_BN)) * TC_LD + i % TC_BN;
      v[u] = 0;
#pragma unroll
      for (int s = 0; s < TC_MAX_KS; ++s)
        if (i < nel && s < ks) v[u] += cluster.map_shared_rank(st, s)[off];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * TC_THREADS;
      if (i < nel) st[(z + ks * (i / TC_BN)) * TC_LD + i % TC_BN] = v[u];
    }
  }
  if (threadIdx.x < nr) {
    const int r = z + ks * threadIdx.x;
    int v = 0;
#pragma unroll
    for (int s = 0; s < TC_MAX_KS; ++s)
      if (s < ks) v += cluster.map_shared_rank(rsum, s)[r];
    rsum[r] = v;
  }
  cluster.sync();                    // every block past its reads of the others
}

// Launch tile kernel K whose K splits (grid.z <= TC_MAX_KS) are one cluster.
template <auto K, typename... A>
int tc_launch_cluster(dim3 grid, int smem, cudaStream_t st, A... args) {
  static bool set = false;   // the shared-memory opt-in, once per kernel
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, K, args...);
}

// x (M, K) × W -> fp32 out (M, N) through the affine epilogue, W a W4
// (K/2, N) nibble or a W8 (K, N) int8 matrix: the tile matmul of rows 1 / 2
// above 8 rows (WB 4) and of row 14 (WB 8). Grid (column tiles, row tiles,
// K splits of cps chunks); the splits of a tile are one cluster
// (tc_launch_cluster) and meet in shared memory; block z then finishes the
// tile's valid rows z, z + ks, ..., consecutive threads on consecutive
// columns. SKIP: tc_chunk's row skip (row 14's tiles hold 1-32 valid rows
// on its decode route).
template <int WB, bool V16, bool SKIP>
__global__ void __launch_bounds__(TC_THREADS, 2)
tc_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Affine aff,
                 float* __restrict__ out, int M, int K, int N, int cps) {
  extern __shared__ int4 ring_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(ring_raw);
  int* st = reinterpret_cast<int*>(ring_raw);
  __shared__ int rsum[TC_BM];
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
  const int ks = gridDim.z, z = blockIdx.z, rows = min(TC_BM, M - m0);
  const int nchunks = ((K >> 1) + TC_KP - 1) / TC_KP;
  const int c0 = z * cps, c1 = min(nchunks, c0 + cps);
  const ColMap cm{n0, 0, TC_BN, min(TC_BN, N - n0), 0};
  TcAcc acc;
  tc_tile<WB, V16, SKIP>(x, w, M, K, N, m0, cm, c0, c1, ring, rsum, acc);
  tc_stage(acc, st);
  if (ks > 1) tc_cluster_reduce(st, rsum, ks, rows);
  const int nel = tc_rows_of(z, ks, rows) * TC_BN;
  for (int i = threadIdx.x; i < nel; i += TC_THREADS) {
    const int r = z + ks * (i / TC_BN), n = i % TC_BN;
    if (cm.valid(n))
      out[(size_t)(m0 + r) * N + n0 + n] = aff(st[r * TC_LD + n], n0 + n, (float)rsum[r]);
  }
}

// Launch tc_matmul_kernel on the caller's plan: ks splits (one cluster) of
// cps chunks a column tile (ops/w4a8_matmul.tile_plan). A width N % 16 != 0
// (rows not 16-byte aligned) takes the 4-byte-copy edition.
template <int WB, bool SKIP>
int tc_matmul(const int8_t* x, const int8_t* w, Affine aff, float* out, int M, int K, int N,
              int ks, int cps, cudaStream_t st) {
  const int nchunks = ((K >> 1) + TC_KP - 1) / TC_KP;
  if (M < 1 || ks < 1 || ks > TC_MAX_KS || cps < 1 || (ks - 1) * cps >= nchunks
      || ks * cps < nchunks || N % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TC_BN - 1) / TC_BN, (M + TC_BM - 1) / TC_BM, ks);
  constexpr int smem = tc_smem_bytes<WB>();
  if (N % 16)
    return tc_launch_cluster<tc_matmul_kernel<WB, false, SKIP>>(grid, smem, st, x, w, aff, out,
                                                                M, K, N, cps);
  if ((uintptr_t)w % 16) return (int)cudaErrorMisalignedAddress;
  return tc_launch_cluster<tc_matmul_kernel<WB, true, SKIP>>(grid, smem, st, x, w, aff, out, M,
                                                             K, N, cps);
}

// The split of nchunks over ks blocks: one split once the tiles fill the SMs,
// else about two blocks an SM with at least two chunks a split.
inline void tc_pick_split(int tiles, int nchunks, int& ks, int& cps) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  ks = 1;
  if (tiles < sms) {
    ks = (2 * sms + tiles - 1) / tiles;
    const int cap = nchunks / 2 > 1 ? nchunks / 2 : 1;
    if (ks > cap) ks = cap;
  }
  cps = (nchunks + ks - 1) / ks;
  ks = (nchunks + cps - 1) / cps;
}

}  // namespace mqt
