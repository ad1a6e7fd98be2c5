// Pieces shared by the two decode attention kernels (decode_attention.cu,
// kv4_attention.cu), which split the cache positions of one (sequence, kv
// head) over a thread-block cluster: the P·V thread layout, the statistics a
// block shows the cluster, a thread's q row and int8 row dots, reductions
// over the lanes, warps and blocks that hold one query head's values, the
// fold of the warps' P·V partials, exact int -> fp64 conversions, and the
// cluster launch.
//
// Every reduction here is either exact (max, fp64 sums of values exact in
// fp64 whose order moves the sum by far less than an fp32 step) or done in a
// fixed order (warps in index order, blocks in rank order), so every block of
// a cluster computes the same statistic and a launch is deterministic.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "mqt_common.cuh"

namespace mqt {
namespace dc {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;       // blocks a (sequence, kv head): Hopper's portable limit

using Cluster = cooperative_groups::cluster_group;

// The largest divisor of g that is at most cap.
__host__ __device__ constexpr int divisor_upto(int g, int cap) {
  int d = cap < g ? cap : g;
  while (g % d) --d;
  return d;
}

// P·V: lanes along hd (DPT values a lane), warps along the positions; a
// thread keeps fp64 partials of GPT query heads (the largest divisor of G
// with GPT·DPT <= 32), the heads split over NGW warp groups; NCW warps a
// group.
template <int G, int HD>
struct PvLayout {
  static_assert(HD == 64 || HD == 128 || HD == 256, "hd 64, 128 or 256");
  static_assert(G >= 1 && G <= 16, "G <= 16");
  static constexpr int DPT = HD / 32;
  static constexpr int GPT = divisor_upto(G, 32 / DPT);
  static constexpr int NGW = G / GPT;
  static_assert(WARPS % NGW == 0, "the head groups split the warps evenly");
  static constexpr int NCW = WARPS / NGW;
};

// The scores' thread map: lane l < LG = RPW·G of a warp takes query head
// l % G and slot (row, or word of four columns) warp·RPW + l / G of every
// sweep of RPS slots; lanes LG..31 (two at G = 6) take no slot. A loop walks
// it = start(); it < end(n); it += STEP over slot(it). Where G divides 32
// (P2) this is the power-of-two editions' own walk: thread tid on head
// tid % G, it over [tid, n·G) in steps of THREADS, slot it / G.
template <int G>
struct ScoreMap {
  static constexpr int RPW = 32 / G;
  static constexpr int LG = RPW * G;
  static constexpr bool P2 = 32 % G == 0;
  static constexpr int STEP = P2 ? THREADS : WARPS * RPW;
  __device__ static int head() {
    if constexpr (P2) return (int)threadIdx.x % G;
    else return (int)(threadIdx.x & 31) % G;
  }
  // the first slot (a slot past every stripe for an idle lane)
  __device__ static int start() {
    if constexpr (P2) {
      return (int)threadIdx.x;
    } else {
      const int lane = threadIdx.x & 31;
      return lane < LG ? (int)(threadIdx.x >> 5) * RPW + lane / G : 1 << 30;
    }
  }
  __device__ static int end(int n) { return P2 ? n * G : n; }
  __device__ static int slot(int it) { return P2 ? it / G : it; }
};

// What a block shows the rest of its cluster (and its own warp partials),
// at the start of its dynamic shared memory.
template <int G, int HD>
struct Stats {
  double pv[G * HD];       // P·V partials, (query head, hd)
  double den[G];           // denominator partials
  double ps[G];            // ΣP partials
  double wsum[WARPS * G];  // warp partials of a sum
  float mx[G];             // block maxima
  float wmx[WARPS * G];    // warp maxima
};

// bytes of Stats rounded up to 16 (the fp64 slots after it take 16-byte loads)
template <int G, int HD>
__host__ __device__ constexpr size_t stats_bytes() {
  return (sizeof(Stats<G, HD>) + 15) & ~size_t(15);
}

// The int8 q row of one query head as HD / 4 words in registers (16-byte
// loads); returns its byte sum Σq.
template <int HD>
__device__ __forceinline__ int load_q_row(const int8_t* q, int (&qw)[HD / 4]) {
  const int4* qp = reinterpret_cast<const int4*>(q);
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {
    const int4 v = __ldg(qp + i);
    qw[4 * i] = v.x;
    qw[4 * i + 1] = v.y;
    qw[4 * i + 2] = v.z;
    qw[4 * i + 3] = v.w;
  }
  int qsum = 0;
#pragma unroll
  for (int w = 0; w < HD / 4; ++w) qsum = __dp4a(qw[w], 0x01010101, qsum);
  return qsum;
}

// q · row for an int8 row of HD bytes (16-byte loads, dp4a: exact); ks gets
// the row's byte sum Σk.
template <int HD>
__device__ __forceinline__ int row_dot(const int8_t* row, const int (&qw)[HD / 4], int& ks) {
  const int4* rp = reinterpret_cast<const int4*>(row);
  int acc = 0;
  ks = 0;
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {
    const int4 kv = __ldg(rp + i);
    const int kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ks = __dp4a(kw[j], 0x01010101, ks);
      acc = __dp4a(qw[4 * i + j], kw[j], acc);
    }
  }
  return acc;
}

// max / fp64 sum over the lanes l < ScoreMap<G>::LG of a warp with equal
// l % G: every lane gets the value of head lane % G. A power of two G folds
// by a butterfly; another G (6) gathers the lanes h, h + G, ... in order.
template <int G>
__device__ __forceinline__ float group_max(float v) {
  if constexpr ((G & (G - 1)) == 0) {
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
  } else {
    const int h = (threadIdx.x & 31) % G;
    float a = __shfl_sync(0xffffffffu, v, h);
#pragma unroll
    for (int j = 1; j < ScoreMap<G>::RPW; ++j) a = fmaxf(a, __shfl_sync(0xffffffffu, v, h + j * G));
    return a;
  }
}
template <int G>
__device__ __forceinline__ double group_sum(double v) {
  if constexpr ((G & (G - 1)) == 0) {
#pragma unroll
    for (int o = 16; o >= G; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  } else {
    const int h = (threadIdx.x & 31) % G;
    double a = __shfl_sync(0xffffffffu, v, h);
#pragma unroll
    for (int j = 1; j < ScoreMap<G>::RPW; ++j) a += __shfl_sync(0xffffffffu, v, h + j * G);
    return a;
  }
}

// The block's value for head threadIdx.x (threads < G; the others get the
// fold's start), from every thread's v for its head (ScoreMap<G>::head();
// idle lanes hold the fold's start): warps folded in index order. Ends with
// the block's threads synchronised after the warp values were written.
template <int G>
__device__ __forceinline__ float block_max(float v, float* wmx) {
  v = group_max<G>(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < G) wmx[warp * G + lane] = v;
  __syncthreads();
  float m = -3.4028235e38f;
  if (threadIdx.x < G)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, wmx[w * G + threadIdx.x]);
  return m;
}
template <int G>
__device__ __forceinline__ double block_sum(double v, double* wsum) {
  v = group_sum<G>(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < G) wsum[warp * G + lane] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x < G)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += wsum[w * G + threadIdx.x];
  return s;
}

// *p of every block of the cluster (ranks < ncl), folded in rank order; all
// the remote loads are issued before the fold
__device__ __forceinline__ float cluster_max(Cluster& cl, float* p, int ncl) {
  float v[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) v[r] = r < ncl ? *cl.map_shared_rank(p, r) : -3.4028235e38f;
  float a = v[0];
#pragma unroll
  for (int r = 1; r < MAX_CLUSTER; ++r) a = fmaxf(a, v[r]);
  return a;
}
__device__ __forceinline__ double cluster_sum(Cluster& cl, double* p, int ncl) {
  double v[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) v[r] = r < ncl ? *cl.map_shared_rank(p, r) : 0.0;
  double a = v[0];
#pragma unroll
  for (int r = 1; r < MAX_CLUSTER; ++r)
    if (r < ncl) a += v[r];
  return a;
}

// The block's P·V partials into pv[G·HD] (query head, hd): each thread's
// acc[gi][j], of head gg·GPT + gi and hd = lane·LS + j·JS, goes to red
// ([WARPS][GPT][HD], which may alias the P slots: the block is synchronised
// first), then the NCW warps of a head group are added in index order.
template <int G, int HD, int LS, int JS>
__device__ __forceinline__ void fold_warps(
    const double (&acc)[PvLayout<G, HD>::GPT][PvLayout<G, HD>::DPT], double* red, double* pv) {
  using L = PvLayout<G, HD>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                              // every warp is done with P
#pragma unroll
  for (int gi = 0; gi < L::GPT; ++gi)
#pragma unroll
    for (int j = 0; j < L::DPT; ++j) red[(warp * L::GPT + gi) * HD + LS * lane + JS * j] = acc[gi][j];
  __syncthreads();
  for (int o = threadIdx.x; o < G * HD; o += THREADS) {
    const int go = o / HD, d = o - go * HD, ggo = go / L::GPT, gi = go - ggo * L::GPT;
    double s = 0.0;
#pragma unroll
    for (int c = 0; c < L::NCW; ++c) s += red[((ggo * L::NCW + c) * L::GPT + gi) * HD + d];
    pv[o] = s;
  }
}

// exact fp64 of a nibble / byte without the conversion unit: the bits of
// 2^52 + u, less 2^52 (one fp64 add). s8: u is the byte's bits (v & 0xFF),
// read as a signed int8 v (2^52 + (v + 128), less 2^52 + 128).
__device__ __forceinline__ double u_to_f64(unsigned u) {
  return __hiloint2double(0x43300000, (int)u) - 4503599627370496.0;
}
__device__ __forceinline__ double s8_to_f64(unsigned u) {
  return __hiloint2double(0x43300000, (int)((u & 0xFFu) ^ 0x80u)) - 4503599627370624.0;
}

// Launch `kern` on a (ncl, nbh) grid in which the ncl blocks of a column are
// one thread-block cluster (a cluster of 1 where ncl is 1). `opted`: the
// dynamic shared memory this kernel may use so far (one per kernel, 0 at
// first). Returns the launch's cudaError_t.
template <typename... KArgs, typename... Args>
inline int launch_cluster(void (*kern)(KArgs...), size_t& opted, int ncl, int nbh, size_t smem,
                          cudaStream_t st, Args&&... args) {
  if (smem > opted && smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncl, nbh, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
}

}  // namespace dc
}  // namespace mqt
