// Weight-only (W4A16 / W8A16) matmul on the tensor cores: fp x (M, K) × an
// integer weight -> fp32 (M, N)
//   out[m, n] = Σ_g s_gn · Σ_{k in g} x[m, k] · (q[k, n] − o_gn) + bias[n]
//
// Replaces two kernels of mobilequant_tpu/ops/pallas_matmul.py:
//   * wonly_matmul_stacked (_wonly_kernel_stacked): x (M <= 8, K) × layer
//     `layer` of a stacked W4 / W8 pack, per-tensor, per-channel or grouped
//     scales — the weight-only decode matmul (runtime/wonly.py);
//   * w4a16_matmul (_w4a16_kernel): x (any M, K) × one W4 (K/2, N) matrix,
//     per-channel scales (L = 1).
//
// Layouts (the JAX package's). W4: unsigned block nibbles, (K/2, N), N
// contiguous; packed row r holds k = r (low nibble) and k = r + K/2 (high
// nibble), 0..15. W8: shifted int8 (K, N). Scale / offset: an fp32 (G, N)
// plane per layer read through strides: per tensor (sn = 0), per channel
// (G = 1), grouped along K (G groups of K/G rows, a multiple of 16; for W4
// the groups split at the nibble half, so G is even and the high rows read
// groups [G/2, G)). x: fp32 or bf16 rows; bias: fp32 (N,) per layer, or none.
//
// Bound: device-memory bytes at M <= 8 (a TinyLlama W4 g128 layer: 22.02 MB
// of nibbles and 2.75 MB of scales and offsets); at M = 128 the products, on
// the tensor cores. The scalar edition this replaces dequantized every weight
// to fp32 and multiplied on the CUDA cores (7x its byte bound at M = 1), and
// read every weight byte once per 8 rows of x. Design: the weight side is the
// centred integer q − c (W4: nibble − 8, W8: the int8 byte), exact in bf16,
// and the offset comes in as a correction:
//   Σ_k x_k·(q_kn − o_gn) = Σ_k x_k·(q_kn − c) − (o_gn − c)·Σ_k x_k,
// so any offset is served (whole or not, of any size). Per group the tensor
// cores form Σ_k x_k·(q_kn − c) in bf16 with fp32 accumulation (mma.sync
// m16n8k16); fp32 x is split into three bf16 terms (24 bits, one MMA each),
// bf16 x is one exact term. One more MMA a unit and term, of a ones A
// fragment, gives each warp the Σx of its own units of a group in the layout
// of the sums; it applies sum·s − (o − c)·s·Σx per group (per channel:
// (sum − (o − c)·Σx)·s), with no pass after the main loop. The operands are
// swapped: 16 output columns are the MMA's rows (A, the weight) and up to 8
// rows of x its columns (B), so no MMA row is spent on padding at M <= 8;
// above 8 rows a block tiles 64 rows of x (eight n8 tiles), so a weight byte
// is read once per 64 rows (up to K/2 = 2048 weight rows, whose x slices 16
// splits can stage; past that 8-row tiles). The weight streams through a
// four-stage cp.async ring of 64 x 128-byte stages (16-byte copies, an XOR
// swizzle that keeps the fragment reads conflict-free); a lane turns its
// bytes into bf16 pairs in registers (W4: prmt, lop3 to the bf16 pattern
// 0x4300 | n = 128 + n, minus 136; W8: the fp32 pattern 0x4B000000 | (q + 128)
// minus 2^23 + 128, packed to bf16). The block's x slice, and the block's
// scale and offset rows, come in with the first copies. K splits over up to
// 16 blocks, one thread-block cluster (Hopper); the warps of a block, then
// the splits (from each other's shared memory) are added in a fixed order: no
// float atomics and no workspace, so a call is deterministic. Against the
// plain version (fp32 (q − o)·s, then an fp32 matmul) the result differs by
// the fp32 rounding of the sums and of the correction only: the products are
// exact, and o − c is small for the JAX packs (their zero-point lies in the
// code range), so the correction cancels little.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "mqt_common.cuh"

namespace {

constexpr int WO_THREADS = 256;             // 4 warp slots x 2 column halves
constexpr int WO_TN = 128;                  // columns of a block
constexpr int WO_CH = 64;                   // weight rows (W4: packed rows) a stage
constexpr int WO_NST = 4;                   // ring stages
constexpr int WO_STAGE = WO_CH * WO_TN;     // bytes a stage

struct WoArgs {
  const void* x;
  const uint8_t* wq;       // this layer's (K or K/2, N)
  const float* scale;      // this layer's plane
  const float* offset;
  const float* bias;       // this layer's (N,), or null
  float* out;
  int sg, sn, gsz;         // gsz: K rows per group (K when not grouped)
  int M, K, N, Kr, rps, ks;
  int rsx, xr;             // staged x: values a half, values a row
  int xsb;                 // bytes of the x region (64-row tiles: also the sums)
  int gph;                 // grouped: group rows staged a half
};

__device__ __forceinline__ uint32_t bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// fp32 (x0, x1) as three bf16 pairs x = t0 + t1 + t2 (24 bits)
__device__ __forceinline__ void x_terms(float x0, float x1, uint32_t (&t)[3]) {
  t[0] = bf2(x0, x1);
#pragma unroll
  for (int i = 1; i < 3; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t[i - 1]));
    x0 = x0 - f.x;
    x1 = x1 - f.y;
    t[i] = bf2(x0, x1);
  }
}

// grid (column tiles, K splits, row tiles of 8 MT). Warp w works on column
// half h = w / 4 of the block's 128; its lane (g, t) owns columns 64 h + 8 g ..
// + 7: A row g of m-tile i (of 4) is column 64 h + 8 g + 2 i, row g + 8 the
// next. A unit is 16 weight rows (W4: one nibble half of 16 packed rows); the
// lane holds rows 4 t .. 4 t + 3 of it (k 2t, 2t + 1 -> rows 4t, 4t + 1;
// k 2t + 8, 2t + 9 -> rows 4t + 2, 4t + 3, in A and B alike). MT = 1 (at most
// 8 rows of x): warp slot s = w % 4 takes units s, s + 4, .. (W4: the low or
// high nibbles, s & 1), and the slots' sums meet in shared memory. MT = 8 (64
// rows): slot s takes rows 16 s .. 16 s + 15 (two n8 tiles) over every unit.
// The K splits of a tile are one thread-block cluster and meet in each
// other's shared memory.
template <int BITS, int MT, bool GROUPED, bool XBF>
__global__ void __launch_bounds__(WO_THREADS, 2)
wonly_kernel(const WoArgs a) {
  static_assert(MT == 1 || (BITS == 4 && !GROUPED), "64-row tiles: W4 per channel only");
  constexpr int NH = BITS == 4 ? 2 : 1;           // K halves a weight row carries
  constexpr int NT = XBF ? 1 : 3;                 // bf16 terms of x
  constexpr int NJ = MT == 1 ? 1 : 2;             // n8 tiles (8 rows of x) a warp
  constexpr int UW = MT == 1 ? NH : 4 * NH;       // units a warp per stage
  constexpr int XB = XBF ? 2 : 4;                 // bytes an x value
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* xs = smem + WO_NST * WO_STAGE;         // x rows as they are (fp32 / bf16)
  // grouped: the scale and offset rows (128 columns) of the block's groups,
  // [half][group - first group of the half][scale, offset][128]; else the
  // block's column scales and o − c, [2][128]
  float* gs = reinterpret_cast<float*>(xs + a.xsb);
  constexpr float C = BITS == 4 ? 8.0f : 0.0f;    // the centre c of q

  const int tid = threadIdx.x, lane = tid & 31, ws = (tid >> 5) & 3, chf = tid >> 7;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * WO_TN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * 8 * MT;
  const int mrows = min(8 * MT, a.M - m0);
  const int r0 = split * a.rps, r1 = min(a.Kr, r0 + a.rps);
  const int half = a.K >> 1;
  const int nch = (r1 - r0 + WO_CH - 1) / WO_CH;
  const int j0 = MT == 1 ? 0 : 2 * ws;            // the warp's first n8 tile

  auto load = [&](int c) {
    uint8_t* st = ring + (c % WO_NST) * WO_STAGE;
#pragma unroll
    for (int i = tid; i < WO_CH * 8; i += WO_THREADS) {
      const int rr = i >> 3, s = i & 7;
      const int row = r0 + c * WO_CH + rr, col = n0 + 16 * s;
      const bool ok = row < r1 && col < a.N;
      mqt::cp_async16(st + rr * WO_TN + ((s ^ ((rr >> 1) & 6)) << 4),
                      ok ? a.wq + (size_t)row * a.N + col : a.wq, ok);
    }
  };
  // the block's x rows m < mrows, both halves, as 16-byte copies in the first
  // group (rows past the split zero-filled; rows past M are never read into
  // a kept column)
  {
    const int cpr = a.rps * XB / 16;              // copies a half row
    const int ncx = mrows * NH * cpr;
    for (int i = tid; i < ncx; i += WO_THREADS) {
      const int row = i / cpr, jc = i - row * cpr;
      const int m = row / NH, hf = row - m * NH, j = jc * 16 / XB;
      const bool ok = r0 + j < r1;
      const size_t gi = (size_t)(m0 + m) * a.K + hf * half + r0 + j;
      mqt::cp_async16(xs + ((size_t)m * a.xr + hf * a.rsx + j) * XB,
                      ok ? (const uint8_t*)a.x + gi * XB : (const uint8_t*)a.x, ok);
    }
  }
  auto gfirst = [&](int hf) { return (hf * half + r0) / a.gsz; };
  if (GROUPED) {
    const int nrows = NH * a.gph * 2;             // scale and offset rows
    for (int i = tid; i < nrows * 32; i += WO_THREADS) {
      const int rw = i >> 5, c = i & 31, hf = rw / (2 * a.gph), g = (rw >> 1) % a.gph;
      const int gg = gfirst(hf) + g, col = n0 + 4 * c;
      const bool ok = gg <= (hf * half + r1 - 1) / a.gsz && col < a.N;
      const float* src = (rw & 1 ? a.offset : a.scale) + (size_t)gg * a.sg + col;
      mqt::cp_async16(gs + rw * WO_TN + 4 * c, ok ? src : a.scale, ok);
    }
  }
  // not grouped: thread t loads column t % 128's scale (t < 128) or offset,
  // stored once the first copies are on their way
  float cso = 0.0f;
  if (!GROUPED && n0 + (tid & 127) < a.N)
    cso = __ldg((tid < WO_TN ? a.scale : a.offset) + (size_t)(n0 + (tid & 127)) * a.sn);
#pragma unroll
  for (int c = 0; c < WO_NST - 1; ++c) {
    if (c < nch) load(c);
    mqt::cp_async_commit();
  }
  if (!GROUPED) gs[tid] = tid < WO_TN ? cso : cso - C;

  // this lane's 8 columns; grouped: the current group's s and (o − c)·s,
  // from the staged rows (after the first wait)
  const int cl = 64 * chf + 8 * gq;               // first column in the tile
  float sc[8], oc[8];
  auto consts = [&](int g, int hf) {
    const float* sp = gs + ((hf * a.gph + g - gfirst(hf)) * 2) * WO_TN + cl;
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(sp + j);
      const float4 o4 = *reinterpret_cast<const float4*>(sp + WO_TN + j);
      sc[j] = s4.x;
      sc[j + 1] = s4.y;
      sc[j + 2] = s4.z;
      sc[j + 3] = s4.w;
      oc[j] = (o4.x - C) * s4.x;
      oc[j + 1] = (o4.y - C) * s4.y;
      oc[j + 2] = (o4.z - C) * s4.z;
      oc[j + 3] = (o4.w - C) * s4.w;
    }
  };
  // grouped: the current group and the row it ends at (a warp's units run
  // up one half, so a division only where a group begins)
  int gcur = -1, gend = -1;

  float acc[NJ][4][4];
  float tot[GROUPED ? 4 : 1][4];
  // Σx over the warp's units (of the current group): an MMA of a ones A
  // fragment, so element e of n8 tile j is x row 8 (j0 + j) + 2 t + (e & 1),
  // as in acc
  float xacc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) xacc[j][0] = xacc[j][1] = xacc[j][2] = xacc[j][3] = 0.0f;
  const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u, 0x3F803F80u};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i][0] = acc[j][i][1] = acc[j][i][2] = acc[j][i][3] = 0.0f;
#pragma unroll
  for (int i = 0; i < (GROUPED ? 4 : 1); ++i) tot[i][0] = tot[i][1] = tot[i][2] = tot[i][3] = 0.0f;
  auto flush = [&]() {        // grouped: tot += Σx(q − c)·s_g − (o_g − c)·s_g·Σx
#pragma unroll
    for (int i = 0; i < (GROUPED ? 4 : 1); ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * i + (e >> 1);
        tot[i][e] = tot[i][e] + acc[0][i][e] * sc[c] - oc[c] * xacc[0][e & 1];
        acc[0][i][e] = 0.0f;
      }
    xacc[0][0] = xacc[0][1] = xacc[0][2] = xacc[0][3] = 0.0f;
  };

  // A fragment (q − c) of m-tile i from the lane's four row words
  // (w[row][word]): nibble half hf
  auto frag_a = [&](const uint32_t (&w)[4][2], int i, int hf, uint32_t (&fa)[4]) {
    const int wi = i >> 1, bb = 2 * (i & 1);
#pragma unroll
    for (int p = 0; p < 4; ++p) {             // a0, a1, a2, a3
      const int rp = 2 * (p >> 1), c = bb + (p & 1);
      const uint32_t u = w[rp][wi], v = w[rp + 1][wi];
      if constexpr (BITS == 4) {
        uint32_t y = __byte_perm(u, v, c | ((4 + c) << 8));
        if (hf) y >>= 4;
        const uint32_t nb = (y & 0x000F000Fu) | 0x43004300u;
        const uint32_t c136 = 0x43084308u;    // the bf16 pair (136, 136)
        const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&nb),
                                         *reinterpret_cast<const __nv_bfloat162*>(&c136));
        fa[p] = *reinterpret_cast<const uint32_t*>(&r);
      } else {
        const unsigned sel = 0x5440u | c;
        const float fu = __uint_as_float(__byte_perm(u ^ 0x80808080u, 0x4B00u, sel)) - 8388736.0f;
        const float fv = __uint_as_float(__byte_perm(v ^ 0x80808080u, 0x4B00u, sel)) - 8388736.0f;
        fa[p] = bf2(fu, fv);
      }
    }
  };
  // B fragments (t terms) of n8 tile j: x rows 8 j + g, staged rows jb .. jb + 3
  auto frag_b = [&](int j, int hf, int jb, uint32_t (&b0)[3], uint32_t (&b1)[3]) {
    const uint8_t* p = xs + ((size_t)(8 * j + gq) * a.xr + hf * a.rsx + jb) * XB;
    if constexpr (XBF) {
      const uint2 xv = *reinterpret_cast<const uint2*>(p);
      b0[0] = xv.x;
      b1[0] = xv.y;
    } else {
      const float4 xv = *reinterpret_cast<const float4*>(p);
      x_terms(xv.x, xv.y, b0);
      x_terms(xv.z, xv.w, b1);
    }
  };

  for (int ci = 0; ci < nch; ++ci) {
    mqt::cp_async_wait<WO_NST - 2>();
    __syncthreads();
    if (ci + WO_NST - 1 < nch) load(ci + WO_NST - 1);
    mqt::cp_async_commit();
    const uint8_t* st = ring + (ci % WO_NST) * WO_STAGE;
#pragma unroll
    for (int uu = 0; uu < UW; ++uu) {
      const int u = MT == 1 ? ws + 4 * uu : uu;
      const int step = u / NH, hf = u % NH;
      const int rr0 = 16 * step;
      if (r0 + ci * WO_CH + rr0 >= r1) continue;
      if (GROUPED) {
        const int k = hf * half + r0 + ci * WO_CH + rr0;
        if (k >= gend) {
          if (gcur >= 0) flush();
          gcur = k / a.gsz;
          gend = (gcur + 1) * a.gsz;
          consts(gcur, hf);
        }
      }
      // the lane's four rows rr0 + 4 tq + p, 8 bytes each (swizzle 2 tq)
      uint32_t w[4][2];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            st + (rr0 + 4 * tq + p) * WO_TN + (((4 * chf + (gq >> 1)) ^ (2 * tq)) << 4)
            + 8 * (gq & 1));
        w[p][0] = v.x;
        w[p][1] = v.y;
      }
      const int jb = ci * WO_CH + rr0 + 4 * tq;
      uint32_t b0[NJ][3], b1[NJ][3];
#pragma unroll
      for (int j = 0; j < NJ; ++j) frag_b(j0 + j, hf, jb, b0[j], b1[j]);
      uint32_t fa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) frag_a(w, i, hf, fa[i]);
#pragma unroll
      for (int t = 0; t < NT; ++t) {   // terms outermost: no MMA waits on the one before
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mqt::mma_bf16(acc[j][i], fa[i], b0[j][t], b1[j][t]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mqt::mma_bf16(xacc[j], ones, b0[j][t], b1[j][t]);
      }
    }
  }
  mqt::cp_async_wait<0>();
  if (GROUPED && gcur >= 0) flush();
  __syncthreads();            // the ring and x are dead: they hold the sums now

  // red: MT = 1, [warp slot][8 rows][RS] over the ring; MT = 8, [64 rows][RS]
  // over x (RS: rows a bank apart, so the fragment-order writes spread). Not
  // grouped, each warp applies its correction and the scale here:
  // (Σx(q − c) − (o − c)·Σx)·s, with its own Σx
  constexpr int RS = WO_TN + 1;
  float* red = reinterpret_cast<float*>(MT == 1 ? ring : xs);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * (j0 + j) + 2 * tq + (e & 1), c = cl + 2 * i + (e >> 1);
        float val;
        if constexpr (GROUPED) val = tot[i][e];
        else val = (acc[j][i][e] - gs[WO_TN + c] * xacc[j][e & 1]) * gs[c];
        red[(MT == 1 ? ws * 8 + m : m) * RS + c] = val;
      }
  }
  __syncthreads();
  if (MT == 1 && tid < WO_TN)   // the block's sum: the slots' in slot order
#pragma unroll
    for (int m = 0; m < 8; ++m)
      red[m * RS + tid] = red[m * RS + tid] + red[(8 + m) * RS + tid]
                          + red[(16 + m) * RS + tid] + red[(24 + m) * RS + tid];
  // the K splits of this tile are one thread-block cluster: block `split` adds
  // rows split, split + ks, ... of every split's sums in split order, from
  // their shared memory; two outputs a thread at a time, all their loads in
  // flight together
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int nout = (mrows > split ? (mrows - split + a.ks - 1) / a.ks : 0) * WO_TN;
  for (int o0 = tid; o0 < nout; o0 += 2 * WO_THREADS) {
    float v[2][16];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int oi = o0 + u * WO_THREADS, m = split + a.ks * (oi / WO_TN), c = oi % WO_TN;
#pragma unroll
      for (int sp = 0; sp < 16; ++sp)
        v[u][sp] = oi < nout && sp < a.ks ? cluster.map_shared_rank(red, sp)[m * RS + c] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int oi = o0 + u * WO_THREADS, m = split + a.ks * (oi / WO_TN), c = oi % WO_TN;
      float s = v[u][0];
#pragma unroll
      for (int sp = 1; sp < 16; ++sp)
        if (sp < a.ks) s += v[u][sp];
      if (oi < nout && n0 + c < a.N)
        a.out[(size_t)(m0 + m) * a.N + n0 + c] = a.bias ? s + a.bias[n0 + c] : s;
    }
  }
  cluster.sync();             // the others may still read this block's sums
}

template <int BITS, int MT, bool GROUPED, bool XBF>
int launch(const WoArgs& a, dim3 grid, size_t smem, cudaStream_t st) {
  auto* k = wonly_kernel<BITS, MT, GROUPED, XBF>;
  static size_t set = 0;
  if (smem > set) {
    cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && set == 0)    // clusters of up to 16 blocks (Hopper)
      e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WO_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;          // the K splits of a tile
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, k, a);
}

template <int BITS, int MT, bool GROUPED>
int launch_x(const WoArgs& a, bool xbf, dim3 grid, size_t smem, cudaStream_t st) {
  return xbf ? launch<BITS, MT, GROUPED, true>(a, grid, smem, st)
             : launch<BITS, MT, GROUPED, false>(a, grid, smem, st);
}

}  // namespace

// x (M, K) fp32 (xbf16 = 0) or bf16 (1); wq the stacked (L, K/2, N) W4 or
// (L, K, N) W8 bytes (bits 4 / 8); scale / offset fp32 with layer stride sl,
// group stride sg and column stride sn (0: per tensor), `groups` groups
// along K (1: not grouped; K/groups a multiple of 16); bias fp32 (L, N) or
// null; out (M, N) fp32. Row tiles: 8 rows up to M = 8 or past 2048 weight
// rows, else 64 (W4 per channel / per tensor only). The K split: ks <= 16
// splits (one cluster) of rps weight rows (rps % 16 == 0; rps <= 1024, or 128
// for 64-row tiles; grouped, at most 16 groups). K and N multiples of 16. Any
// offsets.
MQT_EXPORT int mqt_wonly_matmul(const void* x, int xbf16, const void* wq, int bits,
                                const void* scale, const void* offset, int sl, int sg,
                                int sn, int groups, const void* bias, void* out, int M,
                                int K, int N, int layer, int rps, int ks, void* stream) {
  const int Kr = bits == 4 ? K / 2 : K;
  // 64-row tiles while the K splits can hold their x slices (else 8-row ones)
  const int mt = M <= 8 || Kr > 16 * 128 ? 1 : 8;
  const bool grouped = groups > 1;
  if (M < 1 || K % 16 || N % 16 || (bits != 4 && bits != 8) || groups < 1 || K % groups
      || (grouped && (K / groups) % 16)
      || (bits == 4 && (K % 2 || (grouped && groups % 2))) || rps % 16
      || rps > (mt == 1 ? 1024 : 128) || rps < 16 || ks < 1 || ks > 16
      || (grouped && rps > 16 * (K / groups)) || (long long)rps * ks < Kr
      || (long long)rps * (ks - 1) >= Kr || (mt > 1 && (bits != 4 || grouped)))
    return (int)cudaErrorInvalidValue;
  WoArgs a;
  a.x = x;
  a.wq = (const uint8_t*)wq + (size_t)layer * Kr * N;
  a.scale = (const float*)scale + (size_t)layer * sl;
  a.offset = (const float*)offset + (size_t)layer * sl;
  a.bias = bias ? (const float*)bias + (size_t)layer * N : nullptr;
  a.out = (float*)out;
  a.sg = sg;
  a.sn = sn;
  a.gsz = K / groups;
  a.M = M;
  a.K = K;
  a.N = N;
  a.Kr = Kr;
  a.rps = rps;
  a.ks = ks;
  const int nh = bits == 4 ? 2 : 1;
  a.rsx = (rps + 63) / 64 * 64;
  a.xr = nh * a.rsx + 16;     // = 16 mod 64 values: conflict-free fragment reads
  a.gph = grouped ? (rps + a.gsz - 1) / a.gsz + 1 : 0;
  // x rows; a 64-row tile's sums (64 x (WO_TN + 1) floats) go over them
  a.xsb = 8 * mt * a.xr * (xbf16 ? 2 : 4);
  if (mt > 1) a.xsb = max(a.xsb, 8 * mt * (WO_TN + 1) * (int)sizeof(float));
  const size_t smem = (size_t)WO_NST * WO_STAGE + a.xsb
                      + (size_t)(grouped ? nh * a.gph : 1) * 2 * WO_TN * sizeof(float);
  dim3 grid((N + WO_TN - 1) / WO_TN, ks, (M + 8 * mt - 1) / (8 * mt));
  cudaStream_t st = (cudaStream_t)stream;
  const bool xb = xbf16 != 0;
  if (mt > 1) return launch_x<4, 8, false>(a, xb, grid, smem, st);
  if (bits == 4)
    return grouped ? launch_x<4, 1, true>(a, xb, grid, smem, st)
                   : launch_x<4, 1, false>(a, xb, grid, smem, st);
  return grouped ? launch_x<8, 1, true>(a, xb, grid, smem, st)
                 : launch_x<8, 1, false>(a, xb, grid, smem, st);
}
