// Whole-decode-step, whole-layer and whole-MLP-block W4A8 / W8A8 kernels.
//
// Replaces mobilequant_tpu/ops/pallas_layer.py fused_model_w4_stacked
// (_model_kernel, _layer_phase, _head_phase) and fused_layer_w4_stacked
// (_layer_kernel), and mobilequant_tpu/ops/pallas_mlp.py
// fused_mlp_block_w4_stacked (_w4_mlp_block_kernel, _w4_mlp_phase), each in
// both of its editions: the JAX kernels take the bit width from the pack's
// shape, these kernels from the packs' `bits` (a template parameter of the
// layer stages: 4, nibble-packed (kin/2, n); 8, shifted int8 (kin, n)), and
// the head's from a.hbits (a W8 head is (K, Vp), per-column scales). Every
// norm (norm1, norm2, the head's final norm) is RMSNorm, or with a.ln the
// JAX kernels' LayerNorm edition (StableLM): the mean first, then the sum of
// squares of x − mean, both in fp64, then the bias.
//
// One cooperative, persistent launch (cudaLaunchCooperativeKernel) runs every
// stage; a grid-wide barrier separates dependent stages. Per layer
// (mqt_fused_decode, one block an SM):
//   1. norm1 + quantize (each block with qkv work, redundantly: every block
//      needs the whole row) -> qkv matvec -> affine bracket -> per-column
//      output fake-quant -> yq (B, Nq) fp32                          | barrier
//   2. attention, one work item per (sequence, q head): RoPE with the partner
//      column, joint segment quantization (the group's first q head writes
//      the new K/V rows to kv_new), int scores over the stale cache rows
//      [0, pos) staged through shared memory, the explicit self term, softmax
//      with its fake-quant sites across the block, P·V plus the self term,
//      pv-output quantize -> a8 (B, Ko) int8                         | barrier
//   3. o-proj matvec -> output fq -> resid_add_1 -> resid (B, K)     | barrier
//   4. norm2 + quantize -> w13 matvec, the w1 and the w3 columns of the same
//      32 gate outputs in one block -> gate chain -> act8 (B, F) int8 | barrier
//   5. w2 matvec -> output fq -> resid_add_2 -> x (B, K)             | barrier
// then, with a head, the final norm, dynamic per-row A8 and the W4 or W8 head
// -> logits (B, Vp). Each barrier waits for every block (stage 2 needs all of
// yq, stage 3 all of a8, stages 1 and 4 the whole rows of their norms, stage
// 5 all of act8, the head all of x).
//
// The matvec stages (the ring kernel): a block's share of every stage is
// fixed in advance, whole-K items of 32 columns (32-byte row segments, one
// DRAM sector), so no partial sum leaves the block: no split-K workspace, no
// meeting, no last-block epilogue. A producer warp streams the block's items,
// stage after stage and layer after layer (the head's during the last layer),
// through a ring of 16 KB shared-memory chunks (16-byte cp.async, mbarriers
// "full" / "empty" a slot) and refills a slot as soon as the consumers
// release it, so the loads of the next stages run across the grid barriers
// and a stage finds its chunks on chip when its barrier opens (8-12 slots at
// TinyLlama's widths, 5-8 at Gemma-2B's, S = 1024). The consumer warps never
// issue a copy, since a fence of theirs (the grid barrier) would wait for
// every copy in flight. The matvec is dp4a (B <= 8: a few GOP against
// ~0.5-1 GB): a lane transposes 4 rows of CPL columns (4x4 byte transposes;
// W4: then the nibble masks) into dp4a operands; the per-column epilogue
// vectors are loaded when an item begins. A norm stages x, w and b in shared
// memory first, and every rintf(x / s) of the norms and epilogues takes x·(1 /
// s) unless that product lies within its error of a half-integer (rint_div:
// the same integer, without a true division's call). The grid barrier counts
// arrivals over the whole launch (no reset between barriers, one arrival an
// SM). mqt_fused_mlp_block (stages 4-5 for M <= 8 rows, one barrier; the
// MLP-block wrapper takes it up to ops/mlp_block.DP4A_ROWS rows, fused_rows.cu
// above) keeps the earlier split-K stages: a tile's K range split over
// blocks, int32 partials added into a self-cleaning workspace, the tile's
// last block running the epilogue. Buffers written inside a launch are read
// with __ldcg (L2), never through the non-coherent read-only path.
//
// Bound: device-memory bytes. At B <= 8 one decode step streams every packed
// weight byte once (518 MB for TinyLlama-1.1B with its W4 head, 1,036 MB with
// W8 layers and a W8 head) plus the valid KV rows.
//
// Numerics repeat the plain versions' fp32 operation order (built with
// --fmad=false; rintf is round-half-even, divisions are true divisions). The
// sums that feed an int8 rounding (norm sums of squares, the softmax
// denominator, P·V and ΣP, the self score) accumulate in fp64 and round once
// to fp32, so they do not depend on the summation order: the kernel, its
// plain version on the CPU and on the card give the same bytes.
#pragma once

#include "fused_common.cuh"

namespace {

// The consumer threads' barrier: named barrier 1 over the FT consumer threads.
// The ring kernel's producer warp (threads FT.. FT + 31) never joins it; in
// the MLP-block kernel it is every thread.
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;" ::"n"(FT) : "memory"); }

// fused_common.cuh's stage_rows, block_sum and block_max on csync
__device__ __forceinline__ void cstage_rows(int8_t* dst, const int8_t* src, int nbytes) {
  csync();
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < (nbytes >> 4); i += FT) d4[i] = __ldg(s4 + i);
  csync();
}

__device__ __forceinline__ float cblock_sum(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  csync();
  if (lane == 0) scratch[warp] = v;
  csync();
  double t = 0.0;
  for (int w = 0; w < NW; ++w) t += scratch[w];
  return (float)t;
}

__device__ __forceinline__ float cblock_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  csync();
  if (lane == 0) scratch[warp] = v;
  csync();
  float t = scratch[0];
  for (int w = 1; w < NW; ++w) t = fmaxf(t, scratch[w]);
  return t;
}

// Matvec tiles: each lane owns CPL adjacent columns (CPL bytes of a packed
// row in one load), so a warp reads 32·CPL contiguous bytes of each row; wider
// lanes for fewer rows keep the accumulators at MR·CPL = 16..32 per thread.
template <int MR>
struct Cfg {
  static constexpr int CPL = MR <= 2 ? 16 : (MR <= 4 ? 8 : 4);
  static constexpr int TC = 32 * CPL;          // columns per tile
};

// Shared memory: small arrays first, then one big region that a matvec stage
// uses for its activation rows and tile sums and the attention stage for its
// rows and scores.
constexpr int SMALL = 1280;      // bytes of the small arrays below

struct Smem {
  float* meta;     // 72: the MLP-block meta copy
  int* rsum;       // 8 (MR): row sums of the staged activation rows
  float* sx;       // 8: dynamic head scales
  int* flags;      // [0] last-block flag
  double* dred;    // NW x 8: per-warp fp64 row partials
  float* rn;       // 8: per-row 1 / rms (LayerNorm: 1 / std)
  float* fred;     // NW x 8: per-warp fp32 row partials (max)
  float* mu;       // 8: per-row mean (LayerNorm)
  int8_t* act;     // MR x kmax
  int* red;        // MR x TC tile sums (TC = Cfg<MR>::TC)
  char* big;
};

__device__ __forceinline__ Smem carve(int MR, int kmax) {
  extern __shared__ int4 smem_raw[];
  char* p = reinterpret_cast<char*>(smem_raw);
  Smem s;
  s.meta = reinterpret_cast<float*>(p);
  s.rsum = reinterpret_cast<int*>(p + 288);
  s.sx = reinterpret_cast<float*>(p + 320);
  s.flags = reinterpret_cast<int*>(p + 352);
  s.dred = reinterpret_cast<double*>(p + 384);
  s.rn = reinterpret_cast<float*>(p + 896);
  s.fred = reinterpret_cast<float*>(p + 928);
  s.mu = reinterpret_cast<float*>(p + 1184);
  s.big = p + SMALL;
  s.act = reinterpret_cast<int8_t*>(s.big);
  s.red = reinterpret_cast<int*>(s.big + (size_t)MR * kmax);
  return s;
}

// ---- matvec pieces -------------------------------------------------------

// tile t of an N-column matrix, and gate tile t (the w1 and w3 columns of
// TC/2 gate outputs, F apart)
template <int MR>
__device__ __forceinline__ Tile plain_tile(int t, int N) {
  constexpr int TC = Cfg<MR>::TC;
  return Tile{t * TC, 0, TC, min(TC, N - t * TC), 0};
}
template <int MR>
__device__ __forceinline__ Tile gate_tile(int t, int F) {
  constexpr int H = Cfg<MR>::TC / 2;
  const int n = min(H, F - t * H);
  return Tile{t * H, F + t * H, H, n, n};
}

// The CPL bytes at row `row`, columns col.. of a weight matrix, transposed:
// cw[wd][cc] holds rows row..row+3 of column col + 4 wd + cc (one byte a row).
template <int NWD>
__device__ __forceinline__ void load_group(const int8_t* __restrict__ w, int row, int N,
                                           int col, bool ok, int (&cw)[NWD][4]) {
  int r[4][NWD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int8_t* p = w + (size_t)(row + i) * N + col;
    if constexpr (NWD == 4) {
      const int4 v = ok ? __ldg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
      r[i][0] = v.x;
      r[i][1] = v.y;
      r[i][2] = v.z;
      r[i][3] = v.w;
    } else if constexpr (NWD == 2) {
      const int2 v = ok ? __ldg(reinterpret_cast<const int2*>(p)) : make_int2(0, 0);
      r[i][0] = v.x;
      r[i][1] = v.y;
    } else {
      r[i][0] = ok ? ld_i32(p) : 0;
    }
  }
#pragma unroll
  for (int wd = 0; wd < NWD; ++wd) {
    const int rr[4] = {r[0][wd], r[1][wd], r[2][wd], r[3][wd]};
    transpose4x4(rr, cw[wd]);
  }
}

// sm.red[m][n] += act[m] · W[:, gcol(n)] over row groups [g0, g1): group g
// is k = 4g..4g+3 and kin/2 + 4g..+3 (W4: one packed row group, its low and
// high nibbles; W8: rows 4g.. and kin/2 + 4g..)
template <int MR, int WB>
__device__ __forceinline__ void gemv_partial(const Smem& sm, int rows, int kin,
                                             const int8_t* __restrict__ w, int N,
                                             const Tile& t, int g0, int g1) {
  static_assert(WB == 4 || WB == 8, "W4 or W8");
  constexpr int CPL = Cfg<MR>::CPL, TC = Cfg<MR>::TC, NWD = CPL / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nl = lane * CPL;
  const bool ok = t.valid(nl);
  const int col = t.gcol(nl);
  const int k2 = kin >> 1;
  int acc[MR][CPL];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0;
#pragma unroll 2
  for (int g = g0 + warp; g < g1; g += NW) {
    int cw[NWD][4], ch[NWD][4];
    load_group<NWD>(w, 4 * g, N, col, ok, cw);
    if constexpr (WB == 8) {
      load_group<NWD>(w, k2 + 4 * g, N, col, ok, ch);
    } else {
#pragma unroll
      for (int wd = 0; wd < NWD; ++wd)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          ch[wd][cc] = (int)(((unsigned)cw[wd][cc] >> 4) & NIB);
          cw[wd][cc] &= (int)NIB;
        }
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= rows) break;
      const int xl = *reinterpret_cast<const int*>(sm.act + m * kin + 4 * g);
      const int xh = *reinterpret_cast<const int*>(sm.act + m * kin + k2 + 4 * g);
#pragma unroll
      for (int wd = 0; wd < NWD; ++wd)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          int& a = acc[m][wd * 4 + cc];
          a = __dp4a(cw[wd][cc], xl, a);
          a = __dp4a(ch[wd][cc], xh, a);
        }
    }
  }
  if (!ok) return;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= rows) break;
#pragma unroll
    for (int c = 0; c < CPL; ++c) atomicAdd(&sm.red[m * TC + nl + c], acc[m][c]);
  }
}

// Split-K meeting point of tile `tid_`: true in the block that holds the
// totals in sm.red afterwards (the only block when ks == 1).
template <int TC>
__device__ __forceinline__ bool finish_tile(const Smem& sm, int* ws, int tid_, int ks,
                                            int rows, int row0, int N, const Tile& t) {
  csync();
  if (ks == 1) return true;
  int* acc = ws + CNT;
  for (int i = threadIdx.x; i < rows * TC; i += FT) {
    const int m = i / TC, n = i % TC;
    if (t.valid(n)) atomicAdd(&acc[(size_t)(row0 + m) * N + t.gcol(n)], sm.red[i]);
  }
  __threadfence();
  csync();
  if (threadIdx.x == 0) sm.flags[0] = (atomicAdd(&ws[tid_], 1) == ks - 1);
  csync();
  if (!sm.flags[0]) return false;
  __threadfence();
  for (int i = threadIdx.x; i < rows * TC; i += FT) {
    const int m = i / TC, n = i % TC;
    if (t.valid(n)) sm.red[i] = atomicExch(&acc[(size_t)(row0 + m) * N + t.gcol(n)], 0);
  }
  if (threadIdx.x == 0) ws[tid_] = 0;
  csync();
  return true;
}

// Row sums of the staged int8 rows (warp m sums row m).
__device__ __forceinline__ void stage_rowsums(const Smem& sm, int rows, int kin) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < rows; m += NW) {
    int s = 0;
    for (int k4 = lane; k4 < (kin >> 2); k4 += 32)
      s = __dp4a(*reinterpret_cast<const int*>(sm.act + m * kin + 4 * k4), 0x01010101, s);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) sm.rsum[m] = s;
  }
}

// Copy int8 rows [row0, row0 + rows) of a (·, kin) buffer written in this
// launch into shared memory, with their row sums.
__device__ void stage_copy(const Smem& sm, const int8_t* src, int row0, int rows, int kin) {
  const int4* s4 = reinterpret_cast<const int4*>(src + (size_t)row0 * kin);
  int4* d4 = reinterpret_cast<int4*>(sm.act);
  for (int i = threadIdx.x; i < rows * kin / 16; i += FT) d4[i] = __ldcg(s4 + i);
  csync();
  stage_rowsums(sm, rows, kin);
  csync();
}

// sm.rn[m] = 1 / sqrt(Σ_k val(m, k)² / K + eps) for rows [0, rows), the whole
// block over each row (coalesced, independent loads); the sum is fp64.
template <int MR, typename Val>
__device__ void block_inv_rms(const Smem& sm, int rows, int K, float eps, Val val) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    acc[m] = 0.0;
    if (m < rows) {
#pragma unroll 4
      for (int k = threadIdx.x; k < K; k += FT) {
        const float v = val(m, k);
        acc[m] += (double)(v * v);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    double v = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sm.dred[warp * 8 + m] = v;
  }
  csync();
  if (threadIdx.x < rows) {
    double t = 0.0;
    for (int w = 0; w < NW; ++w) t += sm.dred[w * 8 + threadIdx.x];
    sm.rn[threadIdx.x] = 1.0f / sqrtf((float)t / (float)K + eps);
  }
  csync();
}

// LayerNorm's row scalars for rows [0, rows): sm.mu[m] = Σ_k val(m, k) / K
// (the sum fp64, rounded once), then block_inv_rms over val − mu.
template <int MR, typename Val>
__device__ void block_inv_std(const Smem& sm, int rows, int K, float eps, Val val) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    acc[m] = 0.0;
    if (m < rows) {
#pragma unroll 4
      for (int k = threadIdx.x; k < K; k += FT) acc[m] += (double)val(m, k);
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    double v = acc[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) sm.dred[warp * 8 + m] = v;
  }
  csync();
  if (threadIdx.x < rows) {
    double t = 0.0;
    for (int w = 0; w < NW; ++w) t += sm.dred[w * 8 + threadIdx.x];
    sm.mu[threadIdx.x] = (float)t / (float)K;
  }
  csync();
  block_inv_rms<MR>(sm, rows, K, eps, [&](int m, int k) { return val(m, k) - sm.mu[m]; });
}

// fq16(x) -> RMS norm, or LayerNorm (ln: mean-centred) -> ·w + b -> shifted
// int8 rows [row0, row0 + rows) in shared memory, with their row sums.
template <int MR>
__device__ void stage_norm_quant(const Smem& sm, const float* src, int row0, int rows,
                                 int K, const float* nw, const float* nb,
                                 float fs, float fo, float fqmax, float eps,
                                 float hs, float ho, bool ln) {
  const float* x = src + (size_t)row0 * K;
  auto val = [&](int m, int k) { return fqm(__ldcg(x + (size_t)m * K + k), fs, fo, fqmax); };
  if (ln) {
    block_inv_std<MR>(sm, rows, K, eps, val);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= rows) break;
      const float r = sm.rn[m], mu = sm.mu[m];
#pragma unroll 4
      for (int k = threadIdx.x; k < K; k += FT) {
        const float y = (val(m, k) - mu) * r * __ldg(nw + k) + __ldg(nb + k);
        sm.act[m * K + k] = (int8_t)(int)quant_u8s(y, hs, ho);
      }
    }
  } else {
    block_inv_rms<MR>(sm, rows, K, eps, val);
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= rows) break;
      const float r = sm.rn[m];
#pragma unroll 4
      for (int k = threadIdx.x; k < K; k += FT) {
        const float y = val(m, k) * r * __ldg(nw + k) + __ldg(nb + k);
        sm.act[m * K + k] = (int8_t)(int)quant_u8s(y, hs, ho);
      }
    }
  }
  csync();
  stage_rowsums(sm, rows, K);
  csync();
}

// Split and item counts of a matvec stage: ks splits of the K range over
// blocks so that tiles·ks is about the grid, at least one group per warp.
__device__ __forceinline__ void pick_ks(int tiles, int kin, int& ks, int& gpb) {
  const int ngroups = kin >> 3;               // groups of 4 packed rows
  int cap = ngroups / NW;
  if (cap < 1) cap = 1;
  ks = (gridDim.x + tiles - 1) / tiles;
  if (ks > cap) ks = cap;
  if (ks < 1) ks = 1;
  gpb = (ngroups + ks - 1) / ks;
  ks = (ngroups + gpb - 1) / gpb;
}

// ---- the stages ----------------------------------------------------------

// 2. attention, one work item per (sequence, q head): RoPE + quantization of
// the q head's row and its kv head's new k / v rows (the group's first q head
// writes them to kv_new), scores over the stale cache rows [0, pos) staged
// through shared memory in KV_CHUNK-row chunks, softmax over [rows, self term]
// across the block, P·V with the warps splitting the rows -> a8. DPL: the
// edition's most head dims a lane (4: hd <= 128; 8: hd <= 256, Gemma-2B), so
// a row is at most 8·DPL int words and 2·DPL 16-byte loads.
template <int DPL>
__device__ void stage_attention(const Args& a, const Smem& sm, int l) {
  const float* m = a.meta + (size_t)l * META;
  const int hd = a.hd, Hq = a.Hq, Hkv = a.Hkv, G = Hq / Hkv, S = a.S;
  const int Nq = a.qkv.n, Ko = Hq * hd, B = a.M;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ys = reinterpret_cast<float*>(sm.big);            // 3 x hd: q, k, v rows
  float* q8 = ys + 3 * hd;                                 // 3 x hd (shifted ints)
  double* part = reinterpret_cast<double*>(q8 + 3 * hd);   // NW x hd P·V partials
  int* qi = reinterpret_cast<int*>(part + NW * hd);        // hd/4 q words
  float* sc = reinterpret_cast<float*>(qi + 8 * DPL);      // S scores / probabilities
  int8_t* kvs = reinterpret_cast<int8_t*>(sc + S);         // KV_CHUNK x hd
  const float sq = m[6], oq = m[7] - 128.0f, sk = m[8], ok = m[9] - 128.0f;
  const float sv = m[10], ov = m[11] - 128.0f;
  const float sqk = sq * sk;
  const float hdoo = (float)hd * oq * ok;
  const float inv = a.inv_sqrt_hd;
  const int half = a.rot >> 1;
  const int li = l - a.l0;
  const int hw = hd >> 2;                      // int words per row (<= 8 DPL)
  const int dpl = hd >> 5;                     // head dims per lane (<= DPL)
  for (int it = blockIdx.x; it < B * Hq; it += gridDim.x) {
    const int b = it / Hq, qh = it % Hq, h = qh / G;
    int P = a.pos[b];
    P = P < 0 ? 0 : (P > S ? S : P);
    for (int i = threadIdx.x; i < 3 * hd; i += FT) {
      const int r = i / hd, d = i % hd;
      const int head = r == 0 ? qh : (r == 1 ? Hq + h : Hq + Hkv + h);
      ys[i] = __ldcg(a.yq + (size_t)b * Nq + head * hd + d);
    }
    csync();
    // RoPE (q and k rows) and joint segment quantization
    const float* csb = a.cs + (size_t)b * 2 * hd;
    for (int i = threadIdx.x; i < 3 * hd; i += FT) {
      const int r = i / hd, d = i % hd;
      float y = ys[i];
      if (r < 2) {
        const float partner = d < half ? ys[r * hd + d + half] : ys[r * hd + d - half];
        y = y * __ldg(csb + d) + partner * __ldg(csb + hd + d);
      }
      const float qv = quant_u8s(y, m[6 + 2 * r], m[7 + 2 * r]);
      q8[i] = qv;
      if (r > 0 && qh % G == 0) {
        const int kvrow = r == 1 ? h : Hkv + h;
        a.kv_new[(((size_t)li * B + b) * 2 * Hkv + kvrow) * hd + d] = (int8_t)(int)qv;
      }
    }
    csync();
    if (threadIdx.x < hw) {
      const float* src = q8 + 4 * threadIdx.x;
      qi[threadIdx.x] = (int)((unsigned)(uint8_t)(int8_t)(int)src[0]
                              | ((unsigned)(uint8_t)(int8_t)(int)src[1] << 8)
                              | ((unsigned)(uint8_t)(int8_t)(int)src[2] << 16)
                              | ((unsigned)(uint8_t)(int8_t)(int)src[3] << 24));
    }
    // Σq and the self score (every warp computes them: no extra barrier)
    int qsum = 0;
    double e = 0.0;
    for (int d = lane; d < hd; d += 32) {
      qsum += (int)q8[d];
      e += (double)((q8[d] - oq) * (q8[hd + d] - ok));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
    const float sself = fqm(warp_sum(e) * sqk, m[12], m[13], m[14]) * inv;
    csync();
    // int scores over the stale cache rows [0, P); rows >= P are masked by
    // neg_inf (-40000 or lower) and their exp is exactly 0, so they are skipped
    const int8_t* kc = a.kcache + (((size_t)l * B + b) * Hkv + h) * (size_t)S * hd;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      cstage_rows(kvs, kc + (size_t)c0 * hd, nr * hd);
      for (int r = threadIdx.x; r < nr; r += FT) {
        const int4* kr = reinterpret_cast<const int4*>(kvs + (size_t)r * hd);
        int ks = 0, acc = 0;
#pragma unroll
        for (int i = 0; i < 2 * DPL; ++i) {
          if (i < (hd >> 4)) {
            const int4 t = kr[i];
            ks = __dp4a(t.w, 0x01010101, __dp4a(t.z, 0x01010101,
                 __dp4a(t.y, 0x01010101, __dp4a(t.x, 0x01010101, ks))));
            acc = __dp4a(qi[4 * i], t.x, acc);
            acc = __dp4a(qi[4 * i + 1], t.y, acc);
            acc = __dp4a(qi[4 * i + 2], t.z, acc);
            acc = __dp4a(qi[4 * i + 3], t.w, acc);
          }
        }
        float v = ((float)acc - ok * (float)qsum - oq * (float)ks + hdoo) * sqk;
        v = fqm(v, m[12], m[13], m[14]);
        sc[c0 + r] = v * inv;
      }
    }
    csync();
    // softmax over [cache rows, self term] across the block
    float mx = __int_as_float(0xff800000);     // -inf
    for (int s = threadIdx.x; s < P; s += FT) mx = fmaxf(mx, sc[s]);
    mx = fmaxf(cblock_max(mx, sm.fred), sself);
    double dsum = 0.0;
    for (int s = threadIdx.x; s < P; s += FT) {
      const float ev = expf(sc[s] - mx);
      sc[s] = ev;
      dsum += (double)ev;
    }
    const float es = expf(sself - mx);
    const float den = cblock_sum(dsum, sm.dred) + es;
    double psd = 0.0;
    for (int s = threadIdx.x; s < P; s += FT) {
      const float p = fqm(sc[s] / den, m[15], m[16], m[17]);
      sc[s] = p;
      psd += (double)p;
    }
    const float psum = cblock_sum(psd, sm.dred);
    const float ps = fqm(es / den, m[15], m[16], m[17]);
    // P·V over the cache rows (warp w takes rows w, w + NW, ...; lanes over
    // head_dim), then the fp64 partials meet in shared memory
    const int8_t* vc = a.vcache + (((size_t)l * B + b) * Hkv + h) * (size_t)S * hd;
    double acc[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.0;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      cstage_rows(kvs, vc + (size_t)c0 * hd, nr * hd);
#pragma unroll 2
      for (int r = warp; r < nr; r += NW) {
        const double p = (double)sc[c0 + r];
        const int8_t* vr = kvs + (size_t)r * hd + lane;
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (j < dpl) acc[j] += p * (double)vr[32 * j];
      }
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (j < dpl) part[warp * hd + lane + 32 * j] = acc[j];
    csync();
    for (int d = threadIdx.x; d < hd; d += FT) {
      double t = 0.0;
      for (int w = 0; w < NW; ++w) t += part[w * hd + d];
      const float vnf = (q8[2 * hd + d] + 128.0f - m[11]) * sv;
      const float at = ((float)t - ov * psum) * sv + ps * vnf;
      a.a8[(size_t)b * Ko + qh * hd + d] = (int8_t)(int)quant_u8s(at, m[19], m[20]);
    }
    csync();
  }
}

// 4. norm2 + quantize + w13 with the gate chain -> act8 (rows in chunks of MR)
template <int MR, int WB>
__device__ void stage_w13(const Args& a, const Smem& sm, int l, const float* mm,
                          const float* src) {
  constexpr int TC = Cfg<MR>::TC, H = TC / 2;
  const int K = a.K, F = a.F, N = a.w13.n;
  const int tiles = (F + H - 1) / H;
  const int nch = (a.M + MR - 1) / MR;
  int ks, gpb;
  pick_ks(tiles * nch, K, ks, gpb);
  const float xs = mm[0], ox = mm[1] - 128.0f, kox = (float)K * ox;
  const int8_t* w = layer_w<WB>(a.w13, l);
  int staged = -1;
  for (int it = blockIdx.x; it < nch * tiles * ks; it += gridDim.x) {
    const int ch = it / (tiles * ks), rem = it % (tiles * ks);
    const int tile = rem / ks, sp = rem % ks;
    const int row0 = ch * MR, rows = min(MR, a.M - row0);
    if (staged != ch) {
      stage_norm_quant<MR>(sm, src, row0, rows, K, a.mnw + (size_t)l * K, a.mnb + (size_t)l * K,
                           mm[16], mm[17], mm[18], mm[19], mm[0], mm[1], a.ln);
      staged = ch;
    }
    const Tile t = gate_tile<MR>(tile, F);
    for (int i = threadIdx.x; i < MR * TC; i += FT) sm.red[i] = 0;
    csync();
    gemv_partial<MR, WB>(sm, rows, K, w, N, t, sp * gpb, min((K >> 3), (sp + 1) * gpb));
    if (!finish_tile<TC>(sm, a.ws, ch * tiles + tile, ks, rows, row0, N, t)) continue;
    for (int i = threadIdx.x; i < rows * H; i += FT) {
      const int r = i / H, j = i % H;
      if (j >= t.na) continue;
      const float rs = (float)sm.rsum[r];
      float g1 = affine(a.w13, l, sm.red[r * TC + j], t.colA + j, rs, xs, ox, kox);
      g1 = fqm(g1, mm[2], mm[3], mm[4]);
      float act;
      if (!a.gelu) {
        float sig = 1.0f / (1.0f + expf(-g1));
        sig = fqm(sig, mm[5], mm[6], mm[7]);
        act = g1 * sig;
      } else {
        const float u = 0.7978845608028654f * (g1 + 0.044715f * g1 * g1 * g1);
        act = 0.5f * g1 * (1.0f + tanhf(u));
      }
      act = fqm(act, mm[8], mm[9], mm[10]);
      float g3 = affine(a.w13, l, sm.red[r * TC + H + j], t.colB + j, rs, xs, ox, kox);
      g3 = fqm(g3, mm[11], mm[12], mm[13]);
      a.act8[(size_t)(row0 + r) * F + t.colA + j] =
          (int8_t)(int)quant_u8s(act * g3, mm[14], mm[15]);
    }
    csync();
  }
}

// 5. w2 + output fq + resid_add_2 -> out
template <int MR, int WB>
__device__ void stage_w2(const Args& a, const Smem& sm, int l, const float* mm,
                         const float* resid, float* out) {
  constexpr int TC = Cfg<MR>::TC;
  const int K = a.K, F = a.F, N = a.w2.n;
  const int tiles = (N + TC - 1) / TC;
  const int nch = (a.M + MR - 1) / MR;
  int ks, gpb;
  pick_ks(tiles * nch, F, ks, gpb);
  const float xs = mm[14], ox = mm[15] - 128.0f, kox = (float)F * ox;
  const int8_t* w = layer_w<WB>(a.w2, l);
  int staged = -1;
  for (int it = blockIdx.x; it < nch * tiles * ks; it += gridDim.x) {
    const int ch = it / (tiles * ks), rem = it % (tiles * ks);
    const int tile = rem / ks, sp = rem % ks;
    const int row0 = ch * MR, rows = min(MR, a.M - row0);
    if (staged != ch) {
      stage_copy(sm, a.act8, row0, rows, F);
      staged = ch;
    }
    const Tile t = plain_tile<MR>(tile, N);
    for (int i = threadIdx.x; i < MR * TC; i += FT) sm.red[i] = 0;
    csync();
    gemv_partial<MR, WB>(sm, rows, F, w, N, t, sp * gpb, min((F >> 3), (sp + 1) * gpb));
    if (!finish_tile<TC>(sm, a.ws, ch * tiles + tile, ks, rows, row0, N, t)) continue;
    for (int i = threadIdx.x; i < rows * TC; i += FT) {
      if (!t.valid(i % TC)) continue;
      const int r = i / TC, col = t.colA + i % TC;
      float y = affine(a.w2, l, sm.red[i], col, (float)sm.rsum[r], xs, ox, kox);
      y = fqm(y, mm[20], mm[21], mm[22]);
      const float xr = fqm(__ldcg(resid + (size_t)(row0 + r) * K + col), mm[23], mm[24], mm[25]);
      y = fqm(y, mm[26], mm[27], mm[28]);
      out[(size_t)(row0 + r) * K + col] = fqm(xr + y, mm[29], mm[30], mm[31]);
    }
    csync();
  }
}

// ---- the whole-model ring kernel (mqt_fused_decode) ------------------------

// rintf(x / s), exactly, with r = 1 / s: x·r lies within |x·r|·2^-22 of x / s,
// so it rounds to the same integer unless a half-integer lies that close;
// only then (and for |x·r| >= 2^20, inf or nan) the true division decides.
// (A true division is a call with a slow path, ~10x the multiply.)
__device__ __forceinline__ float rint_div(float x, float s, float r) {
  const float t = x * r;
  const float h = floorf(t) + 0.5f;
  if (!(fabsf(t) < 1048576.0f) || fabsf(t - h) <= fabsf(t) * 1e-6f) return rintf(x / s);
  return rintf(t);
}

// fqm and quant_u8s with r = 1 / s: the same values, in their fp32 order
__device__ __forceinline__ float fqm_r(float x, float s, float r, float o, float qmax) {
  float q = rint_div(x, s, r) + o;
  q = fminf(fmaxf(q, 0.0f), qmax);
  return qmax > 0.5f ? (q - o) * s : x;
}
__device__ __forceinline__ float quant_u8s_r(float x, float s, float r, float o) {
  const float q = rint_div(x, s, r) + o;
  return fminf(fmaxf(q, 0.0f), 255.0f) - 128.0f;
}

// q[j] = rintf(x[j] / s) for N values: rint_div's test on all of them, and
// the true divisions only when one of the products lies near a half-integer
// (no call in the common path, so the N values overlap)
template <int N>
__device__ __forceinline__ void rint_div_n(float (&q)[N], const float (&x)[N], float s, float r) {
  bool near = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float t = x[j] * r;
    const float h = floorf(t) + 0.5f;
    near |= !(fabsf(t) < 1048576.0f) || fabsf(t - h) <= fabsf(t) * 1e-6f;
    q[j] = rintf(t);
  }
  if (near) {
#pragma unroll
    for (int j = 0; j < N; ++j) q[j] = rintf(x[j] / s);
  }
}

// pull n floats into L2 ahead of their use (one prefetch a 128-byte line)
__device__ __forceinline__ void prefetch_l2(const float* p, int n) {
  for (int i = threadIdx.x * 32; i < n; i += FT * 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + i));
}

// the per-warp int sums v of rows [0, rows) (v[m] in every lane) -> sm.rsum
template <int MR>
__device__ __forceinline__ void block_rowsums(const Smem& sm, int rows, int (&v)[MR]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* part = reinterpret_cast<int*>(sm.fred);   // NW x 8
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    if (m >= rows) break;
    int s = v[m];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part[warp * 8 + m] = s;
  }
  csync();
  if (threadIdx.x < rows) {
    int s = 0;
    for (int w = 0; w < NW; ++w) s += part[w * 8 + threadIdx.x];
    sm.rsum[threadIdx.x] = s;
  }
  csync();
}

// dst[0, n) = the rows of a (·, K) fp32 buffer written in this launch, then
// nw (K) and nb (K): rows·K + 2K floats into shared memory, 32 loads a thread
// in flight before any store (one round trip at B = 1, K = 2048).
__device__ __forceinline__ void stage_norm_inputs(float* dst, const float* x, int rows, int K,
                                                  const float* nw, const float* nb) {
  constexpr int NB = 32;
  const int nx = rows * K, n = nx + 2 * K;
  for (int i0 = threadIdx.x; i0 < n; i0 += NB * FT) {
    float v[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int i = i0 + j * FT;
      const float* src = i < nx ? x + i : i < nx + K ? nw + (i - nx) : nb + (i - nx - K);
      v[j] = i < n ? __ldcg(src) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (i0 + j * FT < n) dst[i0 + j * FT] = v[j];
  }
  csync();
}

// stage_norm_quant over rows [0, rows) of src with its inputs staged in
// shared memory first (xs: rows·K + 2K floats), fq16(x) kept there: the same
// fp32 operations in the same order, so the same bytes. Each thread takes 8
// values at a time (rint_div_n); the row sums come with the quantization.
template <int MR>
__device__ void stage_norm_ring(const Smem& sm, float* xs, const float* src, int rows, int K,
                                const float* nw, const float* nb, float fs, float fo,
                                float fqmax, float eps, float hs, float ho, bool ln) {
  constexpr int U = 8;
  stage_norm_inputs(xs, src, rows, K, nw, nb);
  const float fr = 1.0f / fs, hr = 1.0f / hs;
  const int n = rows * K;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * FT) {
    float v[U], q[U];
#pragma unroll
    for (int j = 0; j < U; ++j) v[j] = i0 + j * FT < n ? xs[i0 + j * FT] : 0.0f;
    rint_div_n<U>(q, v, fs, fr);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float qq = fminf(fmaxf(q[j] + fo, 0.0f), fqmax);
      if (i0 + j * FT < n) xs[i0 + j * FT] = fqmax > 0.5f ? (qq - fo) * fs : v[j];
    }
  }
  csync();
  const float* ws = xs + n;
  const float* bs = ws + K;
  auto val = [&](int m, int k) { return xs[m * K + k]; };
  if (ln)
    block_inv_std<MR>(sm, rows, K, eps, val);
  else
    block_inv_rms<MR>(sm, rows, K, eps, val);
  int rsum[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    rsum[m] = 0;
    if (m >= rows) break;
    const float r = sm.rn[m], mu = sm.mu[m];
    for (int k0 = threadIdx.x; k0 < K; k0 += U * FT) {
      float y[U], q[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int k = k0 + j * FT;
        y[j] = k >= K ? 0.0f : ln ? (val(m, k) - mu) * r * ws[k] + bs[k]
                                  : val(m, k) * r * ws[k] + bs[k];
      }
      rint_div_n<U>(q, y, hs, hr);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int k = k0 + j * FT;
        const int v8 = (int)(fminf(fmaxf(q[j] + ho, 0.0f), 255.0f) - 128.0f);
        if (k < K) {
          sm.act[m * K + k] = (int8_t)v8;
          rsum[m] += v8;
        }
      }
    }
  }
  block_rowsums<MR>(sm, rows, rsum);
}

// final norm (RMS, or LayerNorm with a.ln) + dynamic per-row A8 -> the head's
// int8 rows in sm.act, their row sums and scales (sm.sx)
template <int MR>
__device__ void stage_head_act(const Args& a, const Smem& sm, float* xs) {
  const int K = a.K;
  const float eps = a.meta[(size_t)(a.L - 1) * META + 3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_norm_inputs(xs, a.x_out, a.M, K, a.fnw, a.fnb);
  const float* ws = xs + a.M * K;
  const float* bs = ws + K;
  auto xv = [&](int m, int k) { return xs[m * K + k]; };
  const bool ln = a.ln;
  if (ln)
    block_inv_std<MR>(sm, a.M, K, eps, xv);
  else
    block_inv_rms<MR>(sm, a.M, K, eps, xv);
  auto yv = [&](int m, int k) {
    const float v = ln ? xv(m, k) - sm.mu[m] : xv(m, k);
    return v * sm.rn[m] * ws[k] + bs[k];
  };
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    float amax = 0.0f;
    if (m < a.M)
      for (int k = threadIdx.x; k < K; k += FT) amax = fmaxf(amax, fabsf(yv(m, k)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) sm.fred[warp * 8 + m] = amax;
  }
  csync();
  if (threadIdx.x < a.M) {
    float amax = 0.0f;
    for (int w = 0; w < NW; ++w) amax = fmaxf(amax, sm.fred[w * 8 + threadIdx.x]);
    sm.sx[threadIdx.x] = fmaxf(amax, 1e-8f) / 127.0f;
  }
  csync();
  constexpr int U = 8;
  int rsum[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    rsum[m] = 0;
    if (m >= a.M) break;
    const float scale = sm.sx[m], sr = 1.0f / scale;
    for (int k0 = threadIdx.x; k0 < K; k0 += U * FT) {
      float y[U], q[U];
#pragma unroll
      for (int j = 0; j < U; ++j) y[j] = k0 + j * FT < K ? yv(m, k0 + j * FT) : 0.0f;
      rint_div_n<U>(q, y, scale, sr);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int v8 = (int)fminf(fmaxf(q[j], -127.0f), 127.0f);
        if (k0 + j * FT < K) {
          sm.act[m * K + k0 + j * FT] = (int8_t)v8;
          rsum[m] += v8;
        }
      }
    }
  }
  block_rowsums<MR>(sm, a.M, rsum);
}

// One block an SM walks a fixed share of every matvec stage: an item is 32
// columns (32 bytes of each weight row: one DRAM sector) of one stage over the
// whole K range, so no partial sum leaves the block (no split-K meeting); a
// w13 item is its 32 w1 columns and then the w3 columns of the same gate
// outputs (two sub-items). Item i of a stage goes to block (i + off) mod G,
// off counting the items of every earlier stage of the launch, so the
// per-block bytes even out over a layer. A sub-item streams through a ring
// of shared-memory slots in chunks of RROWS weight rows (16 KB). A producer
// warp (threads FT.. FT + 31) walks the block's chunk stream and, for each
// slot the consumers release (an mbarrier a slot, "empty"), issues the next
// chunk's 16-byte cp.async copies, whose completion arrives on the slot's
// "full" mbarrier (cp.async.mbarrier.arrive.noinc): loads of the next stages
// and layers (the head's during the last layer) are in flight across the grid
// barriers, and a stage finds its chunks on chip when its barrier opens. The
// consumers (FT threads) never issue a copy: a fence of theirs would wait for
// every copy still in flight.
constexpr int RW = 32;                 // bytes (columns) of an item's row segment
constexpr int RROWS = 512;             // weight rows a chunk
constexpr int RCH = RW * RROWS;        // bytes a chunk (a ring slot)
constexpr int RING_MAX_SLOTS = 13;
constexpr int SMEM_MAX = 232448 - 1024;   // dynamic shared memory of a block (static beside)
enum { ST_QKV = 0, ST_O, ST_W13, ST_W2, ST_HEAD, ST_END };

// a place in the block's chunk stream: layer, stage, the block's it-th item
// of the stage, sub-item, chunk
struct RingPos {
  int l, st, it, sub, ch;
};

// The stages' shapes, computed once a launch (ring_plan_init): weight rows,
// row stride, items, sub-items, and the items of the layer's earlier stages
// (the head: 0); the items of a layer mod G.
struct RingPlan {
  int rows[5], N[5], nitems[5], nsub[5], pre[5], perG;
};
__shared__ RingPlan ring_plan;

// the stage's pack, by value (st is known only at run time; no address of the
// argument block is taken)
__device__ __forceinline__ W4 ring_pack(const Args& a, int st) {
  switch (st) {
    case ST_QKV: return a.qkv;
    case ST_O: return a.o;
    case ST_W13: return a.w13;
    default: return a.w2;
  }
}

__device__ void ring_plan_init(const Args& a) {
  if (threadIdx.x == 0) {
    RingPlan& P = ring_plan;
    int per = 0;
    for (int s = ST_QKV; s <= ST_W2; ++s) {
      const W4 p = ring_pack(a, s);
      P.rows[s] = p.bits == 4 ? p.kin >> 1 : p.kin;
      P.N[s] = p.n;
      P.nitems[s] = (s == ST_W13 ? a.F : p.n) / RW;
      P.nsub[s] = s == ST_W13 ? 2 : 1;
      P.pre[s] = per;
      per += P.nitems[s];
    }
    P.rows[ST_HEAD] = a.hbits == 4 ? a.K >> 1 : a.K;
    P.N[ST_HEAD] = a.Vp;
    P.nitems[ST_HEAD] = a.Vp / RW;
    P.nsub[ST_HEAD] = 1;
    P.pre[ST_HEAD] = 0;
    P.perG = per % gridDim.x;
  }
  __syncthreads();
}

// the block's first item of stage st, layer l (the head's layer is a.l1)
__device__ __forceinline__ int ring_first(const Args& a, int st, int l) {
  const int G = gridDim.x;
  const int before = ((l - a.l0) * ring_plan.perG + ring_plan.pre[st]) % G;
  return ((int)blockIdx.x + G - before) % G;
}

__device__ __forceinline__ int ring_nch(int st) {
  return (ring_plan.rows[st] + RROWS - 1) / RROWS;
}

// move p forward to a place that holds a chunk of this block (or ST_END)
__device__ __forceinline__ void ring_settle(const Args& a, RingPos& p) {
  while (p.st != ST_END) {
    if (ring_first(a, p.st, p.l) + p.it * (int)gridDim.x < ring_plan.nitems[p.st]) return;
    p.it = p.sub = p.ch = 0;
    if (p.st == ST_HEAD)
      p.st = ST_END;
    else if (++p.st == ST_HEAD && ++p.l < a.l1)
      p.st = ST_QKV;
    else if (p.st == ST_HEAD && !a.logits)
      p.st = ST_END;
  }
}

__device__ __forceinline__ void ring_advance(const Args& a, RingPos& p) {
  if (p.st == ST_END) return;
  if (++p.ch < ring_nch(p.st)) return;
  p.ch = 0;
  if (++p.sub < ring_plan.nsub[p.st]) return;
  p.sub = 0;
  ++p.it;
  ring_settle(a, p);
}

// row r of a chunk in its slot: 32-byte rows, each group of four rows (one
// 128-byte line) rotated by the group index, so that the matvec's lanes (the
// same row of four consecutive groups) hit distinct banks
__device__ __forceinline__ int ring_swz(int r) {
  return ((r >> 2) << 7) | ((((r & 3) ^ ((r >> 2) & 3))) << 5);
}

// mbarriers (shared::cta): init, arrive, the parity wait, and the arrive that
// fires when this thread's earlier cp.async copies have landed
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned long long* b) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}

// the matrix of stage st, layer l, and the first column of item `item`,
// sub-item `sub` (w13: its w3 columns sit F after the w1 columns)
__device__ __forceinline__ const int8_t* ring_matrix(const Args& a, int st, int l) {
  switch (st) {
    case ST_QKV: return a.qkv.wq + (size_t)l * ring_plan.rows[st] * ring_plan.N[st];
    case ST_O: return a.o.wq + (size_t)l * ring_plan.rows[st] * ring_plan.N[st];
    case ST_W13: return a.w13.wq + (size_t)l * ring_plan.rows[st] * ring_plan.N[st];
    case ST_W2: return a.w2.wq + (size_t)l * ring_plan.rows[st] * ring_plan.N[st];
    default: return a.hwq;
  }
}

// The producer warp: the block's chunk stream into the ring, slot after
// slot, each once the consumers have released it; lane-strided 16-byte
// copies of the chunk's RROWS rows of 32 bytes.
__device__ void ring_produce(const Args& a, int8_t* ring, int nslot, unsigned long long* full,
                             unsigned long long* empty) {
  const int lane = threadIdx.x & 31;
  RingPos p = RingPos{a.l0, ST_QKV, 0, 0, 0};
  ring_settle(a, p);
  for (int s = 0, k = 0; p.st != ST_END;) {
    mbar_wait(empty + s, (k & 1) ^ 1);
    const int item = ring_first(a, p.st, p.l) + p.it * (int)gridDim.x;
    const int col = (p.st == ST_W13 && p.sub ? a.F : 0) + RW * item;
    const int r0 = p.ch * RROWS, nr = min(RROWS, ring_plan.rows[p.st] - r0);
    const int N = ring_plan.N[p.st];
    const int8_t* src = ring_matrix(a, p.st, p.l) + (size_t)r0 * N + col;
    int8_t* slot = ring + (size_t)s * RCH;
    for (int i = lane; i < 2 * nr; i += 32) {
      const int r = i >> 1, h = (i & 1) << 4;
      cp_async16(slot + ring_swz(r) + h, src + (size_t)r * N + h, true);
    }
    cp_async_mbar_arrive(full + s);
    ring_advance(a, p);
    if (++s == nslot) {
      s = 0;
      ++k;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc[m][c] += act[m] · W[rows r0 .., column cg·CPL + c] over the nr rows of
// the chunk in slot: lane (qq, cg) takes rows 4q..4q+3 (q the quad), CPL
// columns; W4 packed row j is k = j (low nibble) and kin/2 + j (high), W8
// row j is k = j.
template <int MR, int WB>
__device__ __forceinline__ void ring_gemv(const Smem& sm, const int8_t* slot, int rows, int kin,
                                          int r0, int nr, int (&acc)[MR][Cfg<MR>::CPL]) {
  constexpr int CPL = Cfg<MR>::CPL, NWD = CPL / 4, NCG = RW / CPL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = lane % NCG, qq = lane / NCG;
  const int k2 = kin >> 1;
  for (int q = warp * CPL + qq; 4 * q < nr; q += NW * CPL) {
    int r[4][NWD];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* pr = slot + (q << 7) + ((i ^ (q & 3)) << 5) + cg * CPL;
      if constexpr (NWD == 4) {
        const int4 v = *reinterpret_cast<const int4*>(pr);
        r[i][0] = v.x;
        r[i][1] = v.y;
        r[i][2] = v.z;
        r[i][3] = v.w;
      } else if constexpr (NWD == 2) {
        const int2 v = *reinterpret_cast<const int2*>(pr);
        r[i][0] = v.x;
        r[i][1] = v.y;
      } else {
        r[i][0] = *reinterpret_cast<const int*>(pr);
      }
    }
    int cw[NWD][4], chi[NWD][4];
#pragma unroll
    for (int wd = 0; wd < NWD; ++wd) {
      const int rr[4] = {r[0][wd], r[1][wd], r[2][wd], r[3][wd]};
      transpose4x4(rr, cw[wd]);
      if constexpr (WB == 4) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          chi[wd][c] = (int)(((unsigned)cw[wd][c] >> 4) & NIB);
          cw[wd][c] &= (int)NIB;
        }
      }
    }
    const int k = r0 + 4 * q;
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m >= rows) break;
      const int xl = *reinterpret_cast<const int*>(sm.act + m * kin + k);
      if constexpr (WB == 4) {
        const int xh = *reinterpret_cast<const int*>(sm.act + m * kin + k2 + k);
#pragma unroll
        for (int wd = 0; wd < NWD; ++wd)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int& s = acc[m][wd * 4 + c];
            s = __dp4a(cw[wd][c], xl, s);
            s = __dp4a(chi[wd][c], xh, s);
          }
      } else {
#pragma unroll
        for (int wd = 0; wd < NWD; ++wd)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            int& s = acc[m][wd * 4 + c];
            s = __dp4a(cw[wd][c], xl, s);
          }
      }
    }
  }
}

struct RingSmem {
  Smem s;
  int* sred;     // NW x MR x RW per-warp column sums
  float* gbuf;   // MR x RW: a w13 item's w1 outputs until its w3 half
  float* xs;     // a norm's staged inputs: MR x K rows, then its w and b (K each)
  int8_t* ring;  // nslot x RCH
  unsigned long long *full, *empty;   // a slot's mbarriers
};

struct RingState {
  RingPos pc;       // the consume place
  int nslot, cons;  // slots, the slot of the next chunk to consume
  int round;        // how often the consumers have wrapped around the ring
};

// the per-column epilogue values a thread loads when a sub-item begins
struct RingVec {
  float v[8];
};

// Consume this block's chunks of stage st, layer l (the head: l = a.l1): the
// matvec over the activation rows staged in sm.act (kin wide); at a
// sub-item's first chunk vload(item, sub, c, vec) in thread (m, c) = (tid /
// RW, tid % RW) (loads whose latency the chunks hide); after its last chunk
// the block's column sums, then epi(m, c, sum, item, sub, vec) for rows m <
// a.M. A slot goes back to the producer as soon as its matvec has read it.
template <int MR, int WB, typename VLoad, typename Epi>
__device__ __forceinline__ void ring_stage(const Args& a, const RingSmem& rs, RingState& S,
                                           int st, int l, int kin, VLoad vload, Epi epi) {
  constexpr int CPL = Cfg<MR>::CPL, NCG = RW / CPL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int em = tid / RW, ec = tid % RW;
  int acc[MR][CPL];
  RingVec vec;
  while (S.pc.st == st && S.pc.l == l) {
    const int item = ring_first(a, st, l) + S.pc.it * (int)gridDim.x;
    const int r0 = S.pc.ch * RROWS, nr = min(RROWS, ring_plan.rows[st] - r0);
    const int8_t* slot = rs.ring + (size_t)S.cons * RCH;
    if (S.pc.ch == 0) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[m][c] = 0;
      if (em < a.M) vload(item, S.pc.sub, ec, vec);
    }
    mbar_wait(rs.full + S.cons, S.round & 1);
    ring_gemv<MR, WB>(rs.s, slot, a.M, kin, r0, nr, acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(rs.empty + S.cons);
    if (r0 + nr == ring_plan.rows[st]) {
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        if (m >= a.M) break;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          int v = acc[m][c];
#pragma unroll
          for (int o = NCG; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane < NCG) rs.sred[(warp * MR + m) * RW + lane * CPL + c] = v;
        }
      }
      csync();
      if (em < a.M) {
        int sum = 0;
        for (int w = 0; w < NW; ++w) sum += rs.sred[(w * MR + em) * RW + ec];
        epi(em, ec, sum, item, S.pc.sub, vec);
      }
      csync();
    }
    ring_advance(a, S.pc);
    if (++S.cons == S.nslot) {
      S.cons = 0;
      ++S.round;
    }
  }
}

__device__ __forceinline__ bool ring_has(const RingState& S, int st, int l) {
  return S.pc.st == st && S.pc.l == l;
}

// the affine bracket's vectors of column col of a pack, layer l: v[0..3] =
// scale, offset, colsum, bias (0 without one)
__device__ __forceinline__ void ring_vload(const W4& p, int l, int col, float* v) {
  const size_t si = (size_t)l * p.s_l + (size_t)col * p.s_c;
  v[0] = __ldg(p.scale + si);
  v[1] = __ldg(p.offset + si);
  v[2] = __ldg(p.colsum + (size_t)l * p.n + col);
  v[3] = p.bias ? __ldg(p.bias + (size_t)l * p.n + col) : 0.0f;
}

// affine() on the loaded vectors, in its fp32 order
__device__ __forceinline__ float ring_affine(bool bias, const float* v, int acc, float rowsum,
                                             float xs, float ox, float kox) {
  float y = (float)acc - ox * v[2] - v[1] * rowsum + kox * v[1];
  y = y * (xs * v[0]);
  if (bias) y = y + v[3];
  return y;
}

// Generation-free grid barrier: bar[2] counts arrivals over the whole launch
// (the n-th barrier waits for n·G of them), so nothing is reset between
// barriers; ring_exit zeroes it once every block has passed its last one.
// Needs every block resident (cooperative launch).
__device__ __forceinline__ void ring_barrier(unsigned* bar, unsigned n) {
  csync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar + 2, 1u);
    const unsigned target = n * gridDim.x;
    volatile unsigned* c = bar + 2;
    while (*c < target) __nanosleep(20);
    __threadfence();
  }
  csync();
}

__device__ __forceinline__ void ring_exit(unsigned* bar) {
  if (threadIdx.x == 0 && atomicAdd(bar + 3, 1u) == gridDim.x - 1) {
    atomicExch(bar + 2, 0u);
    atomicExch(bar + 3, 0u);
  }
}

__shared__ unsigned long long ring_bars[2 * RING_MAX_SLOTS];

template <int MR, int WB, int DPL>
__global__ void __launch_bounds__(FT + 32, 1)
fused_decode_kernel(const Args a, int kmax, int nslot, int ring_off) {
  RingSmem rs;
  rs.s = carve(MR, kmax);
  rs.sred = rs.s.red;
  rs.gbuf = reinterpret_cast<float*>(rs.s.red + NW * MR * RW);
  rs.xs = reinterpret_cast<float*>(rs.s.act + MR * a.K);
  rs.ring = reinterpret_cast<int8_t*>(rs.s.meta) + ring_off;
  rs.full = ring_bars;
  rs.empty = ring_bars + RING_MAX_SLOTS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < nslot; ++s) {
      mbar_init(rs.full + s, 32);        // the producer lanes' cp.async arrivals
      mbar_init(rs.empty + s, NW);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  ring_plan_init(a);                     // ends in __syncthreads (every thread)
  if (threadIdx.x >= FT) {
    ring_produce(a, rs.ring, nslot, rs.full, rs.empty);
    return;
  }
  const Smem& sm = rs.s;
  RingState S;
  S.nslot = nslot;
  S.cons = 0;
  S.round = 0;
  S.pc = RingPos{a.l0, ST_QKV, 0, 0, 0};
  ring_settle(a, S.pc);
  stamp(a, 0);
  int ts = 1;
  unsigned nb = 0;
  const int K = a.K, F = a.F, Nq = a.qkv.n, Ko = a.o.kin;
  for (int l = a.l0; l < a.l1; ++l) {
    const float* m = a.meta + (size_t)l * META;
    const float* mm = m + AM;
    const float* xin = l == a.l0 ? a.x_in : a.x_out;
    // 1. norm1 + quantize + qkv + affine + per-column output fq -> yq
    if (ring_has(S, ST_QKV, l))
      stage_norm_ring<MR>(sm, rs.xs, xin, a.M, K, a.anw + (size_t)l * K, a.anb + (size_t)l * K,
                          m[0], m[1], m[2], m[3], m[4], m[5], a.ln);
    // the next norm's vectors into L2 (read after the attention and o stages)
    prefetch_l2(a.mnw + (size_t)l * K, K);
    prefetch_l2(a.mnb + (size_t)l * K, K);
    {
      const float xs = m[4], ox = m[5] - 128.0f, kox = (float)K * ox;
      const bool bias = a.qkv.bias;
      ring_stage<MR, WB>(
          a, rs, S, ST_QKV, l, K,
          [&](int item, int, int c, RingVec& v) {
            const int col = RW * item + c;
            ring_vload(a.qkv, l, col, v.v);
#pragma unroll
            for (int j = 0; j < 4; ++j) v.v[4 + j] = __ldg(a.ofq + ((size_t)l * 4 + j) * Nq + col);
          },
          [&](int r, int c, int acc, int item, int, const RingVec& v) {
            float y = ring_affine(bias, v.v, acc, (float)sm.rsum[r], xs, ox, kox);
            const float fs = v.v[4], fo = v.v[5], fc = v.v[6], fe = v.v[7];
            float q = rintf(y / fs) + fo;
            q = fminf(fmaxf(q, 0.0f), fc);
            if (fe > 0.5f) y = (q - fo) * fs;
            a.yq[(size_t)r * Nq + RW * item + c] = y;
          });
    }
    ring_barrier(a.bar, ++nb);
    stamp(a, ts++);
    // 2. attention -> a8
    stage_attention<DPL>(a, sm, l);
    ring_barrier(a.bar, ++nb);
    stamp(a, ts++);
    // 3. o-proj + output fq + resid_add_1 -> resid
    if (ring_has(S, ST_O, l)) stage_copy(sm, a.a8, 0, a.M, Ko);
    {
      const float xs = m[19], ox = m[20] - 128.0f, kox = (float)Ko * ox;
      const float r21 = 1.0f / m[21], r24 = 1.0f / m[24], r27 = 1.0f / m[27],
                  r30 = 1.0f / m[30];
      const bool bias = a.o.bias;
      ring_stage<MR, WB>(
          a, rs, S, ST_O, l, Ko,
          [&](int item, int, int c, RingVec& v) {
            ring_vload(a.o, l, RW * item + c, v.v);
            v.v[4] = __ldcg(xin + (size_t)(threadIdx.x / RW) * K + RW * item + c);   // x[r, col]
          },
          [&](int r, int c, int acc, int item, int, const RingVec& v) {
            const int col = RW * item + c;
            float y = ring_affine(bias, v.v, acc, (float)sm.rsum[r], xs, ox, kox);
            y = fqm_r(y, m[21], r21, m[22], m[23]);
            const float xr = fqm_r(v.v[4], m[24], r24, m[25], m[26]);
            y = fqm_r(y, m[27], r27, m[28], m[29]);
            a.resid[(size_t)r * K + col] = fqm_r(xr + y, m[30], r30, m[31], m[32]);
          });
    }
    ring_barrier(a.bar, ++nb);
    stamp(a, ts++);
    // 4. norm2 + quantize + w13 with the gate chain -> act8
    if (ring_has(S, ST_W13, l))
      stage_norm_ring<MR>(sm, rs.xs, a.resid, a.M, K, a.mnw + (size_t)l * K,
                          a.mnb + (size_t)l * K, mm[16], mm[17], mm[18], mm[19], mm[0], mm[1],
                          a.ln);
    {
      const float xs = mm[0], ox = mm[1] - 128.0f, kox = (float)K * ox;
      const float r2 = 1.0f / mm[2], r5 = 1.0f / mm[5], r8 = 1.0f / mm[8], r11 = 1.0f / mm[11],
                  r14 = 1.0f / mm[14];
      const bool bias = a.w13.bias;
      ring_stage<MR, WB>(
          a, rs, S, ST_W13, l, K,
          [&](int item, int sub, int c, RingVec& v) {
            ring_vload(a.w13, l, (sub ? F : 0) + RW * item + c, v.v);
          },
          [&](int r, int c, int acc, int item, int sub, const RingVec& v) {
            const float rsum = (float)sm.rsum[r];
            float* g1p = rs.gbuf + r * RW + c;
            if (!sub) {
              *g1p = fqm_r(ring_affine(bias, v.v, acc, rsum, xs, ox, kox), mm[2], r2, mm[3],
                           mm[4]);
              return;
            }
            const float g1 = *g1p;
            float act;
            if (!a.gelu) {
              float sig = 1.0f / (1.0f + expf(-g1));
              sig = fqm_r(sig, mm[5], r5, mm[6], mm[7]);
              act = g1 * sig;
            } else {
              const float u = 0.7978845608028654f * (g1 + 0.044715f * g1 * g1 * g1);
              act = 0.5f * g1 * (1.0f + tanhf(u));
            }
            act = fqm_r(act, mm[8], r8, mm[9], mm[10]);
            float g3 = ring_affine(bias, v.v, acc, rsum, xs, ox, kox);
            g3 = fqm_r(g3, mm[11], r11, mm[12], mm[13]);
            a.act8[(size_t)r * F + RW * item + c] =
                (int8_t)(int)quant_u8s_r(act * g3, mm[14], r14, mm[15]);
          });
    }
    ring_barrier(a.bar, ++nb);
    stamp(a, ts++);
    // 5. w2 + output fq + resid_add_2 -> x
    if (ring_has(S, ST_W2, l)) stage_copy(sm, a.act8, 0, a.M, F);
    {
      // the next norm's vectors into L2 (the next layer's norm1, or the head's)
      const bool more = l + 1 < a.l1;
      const int nv = more || a.logits ? K : 0;
      prefetch_l2(more ? a.anw + (size_t)(l + 1) * K : a.fnw, nv);
      prefetch_l2(more ? a.anb + (size_t)(l + 1) * K : a.fnb, nv);
    }
    {
      const float xs = mm[14], ox = mm[15] - 128.0f, kox = (float)F * ox;
      const float r20 = 1.0f / mm[20], r23 = 1.0f / mm[23], r26 = 1.0f / mm[26],
                  r29 = 1.0f / mm[29];
      const bool bias = a.w2.bias;
      ring_stage<MR, WB>(
          a, rs, S, ST_W2, l, F,
          [&](int item, int, int c, RingVec& v) {
            ring_vload(a.w2, l, RW * item + c, v.v);
            v.v[4] = __ldcg(a.resid + (size_t)(threadIdx.x / RW) * K + RW * item + c);
          },
          [&](int r, int c, int acc, int item, int, const RingVec& v) {
            const int col = RW * item + c;
            float y = ring_affine(bias, v.v, acc, (float)sm.rsum[r], xs, ox, kox);
            y = fqm_r(y, mm[20], r20, mm[21], mm[22]);
            const float xr = fqm_r(v.v[4], mm[23], r23, mm[24], mm[25]);
            y = fqm_r(y, mm[26], r26, mm[27], mm[28]);
            a.x_out[(size_t)r * K + col] = fqm_r(xr + y, mm[29], r29, mm[30], mm[31]);
          });
    }
    if (l + 1 < a.l1 || a.logits || a.trace) ring_barrier(a.bar, ++nb);
    stamp(a, ts++);
  }
  if (a.logits) {
    // the head: logits = (acc − o_w·rowsum)·(s_x·s_w)
    if (ring_has(S, ST_HEAD, a.l1)) stage_head_act<MR>(a, sm, rs.xs);
    const int Vp = a.Vp;
    auto vload = [&](int item, int, int c, RingVec& v) {
      v.v[0] = __ldg(a.hscale + RW * item + c);
      v.v[1] = __ldg(a.hoffset + RW * item + c);
    };
    auto epi = [&](int r, int c, int acc, int item, int, const RingVec& v) {
      a.logits[(size_t)r * Vp + RW * item + c] =
          ((float)acc - v.v[1] * (float)sm.rsum[r]) * (sm.sx[r] * v.v[0]);
    };
    if (a.hbits == 8)
      ring_stage<MR, 8>(a, rs, S, ST_HEAD, a.l1, K, vload, epi);
    else
      ring_stage<MR, 4>(a, rs, S, ST_HEAD, a.l1, K, vload, epi);
    if (a.trace) ring_barrier(a.bar, ++nb);
    stamp(a, ts);
  }
  ring_exit(a.bar);
}

template <int MR, int WB>
__global__ void __launch_bounds__(FT)
fused_mlp_block_kernel(const Args a, int kmax) {
  const Smem sm = carve(MR, kmax);
  if (threadIdx.x < 32) sm.meta[threadIdx.x] = a.mlp_meta[threadIdx.x];
  csync();
  stage_w13<MR, WB>(a, sm, a.l0, sm.meta, a.x_in);
  grid_barrier(a.bar);
  stage_w2<MR, WB>(a, sm, a.l0, sm.meta, a.x_in, a.x_out);
}

// the MLP-block kernel's shared memory: the small arrays, MR activation rows
// and the MR x TC tile sums
size_t smem_bytes(int MR, int kmax) {
  const int tc = 32 * (MR <= 2 ? 16 : (MR <= 4 ? 8 : 4));   // Cfg<MR>::TC
  return SMALL + (size_t)MR * kmax + (size_t)MR * tc * 4;
}

// The ring kernel's shared memory below its ring (the offset of the ring):
// the small arrays, then one region that is the matvec stages' MR activation
// rows, per-warp column sums and w13 buffer, or a norm's MR int8 output rows
// and its staged inputs (MR + 2 fp32 rows of K), or the attention stage's
// rows, partials, q words, scores and K / V chunk; rounded up to 128 bytes.
// ops/fused_layer.ring_smem mirrors it.
size_t ring_base(const Args& a, int MR, int kmax) {
  const size_t mm = (size_t)MR * kmax + (size_t)NW * MR * RW * 4 + (size_t)MR * RW * 4;
  const size_t nm = (size_t)MR * a.K + (size_t)(MR + 2) * a.K * 4;
  const size_t mv = mm > nm ? mm : nm;
  const size_t qwords = a.hd <= 128 ? 32 : 64;   // stage_attention's q words (8 DPL)
  const size_t at = (size_t)a.hd * 24 + (size_t)NW * a.hd * 8 + 4 * qwords
                    + (size_t)a.S * 4 + (size_t)KV_CHUNK * a.hd;
  const size_t big = mv > at ? mv : at;
  return SMALL + (big + 127) / 128 * 128;
}

int kmax_of(const Args& a) {
  int k = a.K;
  if (a.Hq * a.hd > k) k = a.Hq * a.hd;
  if (a.F > k) k = a.F;
  return (k + 15) / 16 * 16;
}

// One block an SM, every block resident (cooperative launch), the ring as
// many slots as the rest of the SM's shared memory holds (so that no second
// block fits beside it).
template <typename KernelT>
int launch_ring(KernelT kern, const Args& a, int kmax, size_t base, cudaStream_t st) {
  if (base + 2 * (size_t)RCH > SMEM_MAX) return (int)cudaErrorInvalidValue;
  int nslot = (int)((SMEM_MAX - base) / RCH);
  if (nslot > RING_MAX_SLOTS) nslot = RING_MAX_SLOTS;
  const size_t smem = base + (size_t)nslot * RCH;
  int dev = 0;
  cudaGetDevice(&dev);
  int coop = 0, sms = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, FT + 32, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args acopy = a;
  int ring_off = (int)base;
  void* params[] = {(void*)&acopy, (void*)&kmax, (void*)&nslot, (void*)&ring_off};
  e = cudaLaunchCooperativeKernel((void*)kern, dim3(sms), dim3(FT + 32), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int WB, int DPL>
int launch_decode(const Args& a, int kmax, cudaStream_t st) {
  if (a.M <= 1)
    return launch_ring(fused_decode_kernel<1, WB, DPL>, a, kmax, ring_base(a, 1, kmax), st);
  if (a.M <= 2)
    return launch_ring(fused_decode_kernel<2, WB, DPL>, a, kmax, ring_base(a, 2, kmax), st);
  if (a.M <= 4)
    return launch_ring(fused_decode_kernel<4, WB, DPL>, a, kmax, ring_base(a, 4, kmax), st);
  if (a.M <= 8)
    return launch_ring(fused_decode_kernel<8, WB, DPL>, a, kmax, ring_base(a, 8, kmax), st);
  return (int)cudaErrorInvalidValue;
}

template <int WB>
int launch_mlp_block(const Args& a, int kmax, cudaStream_t st) {
  if (a.M <= 1)
    return launch_coop(fused_mlp_block_kernel<1, WB>, a, kmax, smem_bytes(1, kmax), st);
  if (a.M <= 2)
    return launch_coop(fused_mlp_block_kernel<2, WB>, a, kmax, smem_bytes(2, kmax), st);
  if (a.M <= 4)
    return launch_coop(fused_mlp_block_kernel<4, WB>, a, kmax, smem_bytes(4, kmax), st);
  if (a.M <= 8)
    return launch_coop(fused_mlp_block_kernel<8, WB>, a, kmax, smem_bytes(8, kmax), st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The whole-model and whole-layer kernels' head-dim-256 editions (8 dims a
// lane in the attention stage), instantiated in fused_layer_hd256.cu so that
// the build compiles them beside the others; mqt_fused_decode checks the
// arguments.
int mqt_layer_decode_hd256(const MqtFusedArgs& a, int kmax, cudaStream_t st);
