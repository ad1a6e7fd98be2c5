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
// One cooperative, persistent launch (cudaLaunchCooperativeKernel, one or two
// blocks per SM, all resident) runs every stage; a grid-wide barrier separates
// dependent stages. Per layer (mqt_fused_decode):
//   1. norm1 + quantize (each block, redundantly: a (B, K) norm costs less
//      than a barrier) -> qkv W4 matvec over 128-column tiles -> affine
//      bracket -> per-column output fake-quant -> yq (B, Nq) fp32   | barrier
//   2. attention, one work item per (sequence, q head): RoPE with the partner
//      column, joint segment quantization (the group's first q head writes
//      the new K/V rows to kv_new), int scores over the stale cache rows
//      [0, pos) staged through shared memory, the explicit self term, softmax
//      with its fake-quant sites across the block, P·V plus the self term,
//      pv-output quantize -> a8 (B, Ko) int8                         | barrier
//   3. o-proj matvec -> output fq -> resid_add_1 -> resid (B, K)     | barrier
//   4. norm2 + quantize (redundant) -> w13 matvec, one tile holding the w1
//      and the w3 columns of 64 gate outputs (they sit F apart) -> gate chain
//      -> act8 (B, F) int8                                           | barrier
//   5. w2 matvec -> output fq -> resid_add_2 -> x (B, K)             | barrier
// then, with a head, the final norm, dynamic per-row A8 and the W4 head over
// 128-column vocab tiles -> logits (B, Vp). mqt_fused_mlp_block runs stages
// 4-5 for M <= 8 rows, with one barrier (the MLP-block wrapper takes it up to
// ops/mlp_block.DP4A_ROWS rows, fused_rows.cu above).
//
// Split-K: a matvec tile's K range is split over blocks so that every stage
// fills the card; each block adds its int32 partials into a workspace with
// integer atomics (exact, so the result does not depend on arrival order);
// the last block of a tile to arrive reads the totals back, zeroes them and
// runs the epilogue, so the workspace is all zero again after every launch.
// Buffers written inside the launch are read with __ldcg (L2), never through
// the non-coherent read-only path.
//
// Bound: device-memory bytes. At B <= 8 one decode step streams every packed
// weight byte once (518 MB for TinyLlama-1.1B with its W4 head, 1,036 MB
// with W8 layers and a W8 head) plus the valid KV rows; the integer work is
// a few GOP. This is the simple SIMT + dp4a edition: a warp streams 32·CPL
// contiguous bytes of each weight row (CPL = 16 columns per lane at B <= 2);
// 4x4 byte transposes put 4 consecutive k of a column in one dp4a operand
// (W4: then the nibble masks; W8 reads twice the rows, low rows j and high
// rows j + kin/2 of a group, so the activation words are those of W4), and
// scores live in shared memory. Tensor cores, TMA, cp.async pipelining and
// fewer grid barriers are later work.
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
  __syncthreads();
  if (ks == 1) return true;
  int* acc = ws + CNT;
  for (int i = threadIdx.x; i < rows * TC; i += FT) {
    const int m = i / TC, n = i % TC;
    if (t.valid(n)) atomicAdd(&acc[(size_t)(row0 + m) * N + t.gcol(n)], sm.red[i]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm.flags[0] = (atomicAdd(&ws[tid_], 1) == ks - 1);
  __syncthreads();
  if (!sm.flags[0]) return false;
  __threadfence();
  for (int i = threadIdx.x; i < rows * TC; i += FT) {
    const int m = i / TC, n = i % TC;
    if (t.valid(n)) sm.red[i] = atomicExch(&acc[(size_t)(row0 + m) * N + t.gcol(n)], 0);
  }
  if (threadIdx.x == 0) ws[tid_] = 0;
  __syncthreads();
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
  __syncthreads();
  stage_rowsums(sm, rows, kin);
  __syncthreads();
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
  __syncthreads();
  if (threadIdx.x < rows) {
    double t = 0.0;
    for (int w = 0; w < NW; ++w) t += sm.dred[w * 8 + threadIdx.x];
    sm.rn[threadIdx.x] = 1.0f / sqrtf((float)t / (float)K + eps);
  }
  __syncthreads();
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
  __syncthreads();
  if (threadIdx.x < rows) {
    double t = 0.0;
    for (int w = 0; w < NW; ++w) t += sm.dred[w * 8 + threadIdx.x];
    sm.mu[threadIdx.x] = (float)t / (float)K;
  }
  __syncthreads();
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
  __syncthreads();
  stage_rowsums(sm, rows, K);
  __syncthreads();
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

// 1. norm1 + quantize + qkv matvec + affine + per-column output fq -> yq
template <int MR, int WB>
__device__ void stage_qkv(const Args& a, const Smem& sm, int l) {
  constexpr int TC = Cfg<MR>::TC;
  const float* m = a.meta + (size_t)l * META;
  const int N = a.qkv.n, K = a.K;
  const int tiles = (N + TC - 1) / TC;
  int ks, gpb;
  pick_ks(tiles, K, ks, gpb);
  const float* xin = l == a.l0 ? a.x_in : a.x_out;
  bool staged = false;
  const float xs = m[4], ox = m[5] - 128.0f, kox = (float)K * ox;
  const int8_t* w = layer_w<WB>(a.qkv, l);
  const float* ofq = a.ofq + (size_t)l * 4 * N;
  for (int it = blockIdx.x; it < tiles * ks; it += gridDim.x) {
    if (!staged) {
      stage_norm_quant<MR>(sm, xin, 0, a.M, K, a.anw + (size_t)l * K, a.anb + (size_t)l * K,
                           m[0], m[1], m[2], m[3], m[4], m[5], a.ln);
      staged = true;
    }
    const int tile = it / ks, sp = it % ks;
    const Tile t = plain_tile<MR>(tile, N);
    for (int i = threadIdx.x; i < MR * TC; i += FT) sm.red[i] = 0;
    __syncthreads();
    gemv_partial<MR, WB>(sm, a.M, K, w, N, t, sp * gpb, min((K >> 3), (sp + 1) * gpb));
    if (!finish_tile<TC>(sm, a.ws, tile, ks, a.M, 0, N, t)) continue;
    for (int i = threadIdx.x; i < a.M * TC; i += FT) {
      if (!t.valid(i % TC)) continue;
      const int r = i / TC, col = t.colA + i % TC;
      float y = affine(a.qkv, l, sm.red[i], col, (float)sm.rsum[r], xs, ox, kox);
      const float fs = ofq[col], fo = ofq[N + col];
      const float fc = ofq[2 * N + col], fe = ofq[3 * N + col];
      float q = rintf(y / fs) + fo;
      q = fminf(fmaxf(q, 0.0f), fc);
      if (fe > 0.5f) y = (q - fo) * fs;
      a.yq[(size_t)r * N + col] = y;
    }
    __syncthreads();
  }
}


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
    __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
    // int scores over the stale cache rows [0, P); rows >= P are masked by
    // neg_inf (-40000 or lower) and their exp is exactly 0, so they are skipped
    const int8_t* kc = a.kcache + (((size_t)l * B + b) * Hkv + h) * (size_t)S * hd;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      stage_rows(kvs, kc + (size_t)c0 * hd, nr * hd);
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
    __syncthreads();
    // softmax over [cache rows, self term] across the block
    float mx = __int_as_float(0xff800000);     // -inf
    for (int s = threadIdx.x; s < P; s += FT) mx = fmaxf(mx, sc[s]);
    mx = fmaxf(block_max(mx, sm.fred), sself);
    double dsum = 0.0;
    for (int s = threadIdx.x; s < P; s += FT) {
      const float ev = expf(sc[s] - mx);
      sc[s] = ev;
      dsum += (double)ev;
    }
    const float es = expf(sself - mx);
    const float den = block_sum(dsum, sm.dred) + es;
    double psd = 0.0;
    for (int s = threadIdx.x; s < P; s += FT) {
      const float p = fqm(sc[s] / den, m[15], m[16], m[17]);
      sc[s] = p;
      psd += (double)p;
    }
    const float psum = block_sum(psd, sm.dred);
    const float ps = fqm(es / den, m[15], m[16], m[17]);
    // P·V over the cache rows (warp w takes rows w, w + NW, ...; lanes over
    // head_dim), then the fp64 partials meet in shared memory
    const int8_t* vc = a.vcache + (((size_t)l * B + b) * Hkv + h) * (size_t)S * hd;
    double acc[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] = 0.0;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      stage_rows(kvs, vc + (size_t)c0 * hd, nr * hd);
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
    __syncthreads();
    for (int d = threadIdx.x; d < hd; d += FT) {
      double t = 0.0;
      for (int w = 0; w < NW; ++w) t += part[w * hd + d];
      const float vnf = (q8[2 * hd + d] + 128.0f - m[11]) * sv;
      const float at = ((float)t - ov * psum) * sv + ps * vnf;
      a.a8[(size_t)b * Ko + qh * hd + d] = (int8_t)(int)quant_u8s(at, m[19], m[20]);
    }
    __syncthreads();
  }
}

// 3. o-proj + output fq + resid_add_1 -> resid
template <int MR, int WB>
__device__ void stage_o(const Args& a, const Smem& sm, int l) {
  constexpr int TC = Cfg<MR>::TC;
  const float* m = a.meta + (size_t)l * META;
  const int K = a.K, Ko = a.o.kin, N = a.o.n;
  const int tiles = (N + TC - 1) / TC;
  int ks, gpb;
  pick_ks(tiles, Ko, ks, gpb);
  const float* xin = l == a.l0 ? a.x_in : a.x_out;
  const float xs = m[19], ox = m[20] - 128.0f, kox = (float)Ko * ox;
  const int8_t* w = layer_w<WB>(a.o, l);
  bool staged = false;
  for (int it = blockIdx.x; it < tiles * ks; it += gridDim.x) {
    if (!staged) {
      stage_copy(sm, a.a8, 0, a.M, Ko);
      staged = true;
    }
    const int tile = it / ks, sp = it % ks;
    const Tile t = plain_tile<MR>(tile, N);
    for (int i = threadIdx.x; i < MR * TC; i += FT) sm.red[i] = 0;
    __syncthreads();
    gemv_partial<MR, WB>(sm, a.M, Ko, w, N, t, sp * gpb, min((Ko >> 3), (sp + 1) * gpb));
    if (!finish_tile<TC>(sm, a.ws, tile, ks, a.M, 0, N, t)) continue;
    for (int i = threadIdx.x; i < a.M * TC; i += FT) {
      if (!t.valid(i % TC)) continue;
      const int r = i / TC, col = t.colA + i % TC;
      float y = affine(a.o, l, sm.red[i], col, (float)sm.rsum[r], xs, ox, kox);
      y = fqm(y, m[21], m[22], m[23]);
      const float xr = fqm(__ldcg(xin + (size_t)r * K + col), m[24], m[25], m[26]);
      y = fqm(y, m[27], m[28], m[29]);
      a.resid[(size_t)r * K + col] = fqm(xr + y, m[30], m[31], m[32]);
    }
    __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
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
    __syncthreads();
  }
}

// final norm (RMS, or LayerNorm with a.ln) + dynamic per-row A8 + the W4 or
// W8 head (a.hbits) -> logits
template <int MR>
__device__ void stage_head(const Args& a, const Smem& sm) {
  constexpr int TC = Cfg<MR>::TC;
  const int K = a.K, N = a.Vp;
  const int tiles = (N + TC - 1) / TC;
  int ks, gpb;
  pick_ks(tiles, K, ks, gpb);
  const float eps = a.meta[(size_t)(a.L - 1) * META + 3];
  bool staged = false;
  for (int it = blockIdx.x; it < tiles * ks; it += gridDim.x) {
    if (!staged) {
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      auto xv = [&](int m, int k) { return __ldcg(a.x_out + (size_t)m * K + k); };
      const bool ln = a.ln;
      if (ln)
        block_inv_std<MR>(sm, a.M, K, eps, xv);
      else
        block_inv_rms<MR>(sm, a.M, K, eps, xv);
      auto yv = [&](int m, int k) {
        const float v = ln ? xv(m, k) - sm.mu[m] : xv(m, k);
        return v * sm.rn[m] * __ldg(a.fnw + k) + __ldg(a.fnb + k);
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
      __syncthreads();
      if (threadIdx.x < a.M) {
        float amax = 0.0f;
        for (int w = 0; w < NW; ++w) amax = fmaxf(amax, sm.fred[w * 8 + threadIdx.x]);
        sm.sx[threadIdx.x] = fmaxf(amax, 1e-8f) / 127.0f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        if (m >= a.M) break;
        const float scale = sm.sx[m];
#pragma unroll 4
        for (int k = threadIdx.x; k < K; k += FT) {
          const float q = fminf(fmaxf(rintf(yv(m, k) / scale), -127.0f), 127.0f);
          sm.act[m * K + k] = (int8_t)(int)q;
        }
      }
      __syncthreads();
      stage_rowsums(sm, a.M, K);
      __syncthreads();
      staged = true;
    }
    const int tile = it / ks, sp = it % ks;
    const Tile t = plain_tile<MR>(tile, N);
    for (int i = threadIdx.x; i < MR * TC; i += FT) sm.red[i] = 0;
    __syncthreads();
    if (a.hbits == 8)
      gemv_partial<MR, 8>(sm, a.M, K, a.hwq, N, t, sp * gpb, min((K >> 3), (sp + 1) * gpb));
    else
      gemv_partial<MR, 4>(sm, a.M, K, a.hwq, N, t, sp * gpb, min((K >> 3), (sp + 1) * gpb));
    if (!finish_tile<TC>(sm, a.ws, tile, ks, a.M, 0, N, t)) continue;
    for (int i = threadIdx.x; i < a.M * TC; i += FT) {
      if (!t.valid(i % TC)) continue;
      const int r = i / TC, col = t.colA + i % TC;
      const float ow = __ldg(a.hoffset + col), sw = __ldg(a.hscale + col);
      a.logits[(size_t)r * N + col] =
          ((float)sm.red[i] - ow * (float)sm.rsum[r]) * (sm.sx[r] * sw);
    }
    __syncthreads();
  }
}


template <int MR, int WB, int DPL>
__global__ void __launch_bounds__(FT)
fused_decode_kernel(const Args a, int kmax) {
  const Smem sm = carve(MR, kmax);
  stamp(a, 0);
  int ts = 1;
  for (int l = a.l0; l < a.l1; ++l) {
    const float* mm = a.meta + (size_t)l * META + AM;
    stage_qkv<MR, WB>(a, sm, l);
    grid_barrier(a.bar);
    stamp(a, ts++);
    stage_attention<DPL>(a, sm, l);
    grid_barrier(a.bar);
    stamp(a, ts++);
    stage_o<MR, WB>(a, sm, l);
    grid_barrier(a.bar);
    stamp(a, ts++);
    stage_w13<MR, WB>(a, sm, l, mm, a.resid);
    grid_barrier(a.bar);
    stamp(a, ts++);
    stage_w2<MR, WB>(a, sm, l, mm, a.resid, a.x_out);
    if (l + 1 < a.l1 || a.logits || a.trace) grid_barrier(a.bar);
    stamp(a, ts++);
  }
  if (a.logits) {
    stage_head<MR>(a, sm);
    if (a.trace) grid_barrier(a.bar);
    stamp(a, ts);
  }
}

template <int MR, int WB>
__global__ void __launch_bounds__(FT)
fused_mlp_block_kernel(const Args a, int kmax) {
  const Smem sm = carve(MR, kmax);
  if (threadIdx.x < 32) sm.meta[threadIdx.x] = a.mlp_meta[threadIdx.x];
  __syncthreads();
  stage_w13<MR, WB>(a, sm, a.l0, sm.meta, a.x_in);
  grid_barrier(a.bar);
  stage_w2<MR, WB>(a, sm, a.l0, sm.meta, a.x_in, a.x_out);
}

size_t smem_bytes(const Args& a, int MR, int kmax, bool attention) {
  const int tc = 32 * (MR <= 2 ? 16 : (MR <= 4 ? 8 : 4));   // Cfg<MR>::TC
  size_t mv = SMALL + (size_t)MR * kmax + (size_t)MR * tc * 4;
  if (!attention) return mv;
  const size_t qwords = a.hd <= 128 ? 32 : 64;   // stage_attention's q words (8 DPL)
  size_t at = SMALL + (size_t)a.hd * 24 + (size_t)NW * a.hd * 8 + 4 * qwords
              + (size_t)a.S * 4 + (size_t)KV_CHUNK * a.hd;
  return mv > at ? mv : at;
}


int kmax_of(const Args& a) {
  int k = a.K;
  if (a.Hq * a.hd > k) k = a.Hq * a.hd;
  if (a.F > k) k = a.F;
  return (k + 15) / 16 * 16;
}

template <int WB, int DPL>
int launch_decode(const Args& a, int kmax, cudaStream_t st) {
  if (a.M <= 1)
    return launch_coop(fused_decode_kernel<1, WB, DPL>, a, kmax, smem_bytes(a, 1, kmax, true),
                       st);
  if (a.M <= 2)
    return launch_coop(fused_decode_kernel<2, WB, DPL>, a, kmax, smem_bytes(a, 2, kmax, true),
                       st);
  if (a.M <= 4)
    return launch_coop(fused_decode_kernel<4, WB, DPL>, a, kmax, smem_bytes(a, 4, kmax, true),
                       st);
  if (a.M <= 8)
    return launch_coop(fused_decode_kernel<8, WB, DPL>, a, kmax, smem_bytes(a, 8, kmax, true),
                       st);
  return (int)cudaErrorInvalidValue;
}

template <int WB>
int launch_mlp_block(const Args& a, int kmax, cudaStream_t st) {
  if (a.M <= 1)
    return launch_coop(fused_mlp_block_kernel<1, WB>, a, kmax, smem_bytes(a, 1, kmax, false), st);
  if (a.M <= 2)
    return launch_coop(fused_mlp_block_kernel<2, WB>, a, kmax, smem_bytes(a, 2, kmax, false), st);
  if (a.M <= 4)
    return launch_coop(fused_mlp_block_kernel<4, WB>, a, kmax, smem_bytes(a, 4, kmax, false), st);
  if (a.M <= 8)
    return launch_coop(fused_mlp_block_kernel<8, WB>, a, kmax, smem_bytes(a, 8, kmax, false), st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The whole-model and whole-layer kernels' head-dim-256 editions (8 dims a
// lane in the attention stage), instantiated in fused_layer_hd256.cu so that
// the build compiles them beside the others; mqt_fused_decode checks the
// arguments.
int mqt_layer_decode_hd256(const MqtFusedArgs& a, int kmax, cudaStream_t st);
