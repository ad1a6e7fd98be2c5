// Row kernels: the fused W4A8 / W8A8 kernels for many rows, as templates on
// the weight bits (WB). fused_rows.cu instantiates the W4 editions and holds
// the C entries, fused_rows_w8.cu the W8 editions of the MLP-block and chunk
// kernels, fused_otail_w8.cu the W8 o-tail, fused_mlp_tiles.cu the raw-sum
// and w2-epilogue MLP kernels of both widths, fused_rows_ln.cu the MLP
// block's LayerNorm kind of both widths, fused_rows_hd256.cu and
// fused_rows_hd256_w8.cu the chunk kernel's head-dim-256 editions, W4 and W8
// (seven translation units, so that the build compiles them at the same
// time).
//
// Replaces mobilequant_tpu/ops/pallas_chunk.py fused_model_w4_chunk
// (_chunk_kernel, _chunk_mlp_phase: a whole staged decode step of a serving
// batch, B = 16..128), and of mobilequant_tpu/ops/pallas_mlp.py
// fused_otail_block_stacked (_otail_block_kernel: o-proj + resid_add_1 + the
// MLP block), fused_mlp_block_w4_stacked (_w4_mlp_phase; above
// ops/mlp_block.DP4A_ROWS rows), fused_mlp_block (_mlp_block_kernel: the
// per-layer MLP block, RMSNorm or LayerNorm), fused_mlp (_mlp_kernel: w13,
// the gate chain and the raw int32 w2 sums) and w13_gate_w2_stacked
// (_w13_gate_w2_kernel: w13, the gate chain, w2 and its affine epilogue).
// Every kernel comes in both editions of its JAX counterparts (W4
// nibble-packed (kin/2, n), W8 shifted int8 (kin, n)); the chunk kernel's
// head has its own width (a.hbits: W4, or W8 as the JAX chunk kernel's folded
// head, per column).
//
// The cooperative, persistent launch of fused_layer.cu (fused_common.cuh:
// grid barrier, split-K meeting in the self-cleaning workspace), with the
// stages rebuilt for many rows:
//   - a norm is a stage of its own, one block per row (the fp64 sums, the
//     norm, the quantization), writing int8 rows; a grid barrier follows.
//     Every norm is RMSNorm, or (StableLM) LayerNorm: a mean pass first,
//     then the sum of squares of x − mean, both fp64, then the bias; the
//     chunk and o-tail kernels read the flag a.ln at run time (a branch once
//     per row), so one instantiation serves both norms; the MLP tiles kernel
//     has an instantiation for each norm, which its entry picks by a.ln;
//   - a matvec tile is 128 columns by every row of the launch (at most 128):
//     per K chunk of
//     128 k values the block unpacks the tile's weights (W4: 64 packed rows;
//     W8: 64 rows j and 64 rows kin/2 + j, twice the bytes) into shared
//     memory once and streams the chunk of every activation row beside
//     them (at B = 128 a (B, K) int8 activation does not fit an SM, so rows are
//     never held whole), then the 8 warps run int8 mma.sync (m16n8k32) over
//     16-row x 16·MI-column pieces of the tile; the next chunk's loads are in
//     flight meanwhile. Each weight byte is read once per launch, whatever M.
//     The tile's row sums come from the same activation words; split-K
//     partials (accumulators and row sums) meet in the workspace, and the last
//     block of a tile runs the epilogue;
//   - the MLP kernels of any M (the per-layer MLP block, fused_mlp, w13 +
//     gate + w2) walk the rows in 128-row tiles inside the one launch: per
//     tile the norm (the MLP block), the w13 + gate stage and the w2 stage,
//     a grid barrier after each; the weights are re-read per row tile (from
//     the 50 MB L2 when a layer's matrices fit it);
//   - the chunk kernel's attention: one block per (sequence, q head), RoPE
//     and joint quantization (the group's first q head writes the new K/V
//     rows), scores over the stale cache rows [0, pos0) staged through shared
//     memory with the cache's K column sums from kcs, the staged columns
//     [0, m) with their column sums computed here, the self term; one shared
//     max, per-part exp, the denominator (cache + self) + staged; masked rows
//     add exactly 0 (neg_inf <= -1e4), so only valid rows are read. Above
//     64 rows (whose tiles leave one block an SM) an item is a (sequence, kv
//     head) with its q heads, so each valid K/V row is read once for them.
//     The per-head stage comes in two editions (DPL, head dims a lane): 4 up
//     to hd 128, 8 at hd 256 (Gemma-2B, which the grouped stage does not take).
//
// Per layer of the chunk kernel: norm1 | qkv | attention | o | norm2 | w13 +
// gate | w2 (a grid barrier after each); then the final norm and the head.
//
// Bound: device-memory bytes (at B = 32 the 518 MB of TinyLlama-1.1B's W4
// weights, or 1,036 MB of W8 ones, 75 MB of valid KV rows at pos0 192 and
// 2.2 MB of kcs: 0.178 / 0.333 ms at 3.35 TB/s); the int8 products (at
// B = 128 about 10 GOP per layer) run on the tensor cores. The MLP kernels at
// prefill M (1024 rows: 71 G int8 operations a W8 layer, 36 us at 1,979
// TOP/s) are bound by operations.
//
// Numerics: the chunk kernel's math (the JAX chunk kernel's): without the
// qk_bmm output fake-quant the score scale folds 1/sqrt(hd) in; without the
// pv_bmm input fake-quant P·V is unnormalised, att = (Σ e·v / den − o_v)·s_v.
// Sums that feed an int8 rounding (norms, each denominator part, P·V, ΣP, the
// self score) are fp64 rounded once, as in the plain versions, so kernel and
// plain version agree whatever the summation order.
#pragma once

#include "fused_common.cuh"

namespace {

constexpr int RN = 128;          // columns of a row tile
constexpr int RKP = 64;          // packed weight rows per K chunk (128 k values)
constexpr int XW = 36;           // words per shared activation row (32 + 4: A fragments
                                 // of the 8 row groups of a warp hit distinct banks)
constexpr int WW = RN + 8;       // words per shared weight row (B fragments likewise)
constexpr int SW = RN + 4;       // words per accumulator staging row
constexpr int MAXR = 128;        // rows a launch takes
constexpr int RSW = CNT * MAXR;  // workspace: per-tile row-sum partials after the counters

struct RowSmem {
  union {
    struct {
      // one K chunk: words [0, 16) of a row hold the k values of the packed
      // rows' low nibbles, [16, 32) those of their high nibbles (4 k a word)
      int x[MAXR][XW];           // every row's activation words
      int w[32][WW];             // the tile's unpacked weights, word-major
    } mm;
    int stg[MAXR][SW];           // the tile's accumulators, row-major
  } u;
  int rsum[MAXR];                // the tile's row sums (epilogue)
  double dred[NW];
  float fred[NW];
  float meta[48];                // MLP-block / o-tail meta copy
  int flag;
};

__device__ __forceinline__ RowSmem& row_smem() {
  extern __shared__ int4 smem_raw[];
  return *reinterpret_cast<RowSmem*>(smem_raw);
}

__device__ __forceinline__ char* smem_base() {
  extern __shared__ int4 smem_raw[];
  return reinterpret_cast<char*>(smem_raw);
}

__device__ __forceinline__ Tile row_tile(int t, int N) {
  return Tile{t * RN, 0, RN, min(RN, N - t * RN), 0};
}

// the w1 and w3 columns of 64 gate outputs (they sit F apart)
__device__ __forceinline__ Tile row_gate_tile(int t, int F) {
  constexpr int H = RN / 2;
  const int n = min(H, F - t * H);
  return Tile{t * H, F + t * H, H, n, n};
}

// acc[i][j] (row ty + 16 i, tile column tx + 16 j) = x · W[:, tile columns]
// over K chunks [c0, c1) of 128 k values (64 row pairs j, j + kin/2); thread
// tid < M adds row tid's sum to rs. x (M, kin) int8 is read through L2 (it
// may have been written in this launch). Per chunk the block unpacks the
// tile's weights into shared memory (W4: its 64 packed rows, nibbles 0..15
// being valid s8 operands; W8: 64 low rows and the 64 high rows kin/2 + j,
// their bytes as they are) beside every row's 128 activation bytes; warp w
// then runs int8 mma.sync over rows 16 (w % MI).. and 16·MI columns (MI = 8:
// all 128) of the tile. The next chunk's global loads (twice the weight words
// for W8) are issued before this chunk's products, so they are in flight
// meanwhile. The accumulators meet the epilogues' layout through shared
// memory at the end.
template <int MI, int WB>
__device__ void rows_mma(const int8_t* __restrict__ x, int M, int kin,
                         const int8_t* __restrict__ w, int N, const Tile& t, int c0, int c1,
                         RowSmem& s, int (&acc)[MI][8], int& rs) {
  constexpr int NT = 2 * MI;                  // n8 tiles of a warp
  constexpr int XL = MI >= 2 ? MI / 2 : 1;    // activation int4 loads per thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = 16 * (warp % MI), cb = (warp / MI) * 16 * MI;
  const int k2 = kin >> 1;
  const int cg = tid & 31, rg = tid >> 5;     // weight loads: 4 columns x 8 packed rows
  const bool wok = t.valid(cg * 4);
  const int wcol = t.gcol(cg * 4);
  int d[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0;
  constexpr int NWR = WB == 8 ? 16 : 8;      // weight words a thread loads a chunk
  int wr[NWR];
  int4 xr[XL];
  auto load = [&](int ch) {
    const int j0 = ch * RKP, left = k2 - j0;  // row pairs left: 64, or 32 at a K tail
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wr[i] = (wok && rg * 8 + i < left) ? ld_i32(w + (size_t)(j0 + rg * 8 + i) * N + wcol) : 0;
    if constexpr (WB == 8) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wr[8 + i] = (wok && rg * 8 + i < left)
                        ? ld_i32(w + (size_t)(k2 + j0 + rg * 8 + i) * N + wcol) : 0;
    }
#pragma unroll
    for (int q = 0; q < XL; ++q) {
      const int idx = tid + FT * q, m = idx >> 3, p = idx & 7;
      int4 v = make_int4(0, 0, 0, 0);
      if (m < M && m < 16 * MI && 16 * (p & 3) < left)
        v = __ldcg(reinterpret_cast<const int4*>(x + (size_t)m * kin + (p >= 4 ? k2 : 0) + j0
                                                 + 16 * (p & 3)));
      xr[q] = v;
    }
  };
  if (c0 < c1) load(c0);
  for (int ch = c0; ch < c1; ++ch) {
    __syncthreads();                          // the previous chunk's reads are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {             // row pairs rg·8 + 4h .. + 3: word 2 rg + h
      int c[4];
      transpose4x4(wr + 4 * h, c);
      const int kw = 2 * rg + h;
      if constexpr (WB == 4) {
        *reinterpret_cast<int4*>(&s.u.mm.w[kw][cg * 4]) =
            make_int4(c[0] & (int)NIB, c[1] & (int)NIB, c[2] & (int)NIB, c[3] & (int)NIB);
        *reinterpret_cast<int4*>(&s.u.mm.w[16 + kw][cg * 4]) = make_int4(
            (int)(((unsigned)c[0] >> 4) & NIB), (int)(((unsigned)c[1] >> 4) & NIB),
            (int)(((unsigned)c[2] >> 4) & NIB), (int)(((unsigned)c[3] >> 4) & NIB));
      } else {
        int c2[4];
        transpose4x4(wr + 8 + 4 * h, c2);
        *reinterpret_cast<int4*>(&s.u.mm.w[kw][cg * 4]) = make_int4(c[0], c[1], c[2], c[3]);
        *reinterpret_cast<int4*>(&s.u.mm.w[16 + kw][cg * 4]) =
            make_int4(c2[0], c2[1], c2[2], c2[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < XL; ++q) {
      const int idx = tid + FT * q, m = idx >> 3, p = idx & 7;
      if (m < 16 * MI) *reinterpret_cast<int4*>(&s.u.mm.x[m][4 * p]) = xr[q];
    }
    __syncthreads();
    if (ch + 1 < c1) load(ch + 1);            // in flight during the products below
    if (tid < M) {
#pragma unroll 8
      for (int q = 0; q < 32; ++q)            // rotated start: distinct banks per lane
        rs = __dp4a(s.u.mm.x[tid][(q + tid) & 31], 0x01010101, rs);
    }
#pragma unroll
    for (int kb = 0; kb < 32; kb += 8) {      // four k32 steps: low 0..63, high 0..63
      const int a0 = s.u.mm.x[r0 + g][kb + tg], a1 = s.u.mm.x[r0 + g + 8][kb + tg];
      const int a2 = s.u.mm.x[r0 + g][kb + 4 + tg], a3 = s.u.mm.x[r0 + g + 8][kb + 4 + tg];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = cb + 8 * n + g;
        mma_s8(d[n], a0, a1, a2, a3, s.u.mm.w[kb + tg][col], s.u.mm.w[kb + 4 + tg][col]);
      }
    }
  }
  __syncthreads();                            // the union turns into the staging rows
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = cb + 8 * n + 2 * tg;
    *reinterpret_cast<int2*>(&s.u.stg[r0 + g][col]) = make_int2(d[n][0], d[n][1]);
    *reinterpret_cast<int2*>(&s.u.stg[r0 + g + 8][col]) = make_int2(d[n][2], d[n][3]);
  }
  __syncthreads();
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = s.u.stg[ty + 16 * i][tx + 16 * j];
}

// Split-K meeting point of tile `tile`: true in the block that then holds
// the totals (acc, and the row sums in s.rsum); the only block when ks == 1.
// The last block to arrive reads and zeroes the partials and its counter.
template <int MI>
__device__ bool rows_finish(int* ws, int tile, int ks, int M, int N, const Tile& t,
                            RowSmem& s, int (&acc)[MI][8], int rs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (ks == 1) {
    if (tid < M) s.rsum[tid] = rs;
    __syncthreads();
    return true;
  }
  int* wrs = ws + CNT + (size_t)tile * MAXR;
  int* wacc = ws + CNT + RSW;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int gm = ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (t.valid(n)) atomicAdd(&wacc[(size_t)gm * N + t.gcol(n)], acc[i][j]);
    }
  }
  if (tid < M) atomicAdd(&wrs[tid], rs);
  __threadfence();
  __syncthreads();
  if (tid == 0) s.flag = (atomicAdd(&ws[tile], 1) == ks - 1);
  __syncthreads();
  if (!s.flag) return false;
  __threadfence();
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int gm = ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (t.valid(n)) acc[i][j] = atomicExch(&wacc[(size_t)gm * N + t.gcol(n)], 0);
    }
  }
  if (tid < M) s.rsum[tid] = atomicExch(&wrs[tid], 0);
  if (tid == 0) ws[tile] = 0;
  __syncthreads();
  return true;
}

// One matvec stage: x (M, kin) int8 times the (kin/2, N) W4 or (kin, N) W8
// matrix w, over 128-column tiles (gate: the w1|w3 tiles of an F-wide gate),
// K split over blocks so that tiles·ks is about the grid; epi(tile, acc) runs
// in the block that completes a tile, with the row sums in s.rsum.
template <int MI, int WB, typename Epi>
__device__ void rows_matvec(const int8_t* x, int M, int kin, const int8_t* w, int N,
                            bool gate, int F, int* ws, RowSmem& s, Epi epi) {
  const int tiles = gate ? (F + RN / 2 - 1) / (RN / 2) : (N + RN - 1) / RN;
  const int nch = ((kin >> 1) + RKP - 1) / RKP;       // the last may be a half chunk
  int ks = (gridDim.x + tiles - 1) / tiles;
  if (ks > nch) ks = nch;
  if (ks < 1) ks = 1;
  const int cps = (nch + ks - 1) / ks;
  ks = (nch + cps - 1) / cps;
  for (int it = blockIdx.x; it < tiles * ks; it += gridDim.x) {
    const int tile = it / ks, sp = it % ks;
    const Tile t = gate ? row_gate_tile(tile, F) : row_tile(tile, N);
    int acc[MI][8];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    int rs = 0;
    rows_mma<MI, WB>(x, M, kin, w, N, t, sp * cps, min(nch, (sp + 1) * cps), s, acc, rs);
    if (!rows_finish<MI>(ws, tile, ks, M, N, t, s, acc, rs)) continue;
    epi(t, acc);
    __syncthreads();
  }
}

// One row's norm scalars, the whole block over x[0, K) through val(k): RMS
// (mu 0, rn = 1 / sqrt(Σ v² / K + eps)) or LayerNorm (ln: mu = Σ v / K, then
// rn = 1 / sqrt(Σ (v − mu)² / K + eps)); the sums are fp64, rounded once. The
// row's normed value is (v − mu) · rn either way (v − 0 is v, bit for bit).
template <typename Val>
__device__ __forceinline__ void row_norm_scalars(int K, float eps, bool ln, Val val,
                                                 RowSmem& s, float& mu, float& rn) {
  mu = 0.0f;
  double acc = 0.0;
  if (ln) {
    for (int k = threadIdx.x; k < K; k += FT) acc += (double)val(k);
    mu = block_sum(acc, s.dred) / (float)K;
    acc = 0.0;
    for (int k = threadIdx.x; k < K; k += FT) {
      const float v = val(k) - mu;
      acc += (double)(v * v);
    }
  } else {
    for (int k = threadIdx.x; k < K; k += FT) {
      const float v = val(k);
      acc += (double)(v * v);
    }
  }
  const float t = block_sum(acc, s.dred);
  rn = 1.0f / sqrtf(t / (float)K + eps);
}

// The norm of a row kernel: RMSNorm, LayerNorm, or (NORM_RUNTIME) the one
// that the flag ln picks, a branch once per row. The MLP tiles kernel takes
// the norm as a template parameter, so that its norm folds to constants; the
// chunk and o-tail kernels read a.ln, so that one instantiation serves both
// (on the card the runtime norm slowed the tiles kernel's W8 edition at
// M = 32, and did not slow the chunk and o-tail kernels at 32 rows).
constexpr int NORM_RMS = 0, NORM_LN = 1, NORM_RUNTIME = 2;

// fq16(src row) -> RMS norm, or LayerNorm (mean-centred), with fp64 sums ->
// ·w + b -> quantize -> dst (M, K) int8; one block per row.
template <int NORM>
__device__ void rows_norm(const float* src, int M, int K, const float* nw, const float* nb,
                          float fs, float fo, float fqmax, float eps, float hs, float ho,
                          bool ln, int8_t* dst, RowSmem& s) {
  const bool use_ln = NORM == NORM_RUNTIME ? ln : NORM == NORM_LN;
  for (int r = blockIdx.x; r < M; r += gridDim.x) {
    const float* x = src + (size_t)r * K;
    auto val = [&](int k) { return fqm(__ldcg(x + k), fs, fo, fqmax); };
    float mu, rn;
    row_norm_scalars(K, eps, use_ln, val, s, mu, rn);
    for (int k = threadIdx.x; k < K; k += FT) {
      const float y = (val(k) - mu) * rn * __ldg(nw + k) + __ldg(nb + k);
      dst[(size_t)r * K + k] = (int8_t)(int)quant_u8s(y, hs, ho);
    }
  }
}

// final norm (RMS, or LayerNorm with a.ln) -> dynamic per-row symmetric A8
// (scale max|y| / 127) -> a.h8, the scales to a.sx; one block per row.
__device__ void rows_head_norm(const Args& a, RowSmem& s) {
  const int K = a.K;
  const bool ln = a.ln;
  const float eps = a.meta[(size_t)(a.L - 1) * META + 3];
  for (int r = blockIdx.x; r < a.M; r += gridDim.x) {
    const float* x = a.x_out + (size_t)r * K;
    auto val = [&](int k) { return __ldcg(x + k); };
    float mu, rn;
    row_norm_scalars(K, eps, ln, val, s, mu, rn);
    auto yv = [&](int k) { return (val(k) - mu) * rn * __ldg(a.fnw + k) + __ldg(a.fnb + k); };
    float amax = 0.0f;
    for (int k = threadIdx.x; k < K; k += FT) amax = fmaxf(amax, fabsf(yv(k)));
    const float scale = fmaxf(block_max(amax, s.fred), 1e-8f) / 127.0f;
    for (int k = threadIdx.x; k < K; k += FT)
      a.h8[(size_t)r * K + k] = (int8_t)(int)fminf(fmaxf(rintf(yv(k) / scale), -127.0f), 127.0f);
    if (threadIdx.x == 0) a.sx[r] = scale;
  }
}

// o-proj of a.a8 (M, Ko) for layer l -> affine (x scale / offset at mo[0..1])
// -> o output fq (mo[2..4]) -> resid_add_1 with xin: input (mo[5..7]),
// input2 (mo[8..10]), output (mo[11..13]) -> a.resid
template <int MI, int WB>
__device__ void rows_o(const Args& a, RowSmem& s, int l, const float* mo, const float* xin) {
  const int K = a.K, Ko = a.o.kin, M = a.M;
  const float xs = mo[0], ox = mo[1] - 128.0f, kox = (float)Ko * ox;
  const float fo[12] = {mo[2], mo[3], mo[4], mo[5], mo[6], mo[7],
                        mo[8], mo[9], mo[10], mo[11], mo[12], mo[13]};
  rows_matvec<MI, WB>(a.a8, M, Ko, layer_w<WB>(a.o, l), K, false, 0, a.ws, s,
                  [&](const Tile& t, int (&acc)[MI][8]) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + 16 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (!t.valid(n)) continue;
        const int col = t.colA + n;
        float y = affine(a.o, l, acc[i][j], col, (float)s.rsum[r], xs, ox, kox);
        y = fqm(y, fo[0], fo[1], fo[2]);
        const float xr = fqm(__ldcg(xin + (size_t)r * K + col), fo[3], fo[4], fo[5]);
        y = fqm(y, fo[6], fo[7], fo[8]);
        a.resid[(size_t)r * K + col] = fqm(xr + y, fo[9], fo[10], fo[11]);
      }
    }
  });
}

// w13 + gate chain of layer l over h (M, K) int8 -> a.act8 (M, F) int8 (the
// w2 input); mm is the 32-float MLP-block meta (entries 0..15 read).
template <int MI, int WB>
__device__ void rows_gate(const Args& a, RowSmem& s, int l, const float* mm, const int8_t* h,
                          int M) {
  const int K = a.K, F = a.F;
  const float xs = mm[0], ox = mm[1] - 128.0f, kox = (float)K * ox;
  rows_matvec<MI, WB>(h, M, K, layer_w<WB>(a.w13, l), 2 * F, true, F,
                      a.ws, s, [&](const Tile& t, int (&acc)[MI][8]) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + 16 * i;
      if (r >= M) continue;
      const float rs = (float)s.rsum[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (n >= t.na) continue;
        float g1 = affine(a.w13, l, acc[i][j], t.colA + n, rs, xs, ox, kox);
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
        float g3 = affine(a.w13, l, acc[i][j + 4], t.colB + n, rs, xs, ox, kox);
        g3 = fqm(g3, mm[11], mm[12], mm[13]);
        a.act8[(size_t)r * F + t.colA + n] = (int8_t)(int)quant_u8s(act * g3, mm[14], mm[15]);
      }
    }
  });
}

// w2 of layer l over a.act8 (M, F): out(r, col, acc, rowsum) for every output
// of the M rows, with the raw int32 sum and the act row's sum.
template <int MI, int WB, typename Out>
__device__ void rows_w2(const Args& a, RowSmem& s, int l, int M, Out out) {
  rows_matvec<MI, WB>(a.act8, M, a.F, layer_w<WB>(a.w2, l), a.K, false, 0, a.ws, s,
                      [&](const Tile& t, int (&acc)[MI][8]) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = ty + 16 * i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (t.valid(n)) out(r, t.colA + n, acc[i][j], s.rsum[r]);
      }
    }
  });
}

// The MLP block of layer l over src (M, K) -> out (M, K); mm is the 32-float
// MLP-block meta; NORM (rows_norm): the norm, NORM_RUNTIME reading a.ln.
// Three stages, two grid barriers between them.
template <int MI, int WB, int NORM>
__device__ void rows_mlp(const Args& a, RowSmem& s, int l, const float* mm, const float* src,
                         float* out, int M) {
  const int K = a.K, F = a.F;
  rows_norm<NORM>(src, M, K, a.mnw + (size_t)l * K, a.mnb + (size_t)l * K, mm[16], mm[17],
                  mm[18], mm[19], mm[0], mm[1], a.ln, a.h8, s);
  grid_barrier(a.bar);
  rows_gate<MI, WB>(a, s, l, mm, a.h8, M);
  grid_barrier(a.bar);
  const float xs = mm[14], ox = mm[15] - 128.0f, kox = (float)F * ox;
  rows_w2<MI, WB>(a, s, l, M, [&](int r, int col, int acc, int rs) {
    float y = affine(a.w2, l, acc, col, (float)rs, xs, ox, kox);
    y = fqm(y, mm[20], mm[21], mm[22]);
    const float xr = fqm(__ldcg(src + (size_t)r * K + col), mm[23], mm[24], mm[25]);
    y = fqm(y, mm[26], mm[27], mm[28]);
    out[(size_t)r * K + col] = fqm(xr + y, mm[29], mm[30], mm[31]);
  });
}

// ---- the chunk kernel's attention ------------------------------------------

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// byte offsets of the attention stage's arrays in shared memory (dpl: the
// edition's DPL, 4 up to hd 128, 8 at hd 256)
struct AttnLayout {
  size_t ys, part, qi, sc, kvs, end;
  __host__ __device__ AttnLayout(int hd, int S, int ncs, int dpl) {
    ys = 128;                                           // dred (NW doubles), fred (NW floats)
    part = align16(ys + (size_t)6 * hd * 4);            // ys, q8: 3 x hd floats each
    qi = part + (size_t)2 * NW * hd * 8;                // cache | staged P·V partials
    sc = qi + (size_t)32 * dpl;                         // 8·DPL >= hd / 4 q words
    kvs = align16(sc + (size_t)(S + ncs) * 4);          // scores: S cache, ncs staged
    end = kvs + (size_t)KV_CHUNK * hd;                  // staged cache rows
  }
};

// DPL: the edition's most head dims a lane (4: hd <= 128; 8: hd 256,
// Gemma-2B), so a K row is at most 2·DPL 16-byte words and the q row 8·DPL
// int words, and a lane holds DPL fp64 P·V sums a part.
template <int DPL>
__device__ void stage_chunk_attention(const Args& a, int l) {
  const float* m = a.meta + (size_t)l * META;
  const int hd = a.hd, Hq = a.Hq, Hkv = a.Hkv, G = Hq / Hkv, S = a.S, ncs = a.ncs;
  const int Nq = a.qkv.n, Ko = Hq * hd, B = a.M, mst = a.mst;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  char* base = smem_base();
  const AttnLayout lay(hd, S, ncs, DPL);
  double* dred = reinterpret_cast<double*>(base);
  float* fred = reinterpret_cast<float*>(base + 64);
  float* ys = reinterpret_cast<float*>(base + lay.ys);     // q, k, v rows
  float* q8 = ys + 3 * hd;                                 // shifted ints
  double* part = reinterpret_cast<double*>(base + lay.part);
  int* qi = reinterpret_cast<int*>(base + lay.qi);
  float* sc = reinterpret_cast<float*>(base + lay.sc);     // [0, S) cache, [S, S + ncs) staged
  int8_t* kvs = reinterpret_cast<int8_t*>(base + lay.kvs);
  const float sq = m[6], oq = m[7] - 128.0f, sk = m[8], ok = m[9] - 128.0f;
  const float vscale = m[10], ov = m[11] - 128.0f;
  const float sqk = sq * sk;
  const float hdoo = (float)hd * oq * ok;
  const float inv = a.inv_sqrt_hd;
  const float cf = a.qk_fq ? sqk : sqk * inv;
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
    // Σq and the self term (every warp computes them: no extra barrier)
    int qsum = 0;
    double e = 0.0;
    for (int d = lane; d < hd; d += 32) {
      qsum += (int)q8[d];
      e += (double)((q8[d] - oq) * (q8[hd + d] - ok));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
    float sself = warp_sum(e) * sqk;
    if (a.qk_fq) sself = fqm(sself, m[12], m[13], m[14]);
    const float lg_self = sself * inv;
    __syncthreads();
    auto score = [&](int acc, float ksum) {
      const float raw = (float)acc - ok * (float)qsum - oq * ksum + hdoo;
      return a.qk_fq ? fqm(raw * sqk, m[12], m[13], m[14]) * inv : raw * cf;
    };
    // the stale cache rows [0, P), their K column sums from kcs
    const size_t seq = ((size_t)l * B + b) * Hkv + h;
    const float* kcs = a.kcs + seq * S;
    const int8_t* kc = a.kcache + seq * (size_t)S * hd;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      stage_rows(kvs, kc + (size_t)c0 * hd, nr * hd);
      for (int r = threadIdx.x; r < nr; r += FT) {
        const int4* kr = reinterpret_cast<const int4*>(kvs + (size_t)r * hd);
        int acc = 0;
#pragma unroll
        for (int i = 0; i < 2 * DPL; ++i) {
          if (i < (hd >> 4)) {
            const int4 t = kr[i];
            acc = __dp4a(qi[4 * i], t.x, acc);
            acc = __dp4a(qi[4 * i + 1], t.y, acc);
            acc = __dp4a(qi[4 * i + 2], t.z, acc);
            acc = __dp4a(qi[4 * i + 3], t.w, acc);
          }
        }
        sc[c0 + r] = score(acc, __ldg(kcs + c0 + r));
      }
    }
    // the staged columns [0, mst), their column sums computed here
    const int8_t* skp = a.sk + seq * (size_t)ncs * hd;
    for (int r = threadIdx.x; r < mst; r += FT) {
      const int4* kr = reinterpret_cast<const int4*>(skp + (size_t)r * hd);
      int ks = 0, acc = 0;
#pragma unroll
      for (int i = 0; i < 2 * DPL; ++i) {
        if (i < (hd >> 4)) {
          const int4 t = __ldg(kr + i);
          ks = __dp4a(t.w, 0x01010101, __dp4a(t.z, 0x01010101,
               __dp4a(t.y, 0x01010101, __dp4a(t.x, 0x01010101, ks))));
          acc = __dp4a(qi[4 * i], t.x, acc);
          acc = __dp4a(qi[4 * i + 1], t.y, acc);
          acc = __dp4a(qi[4 * i + 2], t.z, acc);
          acc = __dp4a(qi[4 * i + 3], t.w, acc);
        }
      }
      sc[S + r] = score(acc, (float)ks);
    }
    __syncthreads();
    // one shared max, per-part exp, the denominator (cache + self) + staged
    float mx = __int_as_float(0xff800000);     // -inf
    for (int s = threadIdx.x; s < P; s += FT) mx = fmaxf(mx, sc[s]);
    for (int r = threadIdx.x; r < mst; r += FT) mx = fmaxf(mx, sc[S + r]);
    mx = fmaxf(block_max(mx, fred), lg_self);
    double dc = 0.0, ds = 0.0;
    for (int s = threadIdx.x; s < P; s += FT) {
      const float ev = expf(sc[s] - mx);
      sc[s] = ev;
      dc += (double)ev;
    }
    for (int r = threadIdx.x; r < mst; r += FT) {
      const float ev = expf(sc[S + r] - mx);
      sc[S + r] = ev;
      ds += (double)ev;
    }
    const float es = expf(lg_self - mx);
    const float sum_c = block_sum(dc, dred);
    const float sum_s = block_sum(ds, dred);
    const float den = (sum_c + es) + sum_s;
    float psum_c = 0.0f, psum_s = 0.0f, ps = 0.0f;
    if (a.pv_fq) {
      // strict: the fake-quanted normalised probabilities multiply V
      double pc = 0.0, pst = 0.0;
      for (int s = threadIdx.x; s < P; s += FT) {
        const float p = fqm(sc[s] / den, m[15], m[16], m[17]);
        sc[s] = p;
        pc += (double)p;
      }
      for (int r = threadIdx.x; r < mst; r += FT) {
        const float p = fqm(sc[S + r] / den, m[15], m[16], m[17]);
        sc[S + r] = p;
        pst += (double)p;
      }
      psum_c = block_sum(pc, dred);
      psum_s = block_sum(pst, dred);
      ps = fqm(es / den, m[15], m[16], m[17]);
    }
    __syncthreads();
    // Σ p·v over the cache rows and the staged rows (warp w takes rows w,
    // w + NW, ...; lanes over head_dim); fp64 partials meet in shared memory
    double accC[DPL], accS[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) accC[j] = accS[j] = 0.0;
    const int8_t* vc = a.vcache + seq * (size_t)S * hd;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      stage_rows(kvs, vc + (size_t)c0 * hd, nr * hd);
#pragma unroll 2
      for (int r = warp; r < nr; r += NW) {
        const double p = (double)sc[c0 + r];
        const int8_t* vr = kvs + (size_t)r * hd + lane;
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          if (j < dpl) accC[j] += p * (double)vr[32 * j];
      }
    }
    if constexpr (DPL > 4) {
      // 8 dims a lane: the cache part's sums leave the registers before the
      // staged pass, so a lane never holds more than DPL of them
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        if (j < dpl) part[warp * hd + lane + 32 * j] = accC[j];
    }
    const int8_t* svp = a.sv + seq * (size_t)ncs * hd;
    for (int r = warp; r < mst; r += NW) {
      const double p = (double)sc[S + r];
      const int8_t* vr = svp + (size_t)r * hd + lane;
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        if (j < dpl) accS[j] += p * (double)__ldg(vr + 32 * j);
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (j < dpl) {
        if constexpr (DPL <= 4) part[warp * hd + lane + 32 * j] = accC[j];
        part[(NW + warp) * hd + lane + 32 * j] = accS[j];
      }
    __syncthreads();
    for (int d = threadIdx.x; d < hd; d += FT) {
      double tc = 0.0, ts = 0.0;
      for (int w = 0; w < NW; ++w) {
        tc += part[w * hd + d];
        ts += part[(NW + w) * hd + d];
      }
      float at;
      if (a.pv_fq) {
        const float vnf = (q8[2 * hd + d] + 128.0f - m[11]) * vscale;
        at = ((float)tc - ov * psum_c) * vscale;
        at = at + ((float)ts - ov * psum_s) * vscale;
        at = at + ps * vnf;
      } else {
        // relaxed: Σ e·v unnormalised, divided once
        const float A = (float)(tc + ts) + es * q8[2 * hd + d];
        at = (A / den - ov) * vscale;
      }
      a.a8[(size_t)b * Ko + qh * hd + d] = (int8_t)(int)quant_u8s(at, m[19], m[20]);
    }
    __syncthreads();
  }
}

constexpr int GMAX = 8;           // q heads of a kv head the grouped stage takes

// byte offsets of the grouped attention stage's arrays in shared memory
struct GroupLayout {
  size_t ys, hv, qi, part, sc, kvs, end;
  __host__ __device__ GroupLayout(int hd, int S, int ncs, int G) {
    ys = 128;
    hv = align16(ys + (size_t)2 * (G + 2) * hd * 4);    // ys, q8: G q rows, k, v (floats)
    qi = hv + (size_t)8 * GMAX * 4;                     // per-head scalars
    part = align16(qi + (size_t)G * hd);                // packed q words
    sc = part + (size_t)2 * FT * 8;                     // P·V partials: cache | staged
    kvs = align16(sc + (size_t)G * (S + ncs) * 4);      // scores: S cache, ncs staged a head
    end = kvs + (size_t)KV_CHUNK * hd;                  // staged cache rows
  }
};

// The attention stage with one item per (sequence, kv head) and its G <= 8 q
// heads, above 64 rows when such items fill the grid (B·Hkv >= blocks):
// each cache row and staged column is read once for the G heads (a thread
// takes a row and forms G scores; warp i takes head i's max, exp and
// denominator parts; P·V one (head, dim) output a thread, rows split over
// thread groups when G·hd < 256), with the same arithmetic as the per-head
// stage: fp64 sums rounded once, so the results are the same bytes.
__device__ void stage_chunk_attention_grouped(const Args& a, int l) {
  const float* m = a.meta + (size_t)l * META;
  const int hd = a.hd, Hq = a.Hq, Hkv = a.Hkv, G = Hq / Hkv, S = a.S, ncs = a.ncs;
  const int Nq = a.qkv.n, Ko = Hq * hd, B = a.M, mst = a.mst;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  char* base = smem_base();
  const GroupLayout lay(hd, S, ncs, G);
  float* ys = reinterpret_cast<float*>(base + lay.ys);     // G q rows, k, v
  float* q8 = ys + (G + 2) * hd;                           // their shifted ints
  float* lgs = reinterpret_cast<float*>(base + lay.hv);    // per head: self logit,
  float* es = lgs + GMAX;                                  // its exp,
  float* den = es + GMAX;                                  // the denominator,
  float* ps = den + GMAX;                                  // p of the self term (strict),
  float* psc = ps + GMAX;                                  // Σp cache (strict),
  float* pss = psc + GMAX;                                 // Σp staged (strict)
  int* qsum = reinterpret_cast<int*>(pss + GMAX);          // Σq
  int* qi = reinterpret_cast<int*>(base + lay.qi);         // (G, hd/4) packed q words
  double* part = reinterpret_cast<double*>(base + lay.part);
  float* sc = reinterpret_cast<float*>(base + lay.sc);     // (G, S + ncs)
  int8_t* kvs = reinterpret_cast<int8_t*>(base + lay.kvs);
  const float sq = m[6], oq = m[7] - 128.0f, sk = m[8], ok = m[9] - 128.0f;
  const float vscale = m[10], ov = m[11] - 128.0f;
  const float sqk = sq * sk;
  const float hdoo = (float)hd * oq * ok;
  const float inv = a.inv_sqrt_hd;
  const float cf = a.qk_fq ? sqk : sqk * inv;
  const int half = a.rot >> 1;
  const int li = l - a.l0;
  const int hw = hd >> 2;                      // int words per row (<= 32)
  const int SC = S + ncs;                      // score row of a head
  const int nout = G * hd;                     // P·V outputs of an item
  const int ng = nout >= FT ? 1 : FT / nout;   // row groups of the P·V loop
  const int opt = (nout + FT - 1) / FT;        // outputs a thread (<= 4)
  for (int it = blockIdx.x; it < B * Hkv; it += gridDim.x) {
    const int b = it / Hkv, h = it % Hkv, qh0 = h * G;
    int P = a.pos[b];
    P = P < 0 ? 0 : (P > S ? S : P);
    for (int i = tid; i < (G + 2) * hd; i += FT) {
      const int r = i / hd, d = i % hd;
      const int head = r < G ? qh0 + r : (r == G ? Hq + h : Hq + Hkv + h);
      ys[i] = __ldcg(a.yq + (size_t)b * Nq + head * hd + d);
    }
    __syncthreads();
    // RoPE (q and k rows) and joint segment quantization
    const float* csb = a.cs + (size_t)b * 2 * hd;
    for (int i = tid; i < (G + 2) * hd; i += FT) {
      const int r = i / hd, d = i % hd;
      const int seg = r < G ? 0 : r - G + 1;    // 0 q, 1 k, 2 v
      float y = ys[i];
      if (seg < 2) {
        const float partner = d < half ? ys[r * hd + d + half] : ys[r * hd + d - half];
        y = y * __ldg(csb + d) + partner * __ldg(csb + hd + d);
      }
      const float qv = quant_u8s(y, m[6 + 2 * seg], m[7 + 2 * seg]);
      q8[i] = qv;
      if (seg > 0) {
        const int kvrow = seg == 1 ? h : Hkv + h;
        a.kv_new[(((size_t)li * B + b) * 2 * Hkv + kvrow) * hd + d] = (int8_t)(int)qv;
      }
    }
    __syncthreads();
    const float* k8 = q8 + G * hd;             // the new K row
    const float* v8 = k8 + hd;                 // the new V row
    for (int i = tid; i < G * hw; i += FT) {
      const float* src = q8 + 4 * i;           // head i / hw, word i % hw
      qi[i] = (int)((unsigned)(uint8_t)(int8_t)(int)src[0]
                    | ((unsigned)(uint8_t)(int8_t)(int)src[1] << 8)
                    | ((unsigned)(uint8_t)(int8_t)(int)src[2] << 16)
                    | ((unsigned)(uint8_t)(int8_t)(int)src[3] << 24));
    }
    // Σq and the self term of each head (warp i: head i)
    for (int i = warp; i < G; i += NW) {
      int qs = 0;
      double e = 0.0;
      for (int d = lane; d < hd; d += 32) {
        qs += (int)q8[i * hd + d];
        e += (double)((q8[i * hd + d] - oq) * (k8[d] - ok));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) qs += __shfl_xor_sync(0xffffffffu, qs, o);
      float sself = warp_sum(e) * sqk;
      if (a.qk_fq) sself = fqm(sself, m[12], m[13], m[14]);
      if (lane == 0) {
        qsum[i] = qs;
        lgs[i] = sself * inv;
      }
    }
    __syncthreads();
    auto score = [&](int acc, int qs, float ksum) {
      const float raw = (float)acc - ok * (float)qs - oq * ksum + hdoo;
      return a.qk_fq ? fqm(raw * sqk, m[12], m[13], m[14]) * inv : raw * cf;
    };
    // the G scores of one K row t[0 .. hd/16) (int4 words) into column col;
    // own_sum: the row's column sum is formed here, else it is ksum
    auto row_scores = [&](const int4* t, bool own_sum, float ksum, int col) {
      int acc[GMAX], ks = 0;
#pragma unroll
      for (int i = 0; i < GMAX; ++i) acc[i] = 0;
#pragma unroll
      for (int w4 = 0; w4 < 8; ++w4) {
        if (w4 < (hd >> 4)) {
          const int4 v = t[w4];
          if (own_sum)
            ks = __dp4a(v.w, 0x01010101, __dp4a(v.z, 0x01010101,
                 __dp4a(v.y, 0x01010101, __dp4a(v.x, 0x01010101, ks))));
#pragma unroll
          for (int i = 0; i < GMAX; ++i) {
            if (i < G) {
              const int* q = qi + i * hw + 4 * w4;
              acc[i] = __dp4a(q[0], v.x, acc[i]);
              acc[i] = __dp4a(q[1], v.y, acc[i]);
              acc[i] = __dp4a(q[2], v.z, acc[i]);
              acc[i] = __dp4a(q[3], v.w, acc[i]);
            }
          }
        }
      }
      const float kcol = own_sum ? (float)ks : ksum;
#pragma unroll
      for (int i = 0; i < GMAX; ++i)
        if (i < G) sc[i * SC + col] = score(acc[i], qsum[i], kcol);
    };
    // the stale cache rows [0, P), their K column sums from kcs
    const size_t seq = ((size_t)l * B + b) * Hkv + h;
    const float* kcs = a.kcs + seq * S;
    const int8_t* kc = a.kcache + seq * (size_t)S * hd;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      stage_rows(kvs, kc + (size_t)c0 * hd, nr * hd);
      for (int r = tid; r < nr; r += FT)
        row_scores(reinterpret_cast<const int4*>(kvs + (size_t)r * hd), false,
                   __ldg(kcs + c0 + r), c0 + r);
    }
    // the staged columns [0, mst), their column sums computed here
    const int8_t* skp = a.sk + seq * (size_t)ncs * hd;
    for (int r = tid; r < mst; r += FT)
      row_scores(reinterpret_cast<const int4*>(skp + (size_t)r * hd), true, 0.0f, S + r);
    __syncthreads();
    // warp i: head i's shared max, per-part exp, the denominator (cache +
    // self) + staged; strict: the fake-quanted probabilities and their sums
    for (int i = warp; i < G; i += NW) {
      float* si = sc + i * SC;
      float mx = __int_as_float(0xff800000);     // -inf
      for (int s2 = lane; s2 < P; s2 += 32) mx = fmaxf(mx, si[s2]);
      for (int r = lane; r < mst; r += 32) mx = fmaxf(mx, si[S + r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = fmaxf(mx, lgs[i]);
      double dc = 0.0, ds = 0.0;
      for (int s2 = lane; s2 < P; s2 += 32) {
        const float ev = expf(si[s2] - mx);
        si[s2] = ev;
        dc += (double)ev;
      }
      for (int r = lane; r < mst; r += 32) {
        const float ev = expf(si[S + r] - mx);
        si[S + r] = ev;
        ds += (double)ev;
      }
      const float e_self = expf(lgs[i] - mx);
      const float dn = (warp_sum(dc) + e_self) + warp_sum(ds);
      if (a.pv_fq) {
        double pc = 0.0, pst = 0.0;
        for (int s2 = lane; s2 < P; s2 += 32) {
          const float p = fqm(si[s2] / dn, m[15], m[16], m[17]);
          si[s2] = p;
          pc += (double)p;
        }
        for (int r = lane; r < mst; r += 32) {
          const float p = fqm(si[S + r] / dn, m[15], m[16], m[17]);
          si[S + r] = p;
          pst += (double)p;
        }
        const float a_pc = warp_sum(pc), a_ps = warp_sum(pst);
        if (lane == 0) {
          psc[i] = a_pc;
          pss[i] = a_ps;
          ps[i] = fqm(e_self / dn, m[15], m[16], m[17]);
        }
      }
      if (lane == 0) {
        es[i] = e_self;
        den[i] = dn;
      }
    }
    __syncthreads();
    // Σ p·v over the cache rows and the staged rows: output o = (head, dim);
    // thread group grp takes rows grp, grp + ng, ...
    const int grp = ng > 1 ? tid / nout : 0;
    double accC[4] = {0.0, 0.0, 0.0, 0.0}, accS[4] = {0.0, 0.0, 0.0, 0.0};
    const int8_t* vc = a.vcache + seq * (size_t)S * hd;
    for (int c0 = 0; c0 < P; c0 += KV_CHUNK) {
      const int nr = min(KV_CHUNK, P - c0);
      stage_rows(kvs, vc + (size_t)c0 * hd, nr * hd);
      if (grp < ng) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (ng > 1 ? tid % nout : tid) + j * FT;
          if (j < opt && o < nout) {
            const float* pr = sc + (o / hd) * SC + c0;
            const int8_t* vr = kvs + (o % hd);
            double acc = accC[j];
            for (int r = grp; r < nr; r += ng) acc += (double)pr[r] * (double)vr[(size_t)r * hd];
            accC[j] = acc;
          }
        }
      }
    }
    const int8_t* svp = a.sv + seq * (size_t)ncs * hd;
    if (grp < ng) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (ng > 1 ? tid % nout : tid) + j * FT;
        if (j < opt && o < nout) {
          const float* pr = sc + (o / hd) * SC + S;
          const int8_t* vr = svp + (o % hd);
          double acc = 0.0;
          for (int r = grp; r < mst; r += ng) acc += (double)pr[r] * (double)__ldg(vr + (size_t)r * hd);
          accS[j] = acc;
        }
      }
    }
    if (ng > 1) {                              // the row groups' partials, in group order
      if (grp < ng) {
        part[tid] = accC[0];
        part[FT + tid] = accS[0];
      }
      __syncthreads();
      if (tid < nout) {
        double tc = 0.0, ts = 0.0;
        for (int q = 0; q < ng; ++q) {
          tc += part[q * nout + tid];
          ts += part[FT + q * nout + tid];
        }
        accC[0] = tc;
        accS[0] = ts;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = tid + j * FT;
      if (j < opt && o < nout) {
        const int i = o / hd, d = o % hd;
        const double tc = accC[j], ts = accS[j];
        float at;
        if (a.pv_fq) {
          const float vnf = (v8[d] + 128.0f - m[11]) * vscale;
          at = ((float)tc - ov * psc[i]) * vscale;
          at = at + ((float)ts - ov * pss[i]) * vscale;
          at = at + ps[i] * vnf;
        } else {
          // relaxed: Σ e·v unnormalised, divided once
          const float A = (float)(tc + ts) + es[i] * v8[d];
          at = (A / den[i] - ov) * vscale;
        }
        a.a8[(size_t)b * Ko + (qh0 + i) * hd + d] = (int8_t)(int)quant_u8s(at, m[19], m[20]);
      }
    }
    __syncthreads();
  }
}

// ---- the kernels -------------------------------------------------------------

__device__ __forceinline__ void copy_mlp_meta(const Args& a, RowSmem& s) {
  if (threadIdx.x < 46) s.meta[threadIdx.x] = a.mlp_meta[threadIdx.x];
  __syncthreads();
}

// The MLP kernels of layer a.l0 over a.M rows of any count, walked in
// 128-row tiles (mlp_meta[0..31]), one instantiation per kind: MLP_BLOCK
// x_in (M, K) fp32 -> x_in + MLP(norm(x_in)) in x_out (NORM: NORM_RMS, or
// NORM_LN, the instantiation that the entry picks when a.ln is set); MLP_RAW
// h8 (M, K) int8 -> the raw Σ g8·w2 int32 sums as fp32 in x_out (M, K) and
// the g8 row sums in sx (M,); MLP_W2 h8 -> the w2 output with its affine
// epilogue in x_out. The C entry's mode is the kind.
constexpr int MLP_BLOCK = 0, MLP_RAW = 1, MLP_W2 = 2;

template <int MI, int WB, int KIND, int NORM>
__global__ void __launch_bounds__(FT) fused_mlp_tiles_kernel(const Args a, int) {
  RowSmem& s = row_smem();
  copy_mlp_meta(a, s);
  const float* mm = s.meta;
  const int K = a.K, l = a.l0;
  for (int m0 = 0; m0 < a.M; m0 += MAXR) {
    const int M = min(MAXR, a.M - m0);
    float* out = a.x_out + (size_t)m0 * K;
    if (m0 > 0) grid_barrier(a.bar);          // the last tile's act8 and workspace are free
    if constexpr (KIND == MLP_BLOCK) {
      rows_mlp<MI, WB, NORM>(a, s, l, mm, a.x_in + (size_t)m0 * K, out, M);
    } else {
      rows_gate<MI, WB>(a, s, l, mm, a.h8 + (size_t)m0 * K, M);
      grid_barrier(a.bar);
      if constexpr (KIND == MLP_RAW) {
        float* rsum = a.sx + m0;
        rows_w2<MI, WB>(a, s, l, M, [&](int r, int col, int acc, int rs) {
          out[(size_t)r * K + col] = (float)acc;
          if (col == 0) rsum[r] = (float)rs;
        });
      } else {
        const float xs = mm[14], ox = mm[15] - 128.0f, kox = (float)a.F * ox;
        rows_w2<MI, WB>(a, s, l, M, [&](int r, int col, int acc, int rs) {
          out[(size_t)r * K + col] = affine(a.w2, l, acc, col, (float)rs, xs, ox, kox);
        });
      }
    }
  }
}

// The o-tail and chunk kernels are compiled for two blocks an SM (at most
// 128 registers a thread) at MI <= 2, and the W4 chunk kernel at MI = 4 too:
// left to itself ptxas moves these editions between 128 registers (two blocks
// an SM) and 146-255 (one) with small changes to the code, and the chunk
// step's time by 25-35% with them.
template <int MI, int WB>
__global__ void __launch_bounds__(FT, MI <= 2 ? 2 : 1)
    fused_otail_kernel(const Args a, int) {
  RowSmem& s = row_smem();
  copy_mlp_meta(a, s);
  rows_o<MI, WB>(a, s, a.l0, s.meta + 32, a.x_in);
  grid_barrier(a.bar);
  rows_mlp<MI, WB, NORM_RUNTIME>(a, s, a.l0, s.meta, a.resid, a.x_out, a.M);
}

// DPL: the attention stage's edition (stage_chunk_attention), 4 up to hd
// 128, 8 at hd 256 (fused_rows_hd256.cu, fused_rows_hd256_w8.cu).
template <int MI, int WB, int DPL>
__global__ void __launch_bounds__(FT, (MI <= 2 || (MI == 4 && WB == 4)) ? 2 : 1)
    fused_chunk_kernel(const Args a, int) {
  RowSmem& s = row_smem();
  const int K = a.K, M = a.M, Nq = a.qkv.n;
  stamp(a, 0);
  int ts = 1;
  for (int l = a.l0; l < a.l1; ++l) {
    const float* m = a.meta + (size_t)l * META;
    const float* xin = l == a.l0 ? a.x_in : a.x_out;
    rows_norm<NORM_RUNTIME>(xin, M, K, a.anw + (size_t)l * K, a.anb + (size_t)l * K, m[0],
                            m[1], m[2], m[3], m[4], m[5], a.ln, a.h8, s);
    grid_barrier(a.bar);
    stamp(a, ts++);
    {
      const float xs = m[4], ox = m[5] - 128.0f, kox = (float)K * ox;
      const float* ofq = a.ofq + (size_t)l * 4 * Nq;
      rows_matvec<MI, WB>(a.h8, M, K, layer_w<WB>(a.qkv, l), Nq, false, 0, a.ws, s,
                          [&](const Tile& t, int (&acc)[MI][8]) {
        const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int r = ty + 16 * i;
          if (r >= M) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = tx + 16 * j;
            if (!t.valid(n)) continue;
            const int col = t.colA + n;
            float y = affine(a.qkv, l, acc[i][j], col, (float)s.rsum[r], xs, ox, kox);
            const float fs = __ldg(ofq + col), fo = __ldg(ofq + Nq + col);
            const float fc = __ldg(ofq + 2 * Nq + col), fe = __ldg(ofq + 3 * Nq + col);
            float q = rintf(y / fs) + fo;
            q = fminf(fmaxf(q, 0.0f), fc);
            if (fe > 0.5f) y = (q - fo) * fs;
            a.yq[(size_t)r * Nq + col] = y;
          }
        }
      });
    }
    grid_barrier(a.bar);
    stamp(a, ts++);
    // above 64 rows (one block an SM): one item per (sequence, kv head). The
    // grouped stage holds at most 4 dims a lane (8 int4 words a K row, 4
    // outputs a thread), so the hd-256 edition takes the per-head stage at
    // every B (Gemma-2B has one kv head: B·Hkv <= 128 items never fill the
    // grid of 132 SMs anyway).
    if constexpr (MI == 8 && DPL == 4) {
      if (a.M * a.Hkv >= (int)gridDim.x && GMAX % (a.Hq / a.Hkv) == 0)
        stage_chunk_attention_grouped(a, l);
      else
        stage_chunk_attention<DPL>(a, l);
    } else {
      stage_chunk_attention<DPL>(a, l);
    }
    grid_barrier(a.bar);
    stamp(a, ts++);
    rows_o<MI, WB>(a, s, l, m + 19, xin);
    grid_barrier(a.bar);
    stamp(a, ts++);
    rows_mlp<MI, WB, NORM_RUNTIME>(a, s, l, m + AM, a.resid, a.x_out, M);
    if (l + 1 < a.l1 || a.logits || a.trace) grid_barrier(a.bar);
    stamp(a, ts++);
  }
  if (a.logits) {
    rows_head_norm(a, s);
    grid_barrier(a.bar);
    stamp(a, ts++);
    const int Vp = a.Vp;
    auto head_epi = [&](const Tile& t, int (&acc)[MI][8]) {
      const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = ty + 16 * i;
        if (r >= M) continue;
        const float sxr = __ldcg(a.sx + r);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (!t.valid(n)) continue;
          const int col = t.colA + n;
          const float ow = __ldg(a.hoffset + col), sw = __ldg(a.hscale + col);
          a.logits[(size_t)r * Vp + col] = ((float)acc[i][j] - ow * (float)s.rsum[r]) * (sxr * sw);
        }
      }
    };
    if (a.hbits == 8)
      rows_matvec<MI, 8>(a.h8, M, K, a.hwq, Vp, false, 0, a.ws, s, head_epi);
    else
      rows_matvec<MI, 4>(a.h8, M, K, a.hwq, Vp, false, 0, a.ws, s, head_epi);
    if (a.trace) grid_barrier(a.bar);
    stamp(a, ts);
  }
}

int mi_of(int M) { return M <= 16 ? 1 : (M <= 32 ? 2 : (M <= 64 ? 4 : 8)); }

bool rows_ok(const Args& a) {
  return a.M >= 1 && a.M <= MAXR && a.K % 128 == 0 && a.F % 64 == 0;
}


// the chunk kernel's shared memory: the row stages', the per-head attention
// stage's and, up to hd 128 (the editions that may take it), the grouped one's
size_t chunk_smem(const Args& a) {
  const AttnLayout lay(a.hd, a.S, a.ncs, a.hd <= 128 ? 4 : 8);
  size_t sm = lay.end > sizeof(RowSmem) ? lay.end : sizeof(RowSmem);
  if (a.hd > 128) return sm;
  const GroupLayout glay(a.hd, a.S, a.ncs, a.Hq / a.Hkv <= GMAX ? a.Hq / a.Hkv : 1);
  return glay.end > sm ? glay.end : sm;
}

// the MLP tiles kernel's arguments (a.ln, LayerNorm, on the MLP_BLOCK kind
// only, W4 or W8)
bool tiles_ok(const Args& a, int mode) {
  return a.M >= 1 && a.K % 64 == 0 && a.F % 64 == 0 && a.w2.bits == a.w13.bits
         && (a.w13.bits == 4 || a.w13.bits == 8) && mode >= MLP_BLOCK && mode <= MLP_W2
         && (!a.ln || mode == MLP_BLOCK);
}

template <int WB, int KIND, int NORM = NORM_RMS>
int launch_mlp_tiles(const Args& a, cudaStream_t st) {
  const size_t sm = sizeof(RowSmem);
  switch (mi_of(a.M < MAXR ? a.M : MAXR)) {
    case 1: return launch_coop(fused_mlp_tiles_kernel<1, WB, KIND, NORM>, a, 0, sm, st);
    case 2: return launch_coop(fused_mlp_tiles_kernel<2, WB, KIND, NORM>, a, 0, sm, st);
    case 4: return launch_coop(fused_mlp_tiles_kernel<4, WB, KIND, NORM>, a, 0, sm, st);
    default: return launch_coop(fused_mlp_tiles_kernel<8, WB, KIND, NORM>, a, 0, sm, st);
  }
}

template <int WB>
int launch_otail(const Args& a, cudaStream_t st) {
  const size_t sm = sizeof(RowSmem);
  switch (mi_of(a.M)) {
    case 1: return launch_coop(fused_otail_kernel<1, WB>, a, 0, sm, st);
    case 2: return launch_coop(fused_otail_kernel<2, WB>, a, 0, sm, st);
    case 4: return launch_coop(fused_otail_kernel<4, WB>, a, 0, sm, st);
    default: return launch_coop(fused_otail_kernel<8, WB>, a, 0, sm, st);
  }
}

template <int WB, int DPL = 4>
int launch_chunk(const Args& a, cudaStream_t st) {
  const size_t sm = chunk_smem(a);
  switch (mi_of(a.M)) {
    case 1: return launch_coop(fused_chunk_kernel<1, WB, DPL>, a, 0, sm, st);
    case 2: return launch_coop(fused_chunk_kernel<2, WB, DPL>, a, 0, sm, st);
    case 4: return launch_coop(fused_chunk_kernel<4, WB, DPL>, a, 0, sm, st);
    default: return launch_coop(fused_chunk_kernel<8, WB, DPL>, a, 0, sm, st);
  }
}

}  // namespace

// The launches of the other translation units: the W8 MLP block and chunk
// kernels (fused_rows_w8.cu), the W8 o-tail (fused_otail_w8.cu), the
// MLP_RAW / MLP_W2 kernels, W4 and W8 (fused_mlp_tiles.cu), the MLP
// block's LayerNorm kind, W4 and W8 (fused_rows_ln.cu), and the chunk
// kernel's hd-256 editions, W4 (fused_rows_hd256.cu) and W8
// (fused_rows_hd256_w8.cu); the arguments are checked by the entries of
// fused_rows.cu.
int mqt_rows_w8_mlp(const MqtFusedArgs& a, cudaStream_t st);
int mqt_rows_mlp_ln(const MqtFusedArgs& a, cudaStream_t st);
int mqt_rows_w8_chunk(const MqtFusedArgs& a, cudaStream_t st);
int mqt_rows_chunk_hd256(const MqtFusedArgs& a, cudaStream_t st);
int mqt_rows_w8_chunk_hd256(const MqtFusedArgs& a, cudaStream_t st);
int mqt_rows_w8_otail(const MqtFusedArgs& a, cudaStream_t st);
int mqt_rows_mlp_raw_w2(const MqtFusedArgs& a, int mode, cudaStream_t st);
