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
// grid barrier), with the stages rebuilt for many rows:
//   - a norm is a stage of its own, one block per row (the fp64 sums, the
//     norm, the quantization), writing int8 rows; a grid barrier follows.
//     Every norm is RMSNorm, or (StableLM) LayerNorm: a mean pass first,
//     then the sum of squares of x − mean, both fp64, then the bias; the
//     chunk and o-tail kernels read the flag a.ln at run time (a branch once
//     per row), so one instantiation serves both norms; the MLP tiles kernel
//     has an instantiation for each norm, which its entry picks by a.ln;
//   - a matvec stage (rows_matvec) runs the int8 tensor-core tile core of
//     tc_tile.cuh (w13_gate.cu's, w4a8_matmul.cu's and qkv_rope.cu's): 64-row
//     x 128-column tiles of mma.sync m16n8k32 over a four-stage cp.async ring
//     of activation and weight chunks (64 packed rows, 128 k values), the W4
//     nibbles unpacked in registers, the row sums from the activation words.
//     Where the tiles leave blocks idle, K is split (about one item a block,
//     at least 2 chunks a split) and the splits meet without atomics: plain
//     stores into the workspace's slabs, a grid barrier, then every block
//     sums the splits of its share of the outputs in split order and runs
//     the epilogue; an unsplit tile runs it in its own block. The row tiles
//     of a column tile run side by side, so its weights come once from
//     device memory and once more from L2;
//   - the MLP kernels of any M (the per-layer MLP block, fused_mlp, w13 +
//     gate + w2) walk the rows in 128-row steps inside the one launch: per
//     step the norm (the MLP block), the w13 + gate stage and the w2 stage,
//     a grid barrier after each; the weights are re-read per step (from
//     the 50 MB L2 when a layer's matrices fit it);
//   - the chunk kernel's attention: one block per (sequence, q head), RoPE
//     and joint quantization (the group's first q head writes the new K/V
//     rows), scores over the stale cache rows [0, pos0) staged through shared
//     memory with the cache's K column sums from kcs, the staged columns
//     [0, m) with their column sums computed here, the self term; one shared
//     max, per-part exp, the denominator (cache + self) + staged; masked rows
//     add exactly 0 (neg_inf <= -1e4), so only valid rows are read. Above
//     64 rows, where such items fill the grid, an item is a (sequence, kv
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
#include "tc_tile.cuh"

namespace {

constexpr int MAXR = 128;        // rows a launch (the MLP tiles kernel: a step of its walk)
                                 // takes: two 64-row tiles
constexpr int HALF = TC_BN / 2;  // gate outputs of a tile (its w1 | w3 columns)

// The fixed part of the row kernels' dynamic shared memory; the tile core's
// ring (where a finished tile is staged) follows at RING_OFF, and the chunk
// kernel's attention stages lay their arrays over both from byte 0 (the
// stages are apart: a grid barrier, which starts with __syncthreads, lies
// between any two).
struct RowSmem {
  int rsum[TC_BM];               // a tile's row sums (tc_tile)
  double dred[NW];
  float fred[NW];
  float meta[48];                // MLP-block / o-tail meta copy
};
constexpr int RING_OFF = 640;    // ops/mlp_block.ROW_RING_OFFSET
static_assert(sizeof(RowSmem) <= RING_OFF && RING_OFF % 128 == 0, "RowSmem before the ring");

__device__ __forceinline__ char* smem_base() {
  extern __shared__ int4 smem_raw[];
  return reinterpret_cast<char*>(smem_raw);
}

__device__ __forceinline__ RowSmem& row_smem() {
  return *reinterpret_cast<RowSmem*>(smem_base());
}

// dynamic shared memory of a row kernel whose matvec stages read WB-bit weights
__host__ __device__ constexpr size_t rows_smem(int wb) {
  return RING_OFF + (wb == 8 ? tc_smem_bytes<8>() : tc_smem_bytes<4>());
}

// The plan of one matvec stage (mirrored by ops/mlp_block.rows_plan): rt
// row tiles of 64 rows by ct column tiles (128 columns; a gate tile: the w1
// and w3 columns of 64 outputs); K in nch chunks of 64 packed rows (128 k
// values), split ks ways, cps chunks a split, where the tiles alone leave
// blocks of the grid idle: as many items as blocks at most, at least 2
// chunks a split (on an H100 a block's first chunk takes ~4 µs in this
// launch and each later one ~2.3, so more, shorter splits beat fewer, longer
// ones: scripts/probe_rows_stages.py). Every block computes the same plan
// from gridDim.
struct RowPlan {
  int rt, ct, nch, ks, cps;
  __device__ RowPlan(int M, int kin, int cols) {
    rt = (M + TC_BM - 1) / TC_BM;
    ct = cols;
    nch = ((kin >> 1) + TC_KP - 1) / TC_KP;
    const int tiles = rt * ct;
    ks = 1;
    if (tiles < (int)gridDim.x) {
      const int cap = nch / 2 > 1 ? nch / 2 : 1;
      ks = (int)gridDim.x / tiles;
      if (ks > cap) ks = cap;
    }
    cps = (nch + ks - 1) / ks;
    ks = (nch + cps - 1) / cps;
  }
};

// One matvec stage on the int8 tensor-core tile core (tc_tile.cuh: 64 x 128
// tiles of mma.sync m16n8k32 over a four-stage cp.async ring, W4 nibbles
// unpacked in registers, the products of rows past M skipped): x (M, kin)
// int8, M <= 128, times the (kin/2, N) W4
// or (kin, N) W8 matrix w; gate: N = 2F and output j reads columns j (w1) and
// F + j (w3). epi(r, c, acc, acc3, rowsum) runs once for each output (r, c)
// of the M rows, c < N (gate: c < F, acc3 the w3 column's sum; else 0), with
// the row's activation sum. Item it of the stage is row tile it % rt of
// split (it / rt) % ks of column tile it / (rt ks), so the row tiles of a
// column tile run side by side and its weights come the second time from L2.
// An unsplit tile is staged in its block's free ring, whose threads run the
// epilogue over it, consecutive threads on consecutive columns. A split tile
// meets without atomics: each split stores its partial sums into its slab
// (sp, M, N) of the workspace and its row sums after the ks slabs with plain
// stores; after a grid barrier every block takes outputs of the stage and
// sums their splits in split order (integer sums, exact in any order). x may
// have been written in this launch: the ring's copies read it through L2.
template <int WB, typename Epi>
__device__ void rows_matvec(const int8_t* x, int M, int kin, const int8_t* w, int N, bool gate,
                            int* ws, unsigned* bar, RowSmem& s, Epi epi) {
  const int F = N >> 1;
  const RowPlan p(M, kin, gate ? F / HALF : (N + TC_BN - 1) / TC_BN);
  int8_t* ring = reinterpret_cast<int8_t*>(smem_base() + RING_OFF);
  int* st = reinterpret_cast<int*>(ring);
  int* wrs = ws + (size_t)p.ks * M * N;                 // the splits' row sums (ks, M)
  const int tw = gate ? HALF : TC_BN;                   // outputs a tile row
  for (int it = blockIdx.x; it < p.rt * p.ct * p.ks; it += gridDim.x) {
    const int y = it % p.rt, sp = (it / p.rt) % p.ks, c = it / (p.rt * p.ks);
    const int m0 = y * TC_BM;
    const ColMap cm = gate ? ColMap{c * HALF, F + c * HALF, HALF, HALF, HALF}
                           : ColMap{c * TC_BN, 0, TC_BN, min(TC_BN, N - c * TC_BN), 0};
    TcAcc acc;
    tc_tile<WB, true, true>(x, w, M, kin, N, m0, cm, sp * p.cps, min(p.nch, (sp + 1) * p.cps),
                            ring, s.rsum, acc);
    if (p.ks == 1) {
      tc_stage(acc, st);
      const int rows = min(TC_BM, M - m0);
      for (int i = threadIdx.x; i < rows * tw; i += FT) {
        const int r = i / tw, n = i % tw;
        if (cm.valid(n))
          epi(m0 + r, cm.colA + n, st[r * TC_LD + n], gate ? st[r * TC_LD + HALF + n] : 0,
              s.rsum[r]);
      }
    } else {
      // fragment e of d[mt][0..3] is 4 consecutive columns of one row
      int* slab = ws + (size_t)sp * M * N;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gm = m0 + tc_row(mt, e), n = tc_col(0, e);
          if (gm < M && cm.valid(n))
            *reinterpret_cast<int4*>(slab + (size_t)gm * N + cm.gcol(n)) = make_int4(
                acc.d[mt][0][e], acc.d[mt][1][e], acc.d[mt][2][e], acc.d[mt][3][e]);
        }
      if (c == 0 && threadIdx.x < TC_BM && m0 + (int)threadIdx.x < M)
        wrs[sp * M + m0 + threadIdx.x] = s.rsum[threadIdx.x];
    }
    __syncthreads();                                    // the ring and rsum are free again
  }
  if (p.ks == 1) return;
  grid_barrier(bar);
  const int no = gate ? F : N;
  for (int i = blockIdx.x * FT + threadIdx.x; i < M * no; i += gridDim.x * FT) {
    const int r = i / no, cc = i % no;
    int a0 = 0, a1 = 0, rs = 0;
    for (int sp = 0; sp < p.ks; ++sp) {
      const int* row = ws + ((size_t)sp * M + r) * N;
      a0 += __ldcg(row + cc);
      if (gate) a1 += __ldcg(row + F + cc);
      rs += __ldcg(wrs + sp * M + r);
    }
    epi(r, cc, a0, a1, rs);
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
template <int WB>
__device__ void rows_o(const Args& a, RowSmem& s, int l, const float* mo, const float* xin) {
  const int K = a.K, Ko = a.o.kin, M = a.M;
  const float xs = mo[0], ox = mo[1] - 128.0f, kox = (float)Ko * ox;
  const float fo[12] = {mo[2], mo[3], mo[4], mo[5], mo[6], mo[7],
                        mo[8], mo[9], mo[10], mo[11], mo[12], mo[13]};
  rows_matvec<WB>(a.a8, M, Ko, layer_w<WB>(a.o, l), K, false, a.ws, a.bar, s,
                  [&](int r, int col, int acc, int, int rs) {
    float y = affine(a.o, l, acc, col, (float)rs, xs, ox, kox);
    y = fqm(y, fo[0], fo[1], fo[2]);
    const float xr = fqm(__ldcg(xin + (size_t)r * K + col), fo[3], fo[4], fo[5]);
    y = fqm(y, fo[6], fo[7], fo[8]);
    a.resid[(size_t)r * K + col] = fqm(xr + y, fo[9], fo[10], fo[11]);
  });
}

// w13 + gate chain of layer l over h (M, K) int8 -> a.act8 (M, F) int8 (the
// w2 input); mm is the 32-float MLP-block meta (entries 0..15 read).
template <int WB>
__device__ void rows_gate(const Args& a, RowSmem& s, int l, const float* mm, const int8_t* h,
                          int M) {
  const int K = a.K, F = a.F;
  const float xs = mm[0], ox = mm[1] - 128.0f, kox = (float)K * ox;
  rows_matvec<WB>(h, M, K, layer_w<WB>(a.w13, l), 2 * F, true, a.ws, a.bar, s,
                  [&](int r, int j, int acc1, int acc3, int rsi) {
    const float rs = (float)rsi;
    float g1 = affine(a.w13, l, acc1, j, rs, xs, ox, kox);
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
    float g3 = affine(a.w13, l, acc3, F + j, rs, xs, ox, kox);
    g3 = fqm(g3, mm[11], mm[12], mm[13]);
    a.act8[(size_t)r * F + j] = (int8_t)(int)quant_u8s(act * g3, mm[14], mm[15]);
  });
}

// w2 of layer l over a.act8 (M, F): out(r, col, acc, rowsum) for every output
// of the M rows, with the raw int32 sum and the act row's sum.
template <int WB, typename Out>
__device__ void rows_w2(const Args& a, RowSmem& s, int l, int M, Out out) {
  rows_matvec<WB>(a.act8, M, a.F, layer_w<WB>(a.w2, l), a.K, false, a.ws, a.bar, s,
                  [&](int r, int col, int acc, int, int rs) { out(r, col, acc, rs); });
}

// The MLP block of layer l over src (M, K) -> out (M, K); mm is the 32-float
// MLP-block meta; NORM (rows_norm): the norm, NORM_RUNTIME reading a.ln.
// Three stages, two grid barriers between them.
template <int WB, int NORM>
__device__ void rows_mlp(const Args& a, RowSmem& s, int l, const float* mm, const float* src,
                         float* out, int M) {
  const int K = a.K, F = a.F;
  rows_norm<NORM>(src, M, K, a.mnw + (size_t)l * K, a.mnb + (size_t)l * K, mm[16], mm[17],
                  mm[18], mm[19], mm[0], mm[1], a.ln, a.h8, s);
  grid_barrier(a.bar);
  rows_gate<WB>(a, s, l, mm, a.h8, M);
  grid_barrier(a.bar);
  const float xs = mm[14], ox = mm[15] - 128.0f, kox = (float)F * ox;
  rows_w2<WB>(a, s, l, M, [&](int r, int col, int acc, int rs) {
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
// 128-row steps (mlp_meta[0..31]), one instantiation per kind: MLP_BLOCK
// x_in (M, K) fp32 -> x_in + MLP(norm(x_in)) in x_out (NORM: NORM_RMS, or
// NORM_LN, the instantiation that the entry picks when a.ln is set); MLP_RAW
// h8 (M, K) int8 -> the raw Σ g8·w2 int32 sums as fp32 in x_out (M, K) and
// the g8 row sums in sx (M,); MLP_W2 h8 -> the w2 output with its affine
// epilogue in x_out. The C entry's mode is the kind.
constexpr int MLP_BLOCK = 0, MLP_RAW = 1, MLP_W2 = 2;

// Every row kernel is compiled for two blocks an SM (at most 128 registers
// a thread): the tile core's accumulators are the same at every row count,
// and a launch takes one block an SM where two do not fit.
template <int WB, int KIND, int NORM>
__global__ void __launch_bounds__(FT, 2) fused_mlp_tiles_kernel(const Args a, int) {
  RowSmem& s = row_smem();
  copy_mlp_meta(a, s);
  const float* mm = s.meta;
  const int K = a.K, l = a.l0;
  for (int m0 = 0; m0 < a.M; m0 += MAXR) {
    const int M = min(MAXR, a.M - m0);
    float* out = a.x_out + (size_t)m0 * K;
    if (m0 > 0) grid_barrier(a.bar);          // the last step's act8 and slabs are free
    if constexpr (KIND == MLP_BLOCK) {
      rows_mlp<WB, NORM>(a, s, l, mm, a.x_in + (size_t)m0 * K, out, M);
    } else {
      rows_gate<WB>(a, s, l, mm, a.h8 + (size_t)m0 * K, M);
      grid_barrier(a.bar);
      if constexpr (KIND == MLP_RAW) {
        float* rsum = a.sx + m0;
        rows_w2<WB>(a, s, l, M, [&](int r, int col, int acc, int rs) {
          out[(size_t)r * K + col] = (float)acc;
          if (col == 0) rsum[r] = (float)rs;
        });
      } else {
        const float xs = mm[14], ox = mm[15] - 128.0f, kox = (float)a.F * ox;
        rows_w2<WB>(a, s, l, M, [&](int r, int col, int acc, int rs) {
          out[(size_t)r * K + col] = affine(a.w2, l, acc, col, (float)rs, xs, ox, kox);
        });
      }
    }
  }
}

template <int WB>
__global__ void __launch_bounds__(FT, 2) fused_otail_kernel(const Args a, int) {
  RowSmem& s = row_smem();
  copy_mlp_meta(a, s);
  rows_o<WB>(a, s, a.l0, s.meta + 32, a.x_in);
  grid_barrier(a.bar);
  rows_mlp<WB, NORM_RUNTIME>(a, s, a.l0, s.meta, a.resid, a.x_out, a.M);
}

// DPL: the attention stage's edition (stage_chunk_attention), 4 up to hd
// 128, 8 at hd 256 (fused_rows_hd256.cu, fused_rows_hd256_w8.cu).
template <int WB, int DPL>
__global__ void __launch_bounds__(FT, 2) fused_chunk_kernel(const Args a, int) {
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
      rows_matvec<WB>(a.h8, M, K, layer_w<WB>(a.qkv, l), Nq, false, a.ws, a.bar, s,
                      [&](int r, int col, int acc, int, int rs) {
        float y = affine(a.qkv, l, acc, col, (float)rs, xs, ox, kox);
        const float fs = __ldg(ofq + col), fo = __ldg(ofq + Nq + col);
        const float fc = __ldg(ofq + 2 * Nq + col), fe = __ldg(ofq + 3 * Nq + col);
        float q = rintf(y / fs) + fo;
        q = fminf(fmaxf(q, 0.0f), fc);
        if (fe > 0.5f) y = (q - fo) * fs;
        a.yq[(size_t)r * Nq + col] = y;
      });
    }
    grid_barrier(a.bar);
    stamp(a, ts++);
    // above 64 rows: one item per (sequence, kv head) where such items fill
    // the grid. The grouped stage holds at most 4 dims a lane (8 int4 words
    // a K row, 4 outputs a thread), so the hd-256 edition takes the per-head
    // stage at every B (Gemma-2B has one kv head: B·Hkv <= 128 items never
    // fill the grid anyway).
    if constexpr (DPL == 4) {
      if (M > 64 && M * a.Hkv >= (int)gridDim.x && GMAX % (a.Hq / a.Hkv) == 0)
        stage_chunk_attention_grouped(a, l);
      else
        stage_chunk_attention<DPL>(a, l);
    } else {
      stage_chunk_attention<DPL>(a, l);
    }
    grid_barrier(a.bar);
    stamp(a, ts++);
    rows_o<WB>(a, s, l, m + 19, xin);
    grid_barrier(a.bar);
    stamp(a, ts++);
    rows_mlp<WB, NORM_RUNTIME>(a, s, l, m + AM, a.resid, a.x_out, M);
    if (l + 1 < a.l1 || a.logits || a.trace) grid_barrier(a.bar);
    stamp(a, ts++);
  }
  if (a.logits) {
    rows_head_norm(a, s);
    grid_barrier(a.bar);
    stamp(a, ts++);
    const int Vp = a.Vp;
    auto head_epi = [&](int r, int col, int acc, int, int rs) {
      const float ow = __ldg(a.hoffset + col), sw = __ldg(a.hscale + col);
      a.logits[(size_t)r * Vp + col] = ((float)acc - ow * (float)rs) * (__ldcg(a.sx + r) * sw);
    };
    if (a.hbits == 8)
      rows_matvec<8>(a.h8, M, K, a.hwq, Vp, false, a.ws, a.bar, s, head_epi);
    else
      rows_matvec<4>(a.h8, M, K, a.hwq, Vp, false, a.ws, a.bar, s, head_epi);
    if (a.trace) grid_barrier(a.bar);
    stamp(a, ts);
  }
}

bool rows_ok(const Args& a) {
  return a.M >= 1 && a.M <= MAXR && a.K % 128 == 0 && a.F % 64 == 0;
}

// the chunk kernel's shared memory: the tile ring of its widest weights (the
// layers', or a W8 head's), the per-head attention stage's and, up to hd 128
// (the editions that may take it), the grouped one's
template <int WB>
size_t chunk_smem(const Args& a) {
  size_t sm = rows_smem(a.logits && a.hbits > WB ? a.hbits : WB);
  const AttnLayout lay(a.hd, a.S, a.ncs, a.hd <= 128 ? 4 : 8);
  if (lay.end > sm) sm = lay.end;
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
  return launch_coop(fused_mlp_tiles_kernel<WB, KIND, NORM>, a, 0, rows_smem(WB), st);
}

template <int WB>
int launch_otail(const Args& a, cudaStream_t st) {
  return launch_coop(fused_otail_kernel<WB>, a, 0, rows_smem(WB), st);
}

template <int WB, int DPL = 4>
int launch_chunk(const Args& a, cudaStream_t st) {
  return launch_coop(fused_chunk_kernel<WB, DPL>, a, 0, chunk_smem<WB>(a), st);
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
