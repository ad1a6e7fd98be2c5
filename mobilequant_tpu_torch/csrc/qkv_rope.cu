// Prefill qkv projection with the attention-input epilogue:
//   h8 (M, K) shifted int8 × W4 qkv (K/2, Nq) or W8 qkv (K, Nq) -> affine bracket
//   -> per-column output fake-quant (ofq rows: scale, offset, clip, enabled)
//   -> rotate-half RoPE inside each head (partner = y[d ± rot/2], cos=1 /
//      sin=0 past rotary_dim, the rope mask lets v columns pass)
//   -> per-segment int8 quantization (outq rows: scale, offset, rope mask)
//   -> (M, Nq) shifted int8: q rows for attention, k/v rows for the cache.
//
// Replaces mobilequant_tpu/ops/pallas_qkv.py: qkv_rope_stacked
// (_qkv_rope_kernel), both of its editions (wbits 4 and 8, from the pack's
// shape there, an argument here).
//
// Bound: at prefill M the integer operations of the matmul (the epilogue is
// a few dozen fp32 operations per output). Design: the int8 tensor-core tile
// core (tc_tile.cuh: mma.sync m16n8k32 on 64 x 128 tiles over a four-stage
// cp.async ring, templated on the weight bits), split over K by the caller's
// plan (ops/qkv_rope.tile_plan) so that a 128-row prompt still fills the
// card, the K splits of a tile one thread-block cluster meeting in shared
// memory (tc_cluster_reduce); the tile is staged in the free ring, and each
// block finishes its share of the tile's rows there, so that each output
// can read its RoPE partner column in its row, which is why a tile must hold
// whole heads (128 % head_dim == 0).
// At head_dim 256 with full rotary (Gemma: the partner is 128 columns away) a
// tile is two 64-column runs of one head, [64 p, 64 p + 64) and
// [128 + 64 p, 192 + 64 p) (p = 0, 1), so every column and its partner still
// meet in the tile (the PAIRED edition; the tile core's column map reads the
// two runs). The written rows are the int8 KV cache: rintf (half to even),
// true division and no fused multiply-add keep them equal to the plain
// version's.
#include "tc_tile.cuh"

namespace {

using namespace mqt;

struct QkvArgs {
  const float* ofq;    // (4, Nq): scale, offset, clip max, enabled
  const float* outq;   // (3, Nq): quant scale, quant offset, rope mask
  const float* cs;     // (M, 2 hd): cos | sign-baked sin
  int hd, shift;       // head_dim, rotary_dim / 2
};

// PAIRED: tile x of a head_dim-256 head h = x / 2 holds its columns
// 256 h + 64 p + [0, 64) and 256 h + 128 + 64 p + [0, 64), p = x % 2
template <int WB, bool PAIRED>
__global__ void __launch_bounds__(TC_THREADS, 2)
qkv_rope_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, Affine aff,
                QkvArgs qa, int8_t* __restrict__ out, int M, int K, int N, int cps) {
  extern __shared__ int4 ring_raw[];
  int8_t* ring = reinterpret_cast<int8_t*>(ring_raw);
  int* st = reinterpret_cast<int*>(ring_raw);
  __shared__ int rsum[TC_BM];
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
  const int ks = gridDim.z, z = blockIdx.z;
  const int nchunks = ((K >> 1) + TC_KP - 1) / TC_KP;
  const int c0 = z * cps, c1 = min(nchunks, c0 + cps);
  constexpr int RUN = TC_BN / 2;   // PAIRED: columns of a run
  const int pa = (blockIdx.x >> 1) * 2 * TC_BN + (blockIdx.x & 1) * RUN;
  // N % 128 == 0 (checked by the caller); PAIRED: N % 256 == 0
  const ColMap cm = PAIRED ? ColMap{pa, pa + TC_BN, RUN, RUN, RUN}
                           : ColMap{n0, 0, TC_BN, TC_BN, 0};
  TcAcc acc;
  tc_tile<WB>(x, w, M, K, N, m0, cm, c0, c1, ring, rsum, acc);
  tc_stage(acc, st);
  if (ks > 1) tc_cluster_reduce(st, rsum, ks);

  // this block's rows of the tile (z, z + ks, ...): affine bracket + output
  // fake-quant, each total replaced by its fp32 value in place
  const int nel = tc_rows_of(z, ks) * TC_BN;
  for (int i = threadIdx.x; i < nel; i += TC_THREADS) {
    const int r = z + ks * (i / TC_BN), nl = i % TC_BN, col = cm.gcol(nl);
    float v = aff(st[r * TC_LD + nl], col, (float)rsum[r]);
    const float fs = qa.ofq[col], fo = qa.ofq[N + col];
    const float fc = qa.ofq[2 * N + col], fe = qa.ofq[3 * N + col];
    float q = rintf(v / fs) + fo;
    q = fminf(fmaxf(q, 0.0f), fc);
    if (fe > 0.5f) v = (q - fo) * fs;
    st[r * TC_LD + nl] = __float_as_int(v);
  }
  __syncthreads();

  // RoPE + segment quantization, one output byte per (row, column); the
  // partner is in the same row
  for (int i = threadIdx.x; i < nel; i += TC_THREADS) {
    const int r = z + ks * (i / TC_BN), nl = i % TC_BN, gm = m0 + r;
    if (gm >= M) continue;
    const int col = cm.gcol(nl);
    // the head dim, and the partner's local column (PAIRED: the other run)
    const int d = PAIRED ? col % qa.hd : nl % qa.hd;
    float v = __int_as_float(st[r * TC_LD + nl]);
    if (qa.outq[2 * N + col] > 0.5f) {
      const int pl = PAIRED ? (nl < RUN ? nl + RUN : nl - RUN)
                            : (d < qa.shift ? nl + qa.shift : nl - qa.shift);
      const float partner = __int_as_float(st[r * TC_LD + pl]);
      const float cv = qa.cs[(size_t)gm * 2 * qa.hd + d];
      const float sv = qa.cs[(size_t)gm * 2 * qa.hd + qa.hd + d];
      v = v * cv + partner * sv;
    }
    const float s = qa.outq[col], o = qa.outq[N + col];
    float q = rintf(v / s) + o;
    q = fminf(fmaxf(q, 0.0f), 255.0f) - 128.0f;
    out[(size_t)gm * N + col] = (int8_t)(int)q;
  }
}

template <int WB, bool PAIRED>
int launch_qkv(dim3 grid, const int8_t* x, const int8_t* w, const Affine& aff,
               const QkvArgs& qa, int8_t* out, int M, int K, int N, int cps, cudaStream_t st) {
  return tc_launch_cluster<qkv_rope_kernel<WB, PAIRED>>(grid, tc_smem_bytes<WB>(), st, x, w, aff,
                                                        qa, out, M, K, N, cps);
}

}  // namespace

// ks, cps: the K split, ks blocks of cps 64-packed-row chunks a column tile,
// one thread-block cluster (ops/qkv_rope.tile_plan).
MQT_EXPORT int mqt_qkv_rope(const void* x, const void* w, const void* scale,
                            const void* offset, const void* colsum,
                            const void* bias, const void* ofq, const void* outq,
                            const void* cs, void* out, int M, int K, int N, int sstride,
                            float h_scale, float h_offset, int head_dim, int rotary_dim,
                            int wbits, int ks, int cps, void* stream) {
  Affine aff;
  aff.scale = (const float*)scale;
  aff.offset = (const float*)offset;
  aff.colsum = (const float*)colsum;
  aff.bias = (const float*)bias;
  aff.sstride = sstride;
  aff.xs = h_scale;
  aff.ox = h_offset - 128.0f;
  aff.kox = (float)K * aff.ox;
  QkvArgs qa{(const float*)ofq, (const float*)outq, (const float*)cs, head_dim,
             rotary_dim / 2};
  const int nchunks = ((K >> 1) + TC_KP - 1) / TC_KP;
  const bool paired = head_dim == 256;
  if ((wbits != 4 && wbits != 8) || N % TC_BN
      || !(128 % head_dim == 0 || (paired && rotary_dim == 256 && N % 256 == 0))
      || ks < 1 || ks > TC_MAX_KS || cps < 1 || (ks - 1) * cps >= nchunks
      || ks * cps < nchunks || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / TC_BN, (M + TC_BM - 1) / TC_BM, ks);
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* op = (int8_t*)out;
  if (wbits == 8)
    return paired ? launch_qkv<8, true>(grid, xp, wp, aff, qa, op, M, K, N, cps, st)
                  : launch_qkv<8, false>(grid, xp, wp, aff, qa, op, M, K, N, cps, st);
  return paired ? launch_qkv<4, true>(grid, xp, wp, aff, qa, op, M, K, N, cps, st)
                : launch_qkv<4, false>(grid, xp, wp, aff, qa, op, M, K, N, cps, st);
}
