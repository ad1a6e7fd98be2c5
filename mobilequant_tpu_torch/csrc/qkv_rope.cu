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
// a few dozen fp32 operations per output). Design: the shared W4A8 / W8A8
// tile core (mqt_common.cuh, templated on the weight bits) with split-K so that a 128-row prompt still fills the
// card; the epilogue stages the 64 x 128 tile in shared memory so that each
// output can read its RoPE partner column, which is why a tile must hold
// whole heads (128 % head_dim == 0). At head_dim 256 with full rotary (Gemma:
// the partner is 128 columns away) a tile is two 64-column runs of one head,
// [64 p, 64 p + 64) and [128 + 64 p, 192 + 64 p) (p = 0, 1), so every column
// and its partner still meet in the tile (the PAIRED edition; the tile core's
// column map reads the two runs). The written rows are the int8 KV cache:
// rintf (half to even), true division and no fused multiply-add keep them
// equal to the plain version's.
#include "mqt_common.cuh"

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
__global__ void __launch_bounds__(TTHREADS)
qkv_rope_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                Affine aff, QkvArgs qa, int8_t* __restrict__ out, int* ws,
                int M, int K, int N, int ks, int cps) {
  __shared__ TileSmem sm;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ntn = gridDim.x;
  const int tile = blockIdx.y * ntn + blockIdx.x;
  const int ntiles = ntn * gridDim.y;
  const int n0 = blockIdx.x * TBN, m0 = blockIdx.y * TBM;
  const int nchunks = (K >> 1) / TBKP;
  const int c0 = blockIdx.z * cps, c1 = min(nchunks, c0 + cps);
  constexpr int RUN = TBN / 2;     // PAIRED: columns of a run
  const int pa = (blockIdx.x >> 1) * 2 * TBN + (blockIdx.x & 1) * RUN;
  // N % 128 == 0 (checked by the caller); PAIRED: N % 256 == 0
  const ColMap cm = PAIRED ? ColMap{pa, pa + TBN, RUN, RUN, RUN} : ColMap{n0, 0, TBN, TBN, 0};
  int acc[4][8] = {};
  int rs = 0;
  tile_mma<WB>(x, w, M, K, N, m0, cm, c0, c1, sm, acc, rs);
  if (!splitk_reduce(ws, ntiles, tile, ks, M, N, m0, cm, sm, acc, rs)) return;

  // affine bracket + output fake-quant, staged in shared memory
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nl = tx + 16 * j, col = cm.gcol(nl);
      float y = aff(acc[i][j], col, (float)sm.rsum[m]);
      const float fs = qa.ofq[col], fo = qa.ofq[N + col];
      const float fc = qa.ofq[2 * N + col], fe = qa.ofq[3 * N + col];
      float q = rintf(y / fs) + fo;
      q = fminf(fmaxf(q, 0.0f), fc);
      if (fe > 0.5f) y = (q - fo) * fs;
      sm.u.y[m][nl] = y;
    }
  }
  __syncthreads();

  // RoPE + segment quantization, one output byte per (row, column)
  for (int idx = tid; idx < TBM * TBN; idx += TTHREADS) {
    const int m = idx / TBN, nl = idx % TBN, gm = m0 + m;
    if (gm >= M) continue;
    const int col = cm.gcol(nl);
    // the head dim, and the partner's local column (PAIRED: the other run)
    const int d = PAIRED ? col % qa.hd : nl % qa.hd;
    float y = sm.u.y[m][nl];
    if (qa.outq[2 * N + col] > 0.5f) {
      const int pl = PAIRED ? (nl < RUN ? nl + RUN : nl - RUN)
                            : (d < qa.shift ? nl + qa.shift : nl - qa.shift);
      const float partner = sm.u.y[m][pl];
      const float cv = qa.cs[(size_t)gm * 2 * qa.hd + d];
      const float sv = qa.cs[(size_t)gm * 2 * qa.hd + qa.hd + d];
      y = y * cv + partner * sv;
    }
    const float s = qa.outq[col], o = qa.outq[N + col];
    float q = rintf(y / s) + o;
    q = fminf(fmaxf(q, 0.0f), 255.0f) - 128.0f;
    out[(size_t)gm * N + col] = (int8_t)(int)q;
  }
}

}  // namespace

MQT_EXPORT int mqt_qkv_rope(const void* x, const void* w, const void* scale,
                            const void* offset, const void* colsum,
                            const void* bias, const void* ofq, const void* outq,
                            const void* cs, void* out, void* ws, int M, int K,
                            int N, int sstride, float h_scale, float h_offset,
                            int head_dim, int rotary_dim, int wbits, void* stream) {
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
  const int tn = N / TBN, tm = (M + TBM - 1) / TBM;
  const int nchunks = (K >> 1) / TBKP;
  int ks, cps;
  pick_split(tn * tm, nchunks, 4, ks, cps);
  dim3 grid(tn, tm, ks);
  const int8_t* xp = (const int8_t*)x;
  const int8_t* wp = (const int8_t*)w;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* op = (int8_t*)out;
  int* wsp = (int*)ws;
  const bool paired = head_dim == 256;
  if ((wbits != 4 && wbits != 8) || N % TBN
      || !(128 % head_dim == 0 || (paired && rotary_dim == 256 && N % 256 == 0)))
    return (int)cudaErrorInvalidValue;
  if (wbits == 8) {
    if (paired)
      qkv_rope_kernel<8, true><<<grid, TTHREADS, 0, st>>>(xp, wp, aff, qa, op, wsp, M, K, N, ks,
                                                          cps);
    else
      qkv_rope_kernel<8, false><<<grid, TTHREADS, 0, st>>>(xp, wp, aff, qa, op, wsp, M, K, N,
                                                           ks, cps);
  } else {
    if (paired)
      qkv_rope_kernel<4, true><<<grid, TTHREADS, 0, st>>>(xp, wp, aff, qa, op, wsp, M, K, N, ks,
                                                          cps);
    else
      qkv_rope_kernel<4, false><<<grid, TTHREADS, 0, st>>>(xp, wp, aff, qa, op, wsp, M, K, N,
                                                           ks, cps);
  }
  return (int)cudaGetLastError();
}
