// The C entries of the row kernels (fused_rows.cuh) and the W4 editions of
// the MLP-block, o-tail and chunk kernels; the others are instantiated in
// fused_rows_w8.cu, fused_otail_w8.cu, fused_mlp_tiles.cu and
// fused_rows_ln.cu.
#include "fused_rows.cuh"

// The MLP kernels over a.M >= 1 rows of layer a.l0, in 128-row tiles (mode:
// MLP_BLOCK, with LayerNorm when a.ln is set, MLP_RAW or MLP_W2; see
// fused_mlp_tiles_kernel), W4 or W8.
MQT_EXPORT int mqt_fused_mlp_tiles(const void* args, int mode, void* stream) {
  const Args& a = *(const Args*)args;
  if (!tiles_ok(a, mode)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode != MLP_BLOCK) return mqt_rows_mlp_raw_w2(a, mode, st);
  if (a.ln) return mqt_rows_mlp_ln(a, st);
  if (a.w13.bits == 8) return mqt_rows_w8_mlp(a, st);
  return launch_mlp_tiles<4, MLP_BLOCK>(a, st);
}

// o-proj of a.a8 (a.M <= 128 rows) + resid_add_1 with a.x_in + the MLP block,
// layer a.l0 (mlp_meta[0..45]); the four packs W4, or all W8.
MQT_EXPORT int mqt_fused_otail(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  const int wb = a.o.bits;
  if (!rows_ok(a) || a.o.kin % 64 || a.w13.bits != wb || a.w2.bits != wb)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wb == 8) return mqt_rows_w8_otail(a, st);
  if (wb == 4) return launch_otail<4>(a, st);
  return (int)cudaErrorInvalidValue;
}

// A whole staged decode step, layers [a.l0, a.l1) over a.M <= 128 sequences,
// with the head when a.logits is set; the four packs share one bit width (4
// or 8), the head has its own (a.hbits). The attention stage's editions: 4
// head dims a lane up to hd 128 (the TinyLlama / StableLM kernels as they
// were), 8 at hd 256 (Gemma-2B; fused_rows_hd256.cu, fused_rows_hd256_w8.cu);
// no other head_dim.
MQT_EXPORT int mqt_fused_chunk(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  const int wb = a.qkv.bits;
  if (!rows_ok(a) || a.hd % 32 || (a.hd > 128 && a.hd != 256) || a.mst < 0 || a.mst > a.ncs
      || (a.Hq * a.hd) % 64 || a.qkv.n % 16 || a.Hkv < 1 || a.Hq % a.Hkv
      || a.o.bits != wb || a.w13.bits != wb || a.w2.bits != wb
      || (a.logits && ((a.hbits != 4 && a.hbits != 8) || a.Vp % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wb == 8) return a.hd == 256 ? mqt_rows_w8_chunk_hd256(a, st) : mqt_rows_w8_chunk(a, st);
  if (wb == 4) return a.hd == 256 ? mqt_rows_chunk_hd256(a, st) : launch_chunk<4>(a, st);
  return (int)cudaErrorInvalidValue;
}
