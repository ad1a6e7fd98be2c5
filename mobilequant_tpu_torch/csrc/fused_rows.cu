// The C entries of the row kernels (fused_rows.cuh) and their W4 editions;
// the W8 editions are instantiated in fused_rows_w8.cu.
#include "fused_rows.cuh"

// The whole MLP block over 1 <= a.M <= 128 rows of layer a.l0 (mlp_meta[0..31]),
// W4 or W8 packs.
MQT_EXPORT int mqt_fused_mlp_rows(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  if (!rows_ok(a) || a.w2.bits != a.w13.bits) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.w13.bits == 8) return mqt_rows_w8_mlp(a, st);
  if (a.w13.bits == 4) return launch_mlp_rows<4>(a, st);
  return (int)cudaErrorInvalidValue;
}

// o-proj of a.a8 (a.M <= 128 rows) + resid_add_1 with a.x_in + the MLP block,
// layer a.l0 (mlp_meta[0..45]); W4 packs.
MQT_EXPORT int mqt_fused_otail(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  if (!rows_ok(a) || a.o.kin % 64 || a.o.bits != 4 || a.w13.bits != 4 || a.w2.bits != 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t sm = sizeof(RowSmem);
  switch (mi_of(a.M)) {
    case 1: return launch_coop(fused_otail_kernel<1>, a, 0, sm, st);
    case 2: return launch_coop(fused_otail_kernel<2>, a, 0, sm, st);
    case 4: return launch_coop(fused_otail_kernel<4>, a, 0, sm, st);
    default: return launch_coop(fused_otail_kernel<8>, a, 0, sm, st);
  }
}

// A whole staged decode step, layers [a.l0, a.l1) over a.M <= 128 sequences,
// with the head when a.logits is set; the four packs share one bit width (4
// or 8), the head has its own (a.hbits).
MQT_EXPORT int mqt_fused_chunk(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  const int wb = a.qkv.bits;
  if (!rows_ok(a) || a.hd % 32 || a.hd > 128 || a.mst < 0 || a.mst > a.ncs
      || (a.Hq * a.hd) % 64 || a.qkv.n % 4 || a.Hkv < 1 || a.Hq % a.Hkv
      || a.o.bits != wb || a.w13.bits != wb || a.w2.bits != wb
      || (a.logits && a.hbits != 4 && a.hbits != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (wb == 8) return mqt_rows_w8_chunk(a, st);
  if (wb == 4) return launch_chunk<4>(a, st);
  return (int)cudaErrorInvalidValue;
}
