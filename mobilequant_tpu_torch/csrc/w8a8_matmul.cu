// W8A8 matmul: shifted-int8 x (M, K) × W8 (K, N)
//   -> fp32 (M, N) = s_x·s_w·[acc − o'_x·colsum − o_w·rowsum + K·o'_x·o_w] + bias
//
// Replaces mobilequant_tpu/ops/pallas_matmul.py: w8a8_matmul (_w8a8_kernel),
// which takes any M. The JAX engine sends W8 projections of at most 32 rows
// here under its "all" kernel set; the wrapper's stacked form is a layer
// offset on the weight pointer, taken by the caller: no copy.
//
// W8 layout: the JAX package's shifted int8 (K, N), N contiguous (uint8 − 128
// with the zero-point shifted the same way for asymmetric packs); scale and
// offset per tensor (stride 0) or per column.
//
// Bound: device-memory bytes at decode rows (M <= 32: the K·N weight bytes
// dominate, 2·M·K·N int8 operations are far below the tensor cores' rate for
// them), integer operations at prefill M. Design, at every row count: the
// int8 tensor-core tile core (tc_tile.cuh's tc_matmul_kernel: mma.sync
// m16n8k32 on 64 x 128 tiles over a four-stage cp.async ring of 16 KB weight
// chunks, the products of rows past M skipped), split over K by the
// caller's plan (ops/w8a8_matmul.tile_plan) where the tiles leave SMs idle;
// the K splits of a tile are one thread-block cluster and meet in shared
// memory (tc_cluster_reduce): no workspace, no atomics. Weight rows whose
// width is not a multiple of 16 bytes take the 4-byte-copy edition.
#include "tc_tile.cuh"

// ks, cps: the K split, ks blocks (one cluster) of cps 64-row-pair chunks a
// column tile (ops/w8a8_matmul.tile_plan). K % 64 == 0, N % 4 == 0, M >= 1.
MQT_EXPORT int mqt_w8a8_matmul(const void* x, const void* w, const void* scale,
                               const void* offset, const void* colsum,
                               const void* bias, void* out, int M, int K, int N,
                               int sstride, float x_scale, float x_offset, int ks,
                               int cps, void* stream) {
  if (K % 64) return (int)cudaErrorInvalidValue;
  mqt::Affine aff;
  aff.scale = (const float*)scale;
  aff.offset = (const float*)offset;
  aff.colsum = (const float*)colsum;
  aff.bias = (const float*)bias;
  aff.sstride = sstride;
  aff.xs = x_scale;
  aff.ox = x_offset - 128.0f;
  aff.kox = (float)K * aff.ox;
  return mqt::tc_matmul<8, true>((const int8_t*)x, (const int8_t*)w, aff, (float*)out, M, K, N,
                                 ks, cps, (cudaStream_t)stream);
}
