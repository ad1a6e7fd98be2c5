// Shared pieces of the port's Hopper kernels: the C export macro, the byte
// transpose and split choice of rows 1 / 2's decode gemv (w4a8_matmul.cu,
// M <= 8), the tile column map, the fake-quant and warp helpers of the fused
// kernels, the cp.async / ldmatrix / mma.sync wrappers of the tensor-core
// kernels (prefill_attention.cu, wonly_matmul.cu and the int8 tile core,
// tc_tile.cuh) and the affine epilogue of the int8 matmuls.
//
// Weight layouts. W4 (unsigned block nibbles, as the JAX package packs it): a
// (K/2, N) int8 matrix, N contiguous; packed row j holds k = j in its low
// nibble and k = j + K/2 in its high nibble, both 0..15. W8 (the JAX
// package's shifted int8, uint8 − 128 for asymmetric packs): a (K, N) int8
// matrix, N contiguous. The kernels read a W8 matrix as the same two halves:
// "low" row j is row j, "high" row j is row j + K/2, so both editions share
// the chunking and the activation words, and differ only in where the high
// half's bytes come from and in the nibble masks. Activations are shifted
// int8 (uint8 − 128). Integer accumulation is exact in int32, so the split-K
// partial sums may be added in any order.
//
// Build without --use_fast_math and with --fmad=false: the epilogues repeat
// the JAX package's fp32 arithmetic op for op (true division, rintf for
// round-half-even, no fused multiply-add), so that the int8 rows they write
// (KV-cache rows, w2 inputs) match the plain versions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MQT_EXPORT extern "C" __attribute__((visibility("default")))

namespace mqt {

constexpr unsigned NIB = 0x0F0F0F0Fu;

// r[i] holds the 4 column bytes of packed row i; c[j] gets the 4 row bytes of
// column j (byte i = row i), i.e. 4 consecutive k values ready for __dp4a.
__device__ __forceinline__ void transpose4x4(const int r[4], int c[4]) {
  int t0 = __byte_perm(r[0], r[1], 0x5140);
  int t1 = __byte_perm(r[2], r[3], 0x5140);
  int t2 = __byte_perm(r[0], r[1], 0x7362);
  int t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

__device__ __forceinline__ int ld_i32(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

// Asymmetric fake-quant in the JAX package's fp32 order: true division,
// round half to even, clip to [0, qmax].
__device__ __forceinline__ float fq16(float x, float s, float o, float qmax) {
  float q = rintf(x / s) + o;
  q = fminf(fmaxf(q, 0.0f), qmax);
  return (q - o) * s;
}

// fp64 lane sums of a warp, rounded once to fp32 (every lane gets the same)
__device__ __forceinline__ float warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return (float)v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Column map of a tile: local columns [0, split) are global colA + n, local
// columns [split, tile width) are global colB + (n - split); na / nb are the
// counts of valid local columns in each part.
struct ColMap {
  int colA, colB, split, na, nb;
  __device__ __forceinline__ int gcol(int n) const {
    return n < split ? colA + n : colB + (n - split);
  }
  __device__ __forceinline__ bool valid(int n) const {
    return n < split ? n < na : (n - split) < nb;
  }
};

// Host side: the split count that gives the grid about two blocks per SM,
// with at least `min_chunks` chunks per split. Returns (ks, chunks per split).
inline void pick_split(int tiles, int nchunks, int min_chunks, int& ks, int& cps) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  int want = (2 * sms + tiles - 1) / tiles;
  int cap = nchunks / min_chunks;
  if (cap < 1) cap = 1;
  ks = want < cap ? want : cap;
  if (ks < 1) ks = 1;
  cps = (nchunks + ks - 1) / ks;
  ks = (nchunks + cps - 1) / cps;
}

// ---- tensor-core and async-copy building blocks (prefill_attention.cu,
// wonly_matmul.cu). Fragments are those of the PTX ISA: lane (g = lane / 4,
// t = lane % 4).

// 16 bytes global -> shared, bypassing L1; pred false fills them with zeros
// (src is then not read, but must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i; r[i] gets row g, bytes 4t..4t+3 of matrix i
__device__ __forceinline__ void ldsm_x4(int (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// D (16 x 8 s32) += A (16 x 32 s8, row) · B (32 x 8 s8, col): a0/a1 rows g /
// g + 8 at k 4t.., a2/a3 at k 16 + 4t..; b0 column g at k 4t.., b1 at 16 + 4t..;
// d0, d1 row g columns 2t, 2t + 1; d2, d3 row g + 8
__device__ __forceinline__ void mma_s8(int (&d)[4], int a0, int a1, int a2, int a3, int b0,
                                         int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// D (16 x 8 f32) += A (16 x 16, row) · B (16 x 8, col) in fp16 / bf16 with fp32
// accumulation: a0/a1 rows g / g + 8 at k 2t, 2t + 1 (low half = lower k),
// a2/a3 at k 2t + 8, 2t + 9; b0 column g at k 2t, 2t + 1, b1 at 2t + 8, 2t + 9
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
               "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fp32 affine bracket of the JAX W4A8 kernels, in their order:
//   (acc − o'_x·colsum − o_w·rowsum + K·o'_x·o_w) · (s_x·s_w) + bias
struct Affine {
  const float* scale;   // per column (stride sstride: 1, or 0 = per tensor)
  const float* offset;
  const float* colsum;  // per column
  const float* bias;    // per column, or null
  int sstride;
  float xs, ox, kox;    // x scale, shifted x offset, K·o'_x
  __device__ __forceinline__ float operator()(int acc, int col, float rowsum) const {
    const float ow = offset[col * sstride];
    const float sw = scale[col * sstride];
    float y = (float)acc - ox * colsum[col] - ow * rowsum + kox * ow;
    y = y * (xs * sw);
    if (bias) y = y + bias[col];
    return y;
  }
};

}  // namespace mqt
