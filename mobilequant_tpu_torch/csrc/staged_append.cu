// Staged-column append of the chunked-staging decode loop.
//
// Replaces mobilequant_tpu/ops/pallas_scatter.py staged_append
// (_append_kernel): the step's pending K/V rows (L, B, Hkv, 1, hd) land in
// column m of the staging buffers sk / sv (L, B, Hkv, cs, hd), in place.
//
// The Pallas kernel blends an 8-column window (Mosaic's aligned-sublane rule)
// to make XLA update the buffers in place; here they are device buffers
// updated in place by construction, and any column is addressable, so one
// launch copies exactly the rows: one thread per 16 bytes, the K rows in the
// first half of the grid and the V rows in the second. Bound: the
// 2·L·B·Hkv·hd bytes read and written, a fraction of a microsecond of the
// memory rate; the launch's fixed cost dominates.
#include "mqt_common.cuh"

namespace {

__global__ void staged_append_kernel(int8_t* __restrict__ sk, int8_t* __restrict__ sv,
                                     const int8_t* __restrict__ pk,
                                     const int8_t* __restrict__ pv, int groups, int hkv,
                                     int cs, int hd, long long gstride, int m) {
  const int per_row = hd >> 4;                         // 16-byte pieces of a row
  const long long n = (long long)groups * hkv * per_row;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n) return;
  const bool is_v = i >= n;
  const long long j = is_v ? i - n : i;
  const int piece = (int)(j % per_row);
  const long long row = j / per_row;                   // (layer, sequence, head)
  const int h = (int)(row % hkv);
  const long long g = row / hkv;                       // (layer, sequence)
  const int8_t* src = (is_v ? pv : pk) + g * gstride + (long long)h * hd + 16 * piece;
  int8_t* dst = (is_v ? sv : sk) + ((row * cs) + m) * (long long)hd + 16 * piece;
  *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(src));
}

}  // namespace

// groups = L·B; gstride = elements between consecutive (layer, sequence) row
// groups of pk / pv (Hkv·hd when contiguous). hd % 16 == 0, 0 <= m < cs.
MQT_EXPORT int mqt_staged_append(void* sk, void* sv, const void* pk, const void* pv,
                                 int groups, int hkv, int cs, int hd, long long gstride,
                                 int m, void* stream) {
  if (hd % 16 || m < 0 || m >= cs) return (int)cudaErrorInvalidValue;
  const long long n = 2LL * groups * hkv * (hd >> 4);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  staged_append_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (int8_t*)sk, (int8_t*)sv, (const int8_t*)pk, (const int8_t*)pv, groups, hkv, cs, hd,
      gstride, m);
  return (int)cudaGetLastError();
}
