// The C entries of the whole-decode-step, whole-layer and whole-MLP-block
// kernels (fused_layer.cuh), and the editions up to head_dim 128 (4 dims a
// lane in the attention stage); the head-dim-256 editions are instantiated in
// fused_layer_hd256.cu.
#include "fused_layer.cuh"

// The whole-model (layers [l0, l1) with the head when a.logits is set) and
// whole-layer kernels: B = a.M <= 8 sequences; the four packs share one bit
// width (4 or 8), the head has its own (a.hbits).
MQT_EXPORT int mqt_fused_decode(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  cudaStream_t st = (cudaStream_t)stream;
  const int kmax = kmax_of(a);
  const int wb = a.qkv.bits;
  if ((wb != 4 && wb != 8) || a.o.bits != wb || a.w13.bits != wb || a.w2.bits != wb
      || (a.logits && a.hbits != 4 && a.hbits != 8) || a.hd % 32 || a.hd > 256
      || a.qkv.n % RW || a.K % RW || a.F % RW || (a.logits && a.Vp % RW))
    return (int)cudaErrorInvalidValue;
  // the attention stage's edition: 4 head dims a lane up to hd 128 (the
  // TinyLlama / StableLM kernels as they were), 8 up to 256 (Gemma-2B)
  if (a.hd > 128) return mqt_layer_decode_hd256(a, kmax, st);
  return wb == 8 ? launch_decode<8, 4>(a, kmax, st) : launch_decode<4, 4>(a, kmax, st);
}

// The whole MLP block over a.M <= 8 rows of layer a.l0.
MQT_EXPORT int mqt_fused_mlp_block(const void* args, void* stream) {
  const Args& a = *(const Args*)args;
  cudaStream_t st = (cudaStream_t)stream;
  int kmax = (a.K > a.F ? a.K : a.F);
  kmax = (kmax + 15) / 16 * 16;
  const int wb = a.w13.bits;
  if (a.w2.bits != wb) return (int)cudaErrorInvalidValue;
  if (wb == 8) return launch_mlp_block<8>(a, kmax, st);
  if (wb == 4) return launch_mlp_block<4>(a, kmax, st);
  return (int)cudaErrorInvalidValue;
}
