// The head-dim-256 editions (Gemma-2B: 8 dims a lane in the attention stage)
// of the whole-model and whole-layer kernels (fused_layer.cuh), W4 and W8, in
// a translation unit of their own so that the build compiles them beside the
// other editions of fused_layer.cu. The entry there checks the arguments.
#include "fused_layer.cuh"

int mqt_layer_decode_hd256(const MqtFusedArgs& a, int kmax, cudaStream_t st) {
  return a.qkv.bits == 8 ? launch_decode<8, 8>(a, kmax, st) : launch_decode<4, 8>(a, kmax, st);
}
