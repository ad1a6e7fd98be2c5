// The W8 editions of the MLP-block and chunk row kernels (fused_rows.cuh), in a
// translation unit of their own so that the build compiles them beside the
// W4 editions of fused_rows.cu. The entries there check the arguments.
#include "fused_rows.cuh"

int mqt_rows_w8_mlp(const MqtFusedArgs& a, cudaStream_t st) {
  return launch_mlp_tiles<8, MLP_BLOCK>(a, st);
}

int mqt_rows_w8_chunk(const MqtFusedArgs& a, cudaStream_t st) { return launch_chunk<8>(a, st); }
