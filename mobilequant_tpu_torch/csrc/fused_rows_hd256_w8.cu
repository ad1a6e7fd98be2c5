// The W8 head-dim-256 edition of the chunk kernel (fused_rows.cuh), in a
// translation unit of its own so that the build compiles it beside the W4 one
// of fused_rows_hd256.cu. The entry in fused_rows.cu checks the arguments.
#include "fused_rows.cuh"

int mqt_rows_w8_chunk_hd256(const MqtFusedArgs& a, cudaStream_t st) {
  return launch_chunk<8, 8>(a, st);
}
