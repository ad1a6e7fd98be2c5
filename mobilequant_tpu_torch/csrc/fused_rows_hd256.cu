// The head-dim-256 editions (Gemma-2B: 8 dims a lane in the attention stage)
// of the chunk kernel (fused_rows.cuh): W4 here, W8 in fused_rows_hd256_w8.cu,
// in translation units of their own so that the build compiles them beside
// the hd <= 128 editions of fused_rows.cu and fused_rows_w8.cu. The entry
// there (mqt_fused_chunk) checks the arguments.
#include "fused_rows.cuh"

int mqt_rows_chunk_hd256(const MqtFusedArgs& a, cudaStream_t st) {
  return launch_chunk<4, 8>(a, st);
}
