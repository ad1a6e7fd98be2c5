// The W8 editions of the row kernels (fused_rows.cuh): the MLP block above
// ops/mlp_block.DP4A_ROWS rows and the chunk kernel over W8 packs, in a
// translation unit of their own so that the build compiles them beside the
// W4 editions of fused_rows.cu. The entries there check the arguments.
#include "fused_rows.cuh"

int mqt_rows_w8_mlp(const MqtFusedArgs& a, cudaStream_t st) { return launch_mlp_rows<8>(a, st); }

int mqt_rows_w8_chunk(const MqtFusedArgs& a, cudaStream_t st) { return launch_chunk<8>(a, st); }
