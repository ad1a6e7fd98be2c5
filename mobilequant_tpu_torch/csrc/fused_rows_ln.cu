// The LayerNorm editions of the MLP tiles kernel's MLP_BLOCK kind (W4 and W8;
// fused_rows.cuh, fused_mlp_tiles_kernel with NORM_LN), in a translation unit
// of their own so that the build compiles them beside the other row kernels.
// The entry in fused_rows.cu checks the arguments.
#include "fused_rows.cuh"

int mqt_rows_mlp_ln(const MqtFusedArgs& a, cudaStream_t st) {
  return a.w13.bits == 8 ? launch_mlp_tiles<8, MLP_BLOCK, NORM_LN>(a, st)
                         : launch_mlp_tiles<4, MLP_BLOCK, NORM_LN>(a, st);
}
