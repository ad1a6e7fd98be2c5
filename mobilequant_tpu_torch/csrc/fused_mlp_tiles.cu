// The raw-sum (MLP_RAW: fused_mlp) and w2-epilogue (MLP_W2: w13_gate_w2)
// editions of the MLP tiles kernel (fused_rows.cuh), W4 and W8, in a
// translation unit of their own so that the build compiles them beside the
// other row kernels. The entry in fused_rows.cu checks the arguments.
#include "fused_rows.cuh"

int mqt_rows_mlp_raw_w2(const MqtFusedArgs& a, int mode, cudaStream_t st) {
  const bool raw = mode == MLP_RAW;
  if (a.w13.bits == 8)
    return raw ? launch_mlp_tiles<8, MLP_RAW>(a, st) : launch_mlp_tiles<8, MLP_W2>(a, st);
  return raw ? launch_mlp_tiles<4, MLP_RAW>(a, st) : launch_mlp_tiles<4, MLP_W2>(a, st);
}
