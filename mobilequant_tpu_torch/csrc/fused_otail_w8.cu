// The W8 edition of the o-tail row kernel (fused_rows.cuh), in a translation
// unit of its own so that the build compiles it beside fused_rows.cu and
// fused_rows_w8.cu. The entry in fused_rows.cu checks the arguments.
#include "fused_rows.cuh"

int mqt_rows_w8_otail(const MqtFusedArgs& a, cudaStream_t st) { return launch_otail<8>(a, st); }
