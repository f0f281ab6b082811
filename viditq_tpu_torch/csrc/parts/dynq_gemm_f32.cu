// K5 on f32 x: dynq_gemm.cu's kernels instantiated for f32 input alone,
// in a translation unit of their own so that the build compiles them in
// parallel with the bf16 ones (dynq_gemm.cu, "Build").
#define VQ_K5_F32 1
#include "dynq_gemm.cu"
