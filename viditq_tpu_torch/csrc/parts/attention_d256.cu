// K3's kernels at head dim 256: attention.cu's launchers instantiated for
// this dim alone, in a translation unit of their own so that the build
// compiles the head dims in parallel (attention.cu, "Build").
#define VQ_K3_PART 256
#include "attention.cu"
