// K6's kernels at head dims 192 and 256: attention_stream.cu's launchers
// instantiated for these dims alone, in a translation unit of their own so
// that the build compiles them in parallel (attention_stream.cu, "Build").
#define VQ_K6_PART 1
#include "attention_stream.cu"
