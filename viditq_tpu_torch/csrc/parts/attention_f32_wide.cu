// The float32 attention at head dims 192 and 256: the float32 core's
// launch (attn_f32_core.cuh `launch_core_wide`) and attention_f32.cu's
// seg kernel instantiated for these dims alone, in a translation unit of
// their own so that the build compiles them in parallel
// (attention_f32.cu, "Build").
#define VQ_F32_WIDE_PART 1
#include "attention_f32.cu"
