// K4: symmetric per-row dynamic int8 quantize.
//
// Replaces the TPU kernel `quantize_rows_fused` / `_quant_rows_kernel`
// (viditq_tpu/kernels/fused_matmul.py:581-653) in its sym, no-gelu,
// no-column-scale mode. Per row of x [M, K]:
//   s = max(absmax(x)/127, 1e-6); codes = clip(round(x * (1/s)), -128, 127)
// (the `_quantize_rows_f32` form, fused_matmul.py:126-128).
//
// Bound on the card: memory (read 2 bytes, write 1 byte per element). One
// warp per row with lane-strided, coalesced loads; the second pass re-reads
// the row from cache.
#include "common.cuh"

namespace {

template <typename T>
__global__ void quant_rows_kernel(const T* __restrict__ x,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ qs, int M, int K) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * K;
  float am = 0.0f;
  for (int c = lane; c < K; c += 32) am = fmaxf(am, fabsf(vq::to_f32(xr[c])));
  am = vq::warp_max(am);
  const float s_row = fmaxf(am / 127.0f, 1e-6f);
  const float inv = 1.0f / s_row;
  int8_t* qr = q + static_cast<size_t>(row) * K;
  for (int c = lane; c < K; c += 32)
    qr[c] = vq::round_sat_s8(vq::to_f32(xr[c]) * inv);
  if (lane == 0) qs[row] = s_row;
}

}  // namespace

// x [M, K] (bf16 when is_bf16, else float32); q [M, K] int8; qs [M] float32.
VQ_EXPORT int vq_quant_rows(const void* x, void* q, void* qs, int M, int K,
                            int is_bf16, void* stream) {
  const int threads = 256;
  const int blocks = (M * 32 + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    quant_rows_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(qs), M, K);
  } else {
    quant_rows_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(qs), M, K);
  }
  return static_cast<int>(cudaGetLastError());
}
