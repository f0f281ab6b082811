// K1: fused non-affine LayerNorm + t2i modulate + symmetric per-row int8
// quantize.
//
// Replaces the TPU kernel `ln_modulate_quantize` / `_ln_mod_quant_kernel`
// (viditq_tpu/kernels/fused_matmul.py:656-719). Per row of x [B*N, C]:
//   mean = sum(x)/C; var = sum((x-mean)^2)/C; y = (x-mean) * 1/sqrt(var+eps)
//   y = y * (1 + scale[b]) + shift[b]
//   s = max(absmax(y)/127, 1e-6); codes = clip(round(y * (1/s)), -128, 127)
//
// Bound on the card: memory. It reads C bf16 values and writes C int8 codes
// plus one float per row (3 bytes/element); the arithmetic is a few flops
// per element. Design: one warp per row, lanes strided over the channels so
// every load is coalesced; the row is re-read from L1/L2 for each of the
// four passes (mean, var, absmax, quantize) instead of staging it in
// shared memory, which keeps the kernel simple and still reads device
// memory once.
#include "common.cuh"

namespace {

template <typename T>
__global__ void ln_mod_quant_kernel(const T* __restrict__ x,
                                    const T* __restrict__ shift,
                                    const T* __restrict__ scale,
                                    int8_t* __restrict__ q,
                                    float* __restrict__ qs, int rows,
                                    int rows_per_batch, int C, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / rows_per_batch;
  const T* xr = x + static_cast<size_t>(row) * C;
  const T* sh = shift + static_cast<size_t>(b) * C;
  const T* sc = scale + static_cast<size_t>(b) * C;

  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += vq::to_f32(xr[c]);
  const float mean = vq::warp_sum(s) / static_cast<float>(C);
  float v = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = vq::to_f32(xr[c]) - mean;
    v += d * d;
  }
  const float var = vq::warp_sum(v) / static_cast<float>(C);
  const float inv_std = 1.0f / sqrtf(var + eps);

  float am = 0.0f;
  for (int c = lane; c < C; c += 32) {
    float y = (vq::to_f32(xr[c]) - mean) * inv_std;
    y = y * (1.0f + vq::to_f32(sc[c])) + vq::to_f32(sh[c]);
    am = fmaxf(am, fabsf(y));
  }
  am = vq::warp_max(am);
  const float s_row = fmaxf(am / 127.0f, 1e-6f);
  const float inv = 1.0f / s_row;
  int8_t* qr = q + static_cast<size_t>(row) * C;
  for (int c = lane; c < C; c += 32) {
    float y = (vq::to_f32(xr[c]) - mean) * inv_std;
    y = y * (1.0f + vq::to_f32(sc[c])) + vq::to_f32(sh[c]);
    qr[c] = vq::round_sat_s8(y * inv);
  }
  if (lane == 0) qs[row] = s_row;
}

}  // namespace

// x [B, N, C], shift/scale [B, 1, C] (bf16 when is_bf16, else float32);
// q [B*N, C] int8, qs [B*N] float32.
VQ_EXPORT int vq_ln_mod_quant(const void* x, const void* shift,
                              const void* scale, void* q, void* qs, int B,
                              int N, int C, float eps, int is_bf16,
                              void* stream) {
  const int rows = B * N;
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    ln_mod_quant_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(shift),
        static_cast<const __nv_bfloat16*>(scale), static_cast<int8_t*>(q),
        static_cast<float*>(qs), rows, N, C, eps);
  } else {
    ln_mod_quant_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(shift),
        static_cast<const float*>(scale), static_cast<int8_t*>(q),
        static_cast<float*>(qs), rows, N, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
