// K1: fused non-affine LayerNorm + t2i modulate + per-row int8 quantize,
// symmetric or asymmetric.
//
// Replaces the TPU kernel `ln_modulate_quantize` / `_ln_mod_quant_kernel`
// (viditq_tpu/kernels/fused_matmul.py:656-719). Per row of x [B*N, C]:
//   mean = sum(x)/C; var = sum((x-mean)^2)/C; y = (x-mean) * 1/sqrt(var+eps)
//   y = y * (1 + scale[b]) + shift[b]
//   sym : s = max(absmax(y)/127, 1e-6); codes = clip(round(y * (1/s)))
//   asym: lo = min(y, 0), hi = max(y, 0); s = max((hi - lo)/255, 1e-6);
//         inv = 1/s; zp = round(-lo * inv) - 128;
//         codes = clip(round(y * inv) + zp, -128, 127)
//   rowsum = sum of the codes (asym, or when asked for: asym consumer
//   weights), an exact integer sum stored as f32
// (`_quantize_rows_f32`, fused_matmul.py:118-137; every division a true
// IEEE division). The row's min, max and code sum are exact in any order;
// only the LN mean and variance sum in another order than the plain
// version.
//
// Bound on the card: memory. It reads C bf16 values and writes C int8 codes
// plus up to three floats per row (3 bytes/element); the arithmetic is a
// few flops per element. Design: one warp per row, lanes strided over the
// channels so every load is coalesced; the row is re-read from L1/L2 for
// each of the four passes (mean, var, range, quantize) instead of staging
// it in shared memory, which keeps the kernel simple and still reads device
// memory once.
#include "common.cuh"

namespace {

template <typename T, bool SYM>
__global__ void ln_mod_quant_kernel(const T* __restrict__ x,
                                    const T* __restrict__ shift,
                                    const T* __restrict__ scale,
                                    int8_t* __restrict__ q,
                                    float* __restrict__ qs,
                                    float* __restrict__ zp,
                                    float* __restrict__ rowsum, int rows,
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
  const auto y_at = [&](int c) {
    const float y = (vq::to_f32(xr[c]) - mean) * inv_std;
    return y * (1.0f + vq::to_f32(sc[c])) + vq::to_f32(sh[c]);
  };

  float lo = 0.0f, hi = 0.0f;  // sym: hi = absmax
  for (int c = lane; c < C; c += 32) {
    const float y = y_at(c);
    if constexpr (SYM) {
      hi = fmaxf(hi, fabsf(y));
    } else {
      lo = fminf(lo, y);
      hi = fmaxf(hi, y);
    }
  }
  const vq::RowQuant rq = SYM ? vq::RowQuant::sym(vq::warp_max(hi))
                              : vq::RowQuant::asym(vq::warp_min(lo),
                                                   vq::warp_max(hi));
  int8_t* qr = q + static_cast<size_t>(row) * C;
  int sum = 0;
  for (int c = lane; c < C; c += 32) {
    const int8_t code = rq.code<SYM>(y_at(c));
    sum += code;
    qr[c] = code;
  }
  rq.store<SYM>(row, lane, sum, qs, zp, rowsum);
}

template <typename T>
void launch(const void* x, const void* shift, const void* scale, void* q,
            void* qs, void* zp, void* rowsum, int B, int N, int C, float eps,
            cudaStream_t st) {
  const int rows = B * N;
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  const T* xt = static_cast<const T*>(x);
  const T* sh = static_cast<const T*>(shift);
  const T* sc = static_cast<const T*>(scale);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(qs);
  float* z = static_cast<float*>(zp);
  float* r = static_cast<float*>(rowsum);
  if (z == nullptr)
    ln_mod_quant_kernel<T, true><<<blocks, threads, 0, st>>>(
        xt, sh, sc, qt, s, z, r, rows, N, C, eps);
  else
    ln_mod_quant_kernel<T, false><<<blocks, threads, 0, st>>>(
        xt, sh, sc, qt, s, z, r, rows, N, C, eps);
}

}  // namespace

// x [B, N, C], shift/scale [B, 1, C] (bf16 when is_bf16, else float32);
// q [B*N, C] int8, qs [B*N] float32. zp [B*N] f32 selects the asymmetric
// quantizer (null: symmetric); rowsum [B*N] f32 or null (not written).
VQ_EXPORT int vq_ln_mod_quant(const void* x, const void* shift,
                              const void* scale, void* q, void* qs, void* zp,
                              void* rowsum, int B, int N, int C, float eps,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, shift, scale, q, qs, zp, rowsum, B, N, C, eps,
                          st);
  else
    launch<float>(x, shift, scale, q, qs, zp, rowsum, B, N, C, eps, st);
  return static_cast<int>(cudaGetLastError());
}
