// K4: per-row dynamic int8 quantize, symmetric or asymmetric, optionally
// after a tanh-GELU.
//
// Replaces the TPU kernel `quantize_rows_fused` / `_quant_rows_kernel`
// (viditq_tpu/kernels/fused_matmul.py:581-653) without its column-scale
// mode. Per row of x [M, K]:
//   y = gelu ? 0.5*x*(1 + tanh(sqrt(2/pi)*(x + 0.044715*((x*x)*x)))) : x
//   then the row quantizer of `_quantize_rows_f32` (common.cuh RowQuant:
//   sym, or asym with its zero point), and the code row sum where asked
//   for (asym codes, or sym codes feeding asym weights).
// The GELU is computed in f32 from the input's value, in the plain
// version's operation order (-fmad=false keeps each product rounded).
//
// Bound on the card: memory (read 2 bytes, write 1 byte per element, a few
// floats per row). One warp per row with lane-strided, coalesced loads; the
// second pass re-reads the row from cache and, with the GELU, computes it
// again (its tanh twice per element: the f32 pipe is far from bounding a
// memory-bound pass at the fc1 -> fc2 shape, [32768, 4608]).
#include "common.cuh"

namespace {

__device__ __forceinline__ float gelu_tanh(float o) {
  const float o3 = o * o * o;
  return 0.5f * o * (1.0f + tanhf(0.7978845608028654f * (o + 0.044715f * o3)));
}

template <typename T, bool SYM, bool GELU>
__global__ void quant_rows_kernel(const T* __restrict__ x,
                                  int8_t* __restrict__ q,
                                  float* __restrict__ qs,
                                  float* __restrict__ zp,
                                  float* __restrict__ rowsum, int M, int K) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * K;
  const auto y_at = [&](int c) {
    const float v = vq::to_f32(xr[c]);
    return GELU ? gelu_tanh(v) : v;
  };
  float lo = 0.0f, hi = 0.0f;  // sym: hi = absmax
  for (int c = lane; c < K; c += 32) {
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
  int8_t* qr = q + static_cast<size_t>(row) * K;
  int sum = 0;
  for (int c = lane; c < K; c += 32) {
    const int8_t code = rq.code<SYM>(y_at(c));
    sum += code;
    qr[c] = code;
  }
  rq.store<SYM>(row, lane, sum, qs, zp, rowsum);
}

template <typename T, bool SYM>
void launch_mode(const void* x, int8_t* q, float* qs, float* zp, float* rowsum,
            int M, int K, int gelu, cudaStream_t st) {
  const int threads = 256;
  const int blocks = (M * 32 + threads - 1) / threads;
  const T* xt = static_cast<const T*>(x);
  if (gelu)
    quant_rows_kernel<T, SYM, true><<<blocks, threads, 0, st>>>(
        xt, q, qs, zp, rowsum, M, K);
  else
    quant_rows_kernel<T, SYM, false><<<blocks, threads, 0, st>>>(
        xt, q, qs, zp, rowsum, M, K);
}

template <typename T>
void launch(const void* x, void* q, void* qs, void* zp, void* rowsum, int M,
            int K, int gelu, cudaStream_t st) {
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(qs);
  float* z = static_cast<float*>(zp);
  float* r = static_cast<float*>(rowsum);
  if (z == nullptr)
    launch_mode<T, true>(x, qt, s, z, r, M, K, gelu, st);
  else
    launch_mode<T, false>(x, qt, s, z, r, M, K, gelu, st);
}

}  // namespace

// x [M, K] (bf16 when is_bf16, else float32); q [M, K] int8; qs [M]
// float32. zp [M] f32 selects the asymmetric quantizer (null: symmetric);
// rowsum [M] f32 or null (not written); gelu: tanh-GELU before the
// quantize.
VQ_EXPORT int vq_quant_rows(const void* x, void* q, void* qs, void* zp,
                            void* rowsum, int M, int K, int gelu, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, q, qs, zp, rowsum, M, K, gelu, st);
  else
    launch<float>(x, q, qs, zp, rowsum, M, K, gelu, st);
  return static_cast<int>(cudaGetLastError());
}
