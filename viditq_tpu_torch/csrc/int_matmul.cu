// K7a: dynamic per-row int8 quantize (sym or asym) with zero point and
// row sum; K7b: int8 x int8 -> int32 GEMM with the zero-point-corrected
// dequant epilogue. The native (unfused) int8 linear of the W8A8 plans.
//
// K7a replaces `dynamic_quant_rows` / `_dyn_quant_kernel`
// (viditq_tpu/kernels/int_matmul.py:49-108). Per row of x [M, K]:
//   asym: lo = min(x, 0), hi = max(x, 0), s = max((hi - lo) / 255, 1e-6),
//         zp = rint(-lo / s) - 128, q = clip(rint(x / s) + zp, -128, 127)
//   sym : s = max(absmax / 127, 1e-6), zp = 0, q = clip(rint(x / s))
//   rowsum = sum of q (an exact integer sum, stored as f32)
// Every division is a true IEEE division (the `round(x / s)` form of the
// JAX site, C6), never x * (1/s). Bound on the card: memory, 3*M*K + 12*M
// bytes for bf16 x. One block of 128 threads per row reads the row once
// with 16-byte loads and keeps it in registers (up to 8 vectors a thread,
// so rows up to 16 KB); min/max and the row sum reduce with shuffles and
// one shared-memory step, and the codes leave as 8- or 4-byte stores.
//
// K7b replaces `int8_matmul` / `_int8_matmul_kernel`
// (int_matmul.py:115-217). The product is the TMA + s8 wgmma core of
// int8_mma.cuh (K2's; the weight K-major); the epilogue is the JAX one, in
// f32 and in its order:
//   c = (float)acc - xzp[m]*wcs[n] - wzp[n]*xrs[m] + ((float)K*xzp[m])*wzp[n]
//   out = (c * xs[m]) * ws[n], rounded to the output type, then
//   out = round(out + round(bias[n])) (the caller's bias add, fused)
// with K the true K. There is no padding contract: TMA zero-fills rows past
// M, columns past N and a K tail; a K that is not a multiple of 16 (or an
// unaligned base) takes the core's byte-wise kernel, which zero-fills the
// same way. Zero codes add nothing to acc, and the corrections use the true
// K and the true row and column sums. Bound on the card: the int8 tensor
// cores, 2*M*N*K / 1979e12 s at the main path's shapes.
#include <type_traits>

#include "int8_mma.cuh"

namespace {

constexpr int DQ_THREADS = 128;
constexpr int DQ_VECS = 8;  // 16-byte vectors a thread holds

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// element e of a 16-byte vector of T, as float (exact)
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e);
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int e) {
  return __uint_as_float(((word(r, e >> 1) >> (16 * (e & 1))) & 0xffffu)
                         << 16);
}
template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int e) {
  return __uint_as_float(word(r, e));
}

template <typename T, bool SYM>
__global__ void __launch_bounds__(DQ_THREADS)
    dyn_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scale, float* __restrict__ zp,
                          float* __restrict__ rowsum, int K) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int WARPS = DQ_THREADS / 32;
  __shared__ float red_lo[WARPS];
  __shared__ float red_hi[WARPS];
  __shared__ int red_sum[WARPS];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nvec = K / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K);

  uint4 raw[DQ_VECS];
  float lo = 0.0f;  // asym: min(x, 0)
  float hi = 0.0f;  // asym: max(x, 0); sym: absmax
#pragma unroll
  for (int i = 0; i < DQ_VECS; ++i) {
    const int v = tid + i * DQ_THREADS;
    if (v < nvec) {
      raw[i] = xr[v];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = elem<T>(raw[i], e);
        if constexpr (SYM) {
          hi = fmaxf(hi, fabsf(f));
        } else {
          lo = fminf(lo, f);
          hi = fmaxf(hi, f);
        }
      }
    }
  }
  hi = vq::warp_max(hi);
  lo = vq::warp_min(lo);
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  __syncthreads();
  lo = red_lo[0];
  hi = red_hi[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    lo = fminf(lo, red_lo[w]);
    hi = fmaxf(hi, red_hi[w]);
  }
  float s, z;
  if constexpr (SYM) {
    s = fmaxf(hi / 127.0f, 1e-6f);
    z = 0.0f;
  } else {
    s = fmaxf((hi - lo) / 255.0f, 1e-6f);
    z = rintf(-lo / s) - 128.0f;
  }

  int sum = 0;
  int8_t* qr = q + static_cast<size_t>(row) * K;
#pragma unroll
  for (int i = 0; i < DQ_VECS; ++i) {
    const int v = tid + i * DQ_THREADS;
    if (v < nvec) {
      uint32_t packed[VEC / 4];
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j) packed[j] = 0u;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float c = rintf(elem<T>(raw[i], e) / s);
        if constexpr (!SYM) c = c + z;
        const int code = static_cast<int>(fminf(fmaxf(c, -128.0f), 127.0f));
        sum += code;
        packed[e >> 2] |= static_cast<uint32_t>(code & 0xff) << (8 * (e & 3));
      }
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint2*>(qr + v * 8) = make_uint2(packed[0], packed[1]);
      } else {
        *reinterpret_cast<uint32_t*>(qr + v * 4) = packed[0];
      }
    }
  }
  sum = vq::warp_sum_int(sum);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red_sum[w];
    scale[row] = s;
    zp[row] = z;
    rowsum[row] = static_cast<float>(total);
  }
}

// The epilogue of int8_mma.cuh's kernels: the core's ZpEpilogue (shared
// with K2's zero-point modes), the bias rounded to the output type first.
template <bool F32_OUT>
using int8_matmul_epilogue = vq::i8mma::ZpEpilogue<F32_OUT, true, false>;

template <typename T>
void launch_dyn_quant(const void* x, void* q, void* scale, void* zp,
                      void* rowsum, int M, int K, int sym, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(scale);
  float* z = static_cast<float*>(zp);
  float* r = static_cast<float*>(rowsum);
  if (sym)
    dyn_quant_rows_kernel<T, true><<<M, DQ_THREADS, 0, st>>>(xt, qt, s, z, r, K);
  else
    dyn_quant_rows_kernel<T, false><<<M, DQ_THREADS, 0, st>>>(xt, qt, s, z, r, K);
}

template <bool F32_OUT>
cudaError_t launch_matmul(const int8_t* A, const int8_t* Wt, const float* const* f,
                          void* out, int M, int N, int K, cudaStream_t st) {
  const int8_matmul_epilogue<F32_OUT> epi{f[0], f[1], f[2], f[3], f[4], f[5],
                                          f[6], out, M, N,
                                          static_cast<float>(K)};
  if (vq::i8mma::tma_ok(A, Wt, K))
    return vq::i8mma::launch_tma(A, Wt, epi, K, K, st);
  return vq::i8mma::launch_edge(A, Wt, epi, K, st);
}

}  // namespace

// x [M, K] (bf16 when is_bf16, else f32), rows 16-byte aligned and at most
// DQ_THREADS * DQ_VECS * 16 bytes; q [M, K] int8; scale, zp, rowsum [M] f32.
VQ_EXPORT int vq_dyn_quant_rows(const void* x, void* q, void* scale, void* zp,
                                void* rowsum, int M, int K, int sym,
                                int is_bf16, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch_dyn_quant<__nv_bfloat16>(x, q, scale, zp, rowsum, M, K, sym, st);
  else
    launch_dyn_quant<float>(x, q, scale, zp, rowsum, M, K, sym, st);
  return static_cast<int>(cudaGetLastError());
}

// A [M, K] int8, Wt [N, K] int8 (the K-major weight: W [K, N] stored
// transposed); xs, xzp, xrs [M] f32; ws, wzp, wcs [N] f32; bias [N] f32
// (rounded to the output type before the add) or null; out [M, N] f32 when
// f32_out, else bf16.
VQ_EXPORT int vq_int8_matmul(const void* A, const void* Wt, const void* xs,
                             const void* xzp, const void* xrs, const void* ws,
                             const void* wzp, const void* wcs,
                             const void* bias, void* out, int M, int N, int K,
                             int f32_out, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* w = static_cast<const int8_t*>(Wt);
  const float* f[7] = {static_cast<const float*>(xs),
                       static_cast<const float*>(xzp),
                       static_cast<const float*>(xrs),
                       static_cast<const float*>(ws),
                       static_cast<const float*>(wzp),
                       static_cast<const float*>(wcs),
                       static_cast<const float*>(bias)};
  const cudaError_t e = f32_out ? launch_matmul<true>(a, w, f, out, M, N, K, st)
                                : launch_matmul<false>(a, w, f, out, M, N, K, st);
  return static_cast<int>(e);
}
