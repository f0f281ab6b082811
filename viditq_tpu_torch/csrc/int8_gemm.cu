// K2: int8 x int8 -> int32 GEMM with the symmetric dequant epilogue, the
// group-wise activation-scale mode and the GELU + group-quantize emission.
//
// Replaces the TPU kernel `int8_consumer_matmul` / `_consumer_kernel`
// (viditq_tpu/kernels/fused_matmul.py:316-571) in its sym x sym modes:
//   plain: out = float(acc) * (xs[m] * ws[n]) + b[n]
//   gw_x : facc = sum_g float(acc_g) * xs[m, g]  (f32, groups in order)
//          out  = facc * ws[n] + b[n]
//   emit : y = gelu_tanh(plain out) written as f32 scratch, then
//          group_quant_kernel quantizes each (row x group of gw columns):
//          s = max(absmax * (1/127), 1e-6); codes = round(y * (1/s))
//
// Bound on the card: the int8 tensor cores at the main path's shapes
// (M = 32768, K/N in 1152..4608: ~100-300 int8 ops per byte moved). This
// kernel is a simple form: the main loop of int8_mma.cuh (128x128x64 block
// tiles, register-staged double buffering, mma.sync m16n8k32 s8) with this
// kernel's epilogues. The emission's row max spans a whole 1536-column
// group, wider than a block, hence the f32 scratch and the second pass.
#include "int8_mma.cuh"

namespace {

using vq::i8mma::BM;
using vq::i8mma::BN;

__device__ __forceinline__ float gelu_tanh(float o) {
  // 0.5 * o * (1 + tanh(sqrt(2/pi) * (o + 0.044715 * o^3))), o^3 = (o*o)*o
  const float o3 = o * o * o;
  return 0.5f * o * (1.0f + tanhf(0.7978845608028654f * (o + 0.044715f * o3)));
}

// OUT_KIND: 0 = bf16 out, 1 = f32 out, 2 = f32 gelu(out) (emission scratch)
template <bool GW, int OUT_KIND>
__global__ void __launch_bounds__(256)
    int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                     const float* __restrict__ xs, int G,
                     const float* __restrict__ ws,
                     const float* __restrict__ bias, void* __restrict__ out,
                     int M, int N, int K, int kg) {
  __shared__ vq::i8mma::Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4][4];
  float facc[GW ? 4 : 1][GW ? 4 : 1][GW ? 4 : 1];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  if constexpr (GW) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) facc[i][j][e] = 0.0f;
  }

  vq::i8mma::mainloop<false>(A, W, M, N, K, m0, n0, sm, acc, [&](int kt) {
    if constexpr (GW) {
      if (((kt + 1) * vq::i8mma::BK) % kg == 0) {
        // group boundary: dequantize this k-group's partial sums by the
        // group's per-row scale and fold into the f32 accumulator
        const int grp = kt * vq::i8mma::BK / kg;
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
            const float s =
                row < M ? xs[static_cast<size_t>(row) * G + grp] : 0.0f;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              facc[mi][ni][e] =
                  facc[mi][ni][e] + static_cast<float>(acc[mi][ni][e]) * s;
              acc[mi][ni][e] = 0;
            }
          }
      }
    }
  });

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + ni * 8 + t * 2 + (e & 1);
        if (row >= M || col >= N) continue;
        float o;
        if constexpr (GW) {
          o = facc[mi][ni][e] * ws[col];
        } else {
          o = static_cast<float>(acc[mi][ni][e]) * (xs[row] * ws[col]);
        }
        if (bias != nullptr) o = o + bias[col];
        const size_t idx = static_cast<size_t>(row) * N + col;
        if constexpr (OUT_KIND == 0) {
          static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(o);
        } else if constexpr (OUT_KIND == 1) {
          static_cast<float*>(out)[idx] = o;
        } else {
          static_cast<float*>(out)[idx] = gelu_tanh(o);
        }
      }
}

// One warp per (row, group): s = max(absmax * (1/127), 1e-6),
// codes = clip(round(y * (1/s))) (fused_matmul.py:375-378).
__global__ void group_quant_kernel(const float* __restrict__ y,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ scales, int M, int N,
                                   int gw) {
  const int G = N / gw;
  const int item = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= M * G) return;
  const int row = item / G;
  const int grp = item % G;
  const float* p = y + static_cast<size_t>(row) * N + static_cast<size_t>(grp) * gw;
  float am = 0.0f;
  for (int c = lane; c < gw; c += 32) am = fmaxf(am, fabsf(p[c]));
  am = vq::warp_max(am);
  const float s = fmaxf(am * static_cast<float>(1.0 / 127.0), 1e-6f);
  const float inv = 1.0f / s;
  int8_t* qr = q + static_cast<size_t>(row) * N + static_cast<size_t>(grp) * gw;
  for (int c = lane; c < gw; c += 32) qr[c] = vq::round_sat_s8(p[c] * inv);
  if (lane == 0) scales[static_cast<size_t>(row) * G + grp] = s;
}

template <bool GW, int OUT_KIND>
void launch_gemm(const int8_t* A, const int8_t* W, const float* xs, int G,
                 const float* ws, const float* bias, void* out, int M, int N,
                 int K, int kg, cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<GW, OUT_KIND><<<grid, 256, 0, st>>>(A, W, xs, G, ws, bias,
                                                      out, M, N, K, kg);
}

}  // namespace

// A [M, K] int8, W [K, N] int8, xs [M, G] f32 (G == 1 unless group_wise),
// ws [N] f32, bias [N] f32 or null. out_kind 0: out [M, N] bf16; 1: out
// [M, N] f32; 2: out [M, N] f32 = gelu(result) (emission scratch).
// K % 64 == 0, N % 16 == 0, and with group_wise (K / G) % 64 == 0.
VQ_EXPORT int vq_int8_gemm(const void* A, const void* W, const void* xs,
                           int G, const void* ws, const void* bias, void* out,
                           int M, int N, int K, int group_wise, int out_kind,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* w = static_cast<const int8_t*>(W);
  const float* x_s = static_cast<const float*>(xs);
  const float* w_s = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  const int kg = K / G;
  if (group_wise) {
    if (out_kind == 0)
      launch_gemm<true, 0>(a, w, x_s, G, w_s, b, out, M, N, K, kg, st);
    else if (out_kind == 1)
      launch_gemm<true, 1>(a, w, x_s, G, w_s, b, out, M, N, K, kg, st);
    else
      launch_gemm<true, 2>(a, w, x_s, G, w_s, b, out, M, N, K, kg, st);
  } else {
    if (out_kind == 0)
      launch_gemm<false, 0>(a, w, x_s, G, w_s, b, out, M, N, K, kg, st);
    else if (out_kind == 1)
      launch_gemm<false, 1>(a, w, x_s, G, w_s, b, out, M, N, K, kg, st);
    else
      launch_gemm<false, 2>(a, w, x_s, G, w_s, b, out, M, N, K, kg, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// y [M, N] f32 -> q [M, N] int8, scales [M, N / gw] f32.
VQ_EXPORT int vq_group_quant(const void* y, void* q, void* scales, int M,
                             int N, int gw, void* stream) {
  const int items = M * (N / gw);
  const int threads = 256;
  const int blocks = (items * 32 + threads - 1) / threads;
  group_quant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<int8_t*>(q),
      static_cast<float*>(scales), M, N, gw);
  return static_cast<int>(cudaGetLastError());
}
