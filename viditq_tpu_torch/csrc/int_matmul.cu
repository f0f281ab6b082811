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
// bytes for bf16 x (0.034 ms at [32768, 1152]). Design: one warp per row,
// eight rows a block of 256 threads, no shared memory and no block
// barrier. A lane owns chunks of 16 consecutive elements (two 16-byte
// vectors of bf16, four of f32), chunk lane + 32*i, so a lane's 16 codes
// leave in one 16-byte store; min/max and the row sum reduce by shuffles.
// A row of up to CPL chunks a lane stays in registers from its one read
// (bf16 K <= 4608); a longer row is read in passes of CPL chunks a lane,
// once for min/max and again (from L2) for the codes, so K has no limit
// beyond K * sizeof(x) % 16 == 0. Thousands of independent warps keep some
// 64 KB of loads in flight per SM.
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

constexpr int DQ_WARPS = 8;  // rows a block

using vq::elem;  // 16-byte vectors of T (common.cuh)

// One warp per row of x [M, K]; CPL chunks of 16 elements a lane at a time;
// RESIDENT: the whole row fits them (one read), else two reads in passes.
template <typename T, bool SYM, int CPL, bool RESIDENT>
__global__ void __launch_bounds__(DQ_WARPS * 32)
    dyn_quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ scale, float* __restrict__ zp,
                          float* __restrict__ rowsum, int M, int K) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int VPC = 16 / VEC;        // vectors of a 16-element chunk
  const int row = blockIdx.x * DQ_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nvec = K / VEC;
  const int nchunk = (nvec + VPC - 1) / VPC;
  const bool wide = K % 16 == 0;  // 16-byte aligned code chunks
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K);
  int8_t* qr = q + static_cast<size_t>(row) * K;
  uint4 raw[CPL * VPC];

  // chunks base + lane + 32*i of the row into raw (vectors past K: unread)
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int u = 0; u < VPC; ++u) {
        const int vi = (base + lane + 32 * i) * VPC + u;
        if (vi < nvec) raw[i * VPC + u] = xr[vi];
      }
  };
  float lo = 0.0f;  // asym: min(x, 0)
  float hi = 0.0f;  // asym: max(x, 0); sym: absmax
  auto scan = [&](int base) {
#pragma unroll
    for (int i = 0; i < CPL; ++i)
#pragma unroll
      for (int u = 0; u < VPC; ++u) {
        if ((base + lane + 32 * i) * VPC + u >= nvec) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = elem<T>(raw[i * VPC + u], e);
          if constexpr (SYM) {
            hi = fmaxf(hi, fabsf(f));
          } else {
            lo = fminf(lo, f);
            hi = fmaxf(hi, f);
          }
        }
      }
  };
  const int step = 32 * CPL;  // chunks a pass
  if constexpr (RESIDENT) {
    load(0);
    scan(0);
  } else {
    for (int base = 0; base < nchunk; base += step) {
      load(base);
      scan(base);
    }
  }
  hi = vq::warp_max(hi);
  lo = vq::warp_min(lo);
  float s, z;
  if constexpr (SYM) {
    s = fmaxf(hi / 127.0f, 1e-6f);
    z = 0.0f;
  } else {
    s = fmaxf((hi - lo) / 255.0f, 1e-6f);
    z = rintf(-lo / s) - 128.0f;
  }

  int sum = 0;
  auto emit = [&](int base) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int ch = base + lane + 32 * i;
      if (ch >= nchunk) continue;
      uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int u = 0; u < VPC; ++u) {
        if (ch * VPC + u >= nvec) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float c = rintf(elem<T>(raw[i * VPC + u], e) / s);
          if constexpr (!SYM) c = c + z;
          const int code = static_cast<int>(fminf(fmaxf(c, -128.0f), 127.0f));
          sum += code;
          const int at = u * VEC + e;  // code index in the chunk
          packed[at >> 2] |= static_cast<uint32_t>(code & 0xff)
                             << (8 * (at & 3));
        }
      }
      if (wide && (ch + 1) * VPC <= nvec) {
        *reinterpret_cast<uint4*>(qr + ch * 16) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
      } else {  // a row of K % 16 != 0 codes: per-vector stores
#pragma unroll
        for (int u = 0; u < VPC; ++u) {
          const int vi = ch * VPC + u;
          if (vi >= nvec) continue;
          if constexpr (VEC == 8)
            *reinterpret_cast<uint2*>(qr + vi * 8) =
                make_uint2(packed[2 * u], packed[2 * u + 1]);
          else
            *reinterpret_cast<uint32_t*>(qr + vi * 4) = packed[u];
        }
      }
    }
  };
  if constexpr (RESIDENT) {
    emit(0);
  } else {
    for (int base = 0; base < nchunk; base += step) {
      load(base);
      emit(base);
    }
  }
  sum = vq::warp_sum_int(sum);
  if (lane == 0) {
    scale[row] = s;
    zp[row] = z;
    rowsum[row] = static_cast<float>(sum);
  }
}

// The epilogue of int8_mma.cuh's kernels: the core's ZpEpilogue (shared
// with K2's zero-point modes), the bias rounded to the output type first.
template <bool F32_OUT>
using int8_matmul_epilogue = vq::i8mma::ZpEpilogue<F32_OUT, true, false>;

template <typename T, bool SYM, int CPL, bool RESIDENT>
void launch_dq(const void* x, void* q, void* scale, void* zp, void* rowsum,
               int M, int K, cudaStream_t st) {
  dyn_quant_rows_kernel<T, SYM, CPL, RESIDENT>
      <<<(M + DQ_WARPS - 1) / DQ_WARPS, DQ_WARPS * 32, 0, st>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), static_cast<float*>(zp),
          static_cast<float*>(rowsum), M, K);
}

// the instantiation by row length: bf16 rows stay in registers up to 9
// chunks a lane (K <= 4608), f32 rows up to 5 (K <= 2560); longer rows
// are read twice
template <typename T, bool SYM>
void launch_dyn_quant(const void* x, void* q, void* scale, void* zp,
                      void* rowsum, int M, int K, cudaStream_t st) {
  constexpr int BIG = sizeof(T) == 2 ? 9 : 5;
  const int per_lane = ((K + 15) / 16 + 31) / 32;
  if (per_lane <= 3)
    launch_dq<T, SYM, 3, true>(x, q, scale, zp, rowsum, M, K, st);
  else if (per_lane <= BIG)
    launch_dq<T, SYM, BIG, true>(x, q, scale, zp, rowsum, M, K, st);
  else
    launch_dq<T, SYM, BIG, false>(x, q, scale, zp, rowsum, M, K, st);
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

// x [M, K] (bf16 when is_bf16, else f32), rows 16-byte aligned (any K);
// q [M, K] int8; scale, zp, rowsum [M] f32.
VQ_EXPORT int vq_dyn_quant_rows(const void* x, void* q, void* scale, void* zp,
                                void* rowsum, int M, int K, int sym,
                                int is_bf16, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 && sym)
    launch_dyn_quant<__nv_bfloat16, true>(x, q, scale, zp, rowsum, M, K, st);
  else if (is_bf16)
    launch_dyn_quant<__nv_bfloat16, false>(x, q, scale, zp, rowsum, M, K, st);
  else if (sym)
    launch_dyn_quant<float, true>(x, q, scale, zp, rowsum, M, K, st);
  else
    launch_dyn_quant<float, false>(x, q, scale, zp, rowsum, M, K, st);
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
