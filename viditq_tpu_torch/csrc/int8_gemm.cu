// K2: int8 x int8 -> int32 GEMM with the symmetric dequant epilogue, the
// group-wise activation-scale mode, the GELU + group-quantize emission and
// the zero-point-corrected epilogues of asymmetric acts or weights.
//
// Replaces the TPU kernel `int8_consumer_matmul` / `_consumer_kernel`
// (viditq_tpu/kernels/fused_matmul.py:316-571):
//   plain: out = float(acc) * (xs[m] * ws[n]) + b[n]
//   gw_x : facc = sum_g float(acc_g) * xs[m, g]  (f32, groups in order)
//          out  = facc * ws[n] + b[n]
//   emit : y = gelu_tanh(plain out) written as f32 scratch, then
//          group_quant_kernel quantizes each (row x group of gw columns),
//          with the next layer's column scale first where one is given
//          (has_ecs, :372-374: y = y * cs[n], RowQuant::balance):
//          s = max(absmax * (1/127), 1e-6); codes = round(y * (1/s))
//   sym acts x asym weights (:357):
//          out = (float(acc) - wzp[n]*xrs[m]) * (xs[m]*ws[n]) + b[n]
//   asym acts (:359-362):
//          c = float(acc) - xzp[m]*wcs[n] - wzp[n]*xrs[m] + (K*xzp[m])*wzp[n]
//          out = (c * xs[m]) * ws[n] + b[n]
//   residual (+ gate), on plain, gw_x and both zero-point modes (:383-390):
//          o = out * gate[m / (M/G), n] (with a gate), then o + res[m, n]
// every product and sum rounded in f32 in that order (-fmad=false), the
// bias added in f32 before the output's cast (:363-364; K7b rounds it to
// the output type first). gw_x and the emission take sym x sym only; the
// residual epilogue takes bf16 out and no emission (:438-440).
//
// Bound on the card: the int8 tensor cores at the main path's shapes
// (M = 32768, K/N in 1152..4608: ~100-300 int8 ops per byte moved). The
// product is the TMA + s8 wgmma core of int8_mma.cuh (K-major weight,
// 128x192 tiles; 128x128 in gw_x, whose f32 accumulator doubles the
// registers a thread holds); its epilogues are the core's
// (int8_mma.cuh: int8_gemm_epilogue, and ZpEpilogue, which K7b's is too).
// The emission's row max spans a whole 1536-column group, wider than a
// tile, hence the f32 scratch and the second pass. The residual epilogue
// reads one more [M, N] bf16 tensor (at the spatial proj the bytes, 0.057
// ms, then bound it): each warpgroup's residual tile arrives by TMA in its
// output staging boxes while the main loop runs, and its gate row in
// shared memory, so the epilogue reads both from shared memory (a first
// version that loaded them from global memory in the epilogue cost 0.2 ms
// more a call on an H100: the loads' latency, serialized in the unrolled
// loop).
#include <type_traits>

#include "int8_mma.cuh"

namespace {

using vq::i8mma::int8_gemm_epilogue;

// The zero-point-corrected modes: int8_mma.cuh's ZpEpilogue (shared with
// K7b), the f32 bias added before the cast. ASYM_X = asym acts (xzp given),
// else sym acts x asym weights. Out: bf16 or f32.
template <bool ASYM_X, bool F32_OUT, bool RES = false>
cudaError_t launch_gemm_zp(const int8_t* A, const int8_t* Wt,
                           const float* const* f, void* out, int M, int N,
                           int K, const vq::i8mma::ResGate& rg,
                           cudaStream_t st) {
  const vq::i8mma::ZpEpilogue<F32_OUT, false, !ASYM_X, RES> epi{
      f[0], f[1], f[2], f[3], f[4], f[5], f[6], out, M, N,
      static_cast<float>(K), rg};
  return vq::i8mma::launch_tma(A, Wt, epi, K, K, st);
}

// float4 vectors a lane of group_quant_kernel holds: groups of up to
// 32 * 18 * 4 = 2304 columns (emit_groups' widest)
constexpr int GQ_VECS = 18;

__device__ __forceinline__ uint32_t pack_codes(float4 v, float inv) {
  const auto b = [&](float f, int sh) {
    return static_cast<uint32_t>(static_cast<uint8_t>(vq::round_sat_s8(f * inv)))
           << sh;
  };
  return b(v.x, 0) | b(v.y, 8) | b(v.z, 16) | b(v.w, 24);
}

// One warp per (row, group): the group's values are read once, as float4
// held in registers (CS: then times the column scales cs, read once all the
// values' loads are in flight);
// s = max(absmax * (1/127), 1e-6), codes = clip(round(y * (1/s)))
// (fused_matmul.py:375-378), stored 4 to a word. The absmax is a max, so
// its order changes nothing.
template <bool CS>
__global__ void group_quant_kernel(const float* __restrict__ y,
                                   const float* __restrict__ cs,
                                   int8_t* __restrict__ q,
                                   float* __restrict__ scales, int M, int N,
                                   int gw) {
  const int G = N / gw;
  const int item = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= M * G) return;
  const int row = item / G;
  const int grp = item % G;
  const size_t off = static_cast<size_t>(row) * N + static_cast<size_t>(grp) * gw;
  const float4* p = reinterpret_cast<const float4*>(y + off);
  const int nv = gw / 4;
  float4 v[GQ_VECS];
  float am = 0.0f;
#pragma unroll
  for (int i = 0; i < GQ_VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) {
      v[i] = p[c];
      if constexpr (!CS)
        am = fmaxf(am, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                             fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    }
  }
  if constexpr (CS) {
    const float4* cp =
        reinterpret_cast<const float4*>(cs + static_cast<size_t>(grp) * gw);
#pragma unroll
    for (int i = 0; i < GQ_VECS; ++i) {
      const int c = lane + 32 * i;
      if (c < nv) {
        const float4 s = __ldg(cp + c);
        v[i] = make_float4(vq::RowQuant::balance(v[i].x, s.x),
                           vq::RowQuant::balance(v[i].y, s.y),
                           vq::RowQuant::balance(v[i].z, s.z),
                           vq::RowQuant::balance(v[i].w, s.w));
        am = fmaxf(am, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                             fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
      }
    }
  }
  am = vq::warp_max(am);
  const float s = fmaxf(am * static_cast<float>(1.0 / 127.0), 1e-6f);
  const float inv = 1.0f / s;
  uint32_t* qr = reinterpret_cast<uint32_t*>(q + off);
#pragma unroll
  for (int i = 0; i < GQ_VECS; ++i) {
    const int c = lane + 32 * i;
    if (c < nv) qr[c] = pack_codes(v[i], inv);
  }
  if (lane == 0) scales[static_cast<size_t>(row) * G + grp] = s;
}

template <bool GW, int OUT_KIND, bool RES = false>
cudaError_t launch_gemm(const int8_t* A, const int8_t* Wt, const float* xs,
                        int G, const float* ws, const float* bias, void* out,
                        int M, int N, int K, const vq::i8mma::ResGate& rg,
                        cudaStream_t st) {
  const int8_gemm_epilogue<GW, OUT_KIND, RES> epi{xs, G, ws, bias,
                                                  out, M, N, rg};
  return vq::i8mma::launch_tma(A, Wt, epi, K, K / G, st);
}

}  // namespace

// A [M, K] int8, Wt [N, K] int8 (the K-major weight: W [K, N] stored
// transposed), xs [M, G] f32 (G == 1 unless group_wise), ws [N] f32, bias
// [N] f32 or null. out_kind 0: out [M, N] bf16; 1: out [M, N] f32; 2: out
// [M, N] f32 = gelu(result) (emission scratch). K % 64 == 0, N % 16 == 0,
// 16-byte aligned A and Wt, and with group_wise (K / G) % 64 == 0. res
// [M, N] bf16 or null: the residual epilogue (out_kind 0), with gate [G,
// N] bf16 or null, rows_per_gate = M / G.
VQ_EXPORT int vq_int8_gemm(const void* A, const void* Wt, const void* xs,
                           int G, const void* ws, const void* bias, void* out,
                           int M, int N, int K, int group_wise, int out_kind,
                           const void* res, const void* gate,
                           int rows_per_gate, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* w = static_cast<const int8_t*>(Wt);
  vq::i8mma::ResGate rg;
  if (!vq::i8mma::tma_ok(a, w, K) ||
      !vq::i8mma::res_gate(res, gate, rows_per_gate, &rg) ||
      (res != nullptr && out_kind != 0))
    return cudaErrorInvalidValue;
  const float* x_s = static_cast<const float*>(xs);
  const float* w_s = static_cast<const float*>(ws);
  const float* b = static_cast<const float*>(bias);
  cudaError_t e;
  if (res != nullptr) {
    e = group_wise
            ? launch_gemm<true, 0, true>(a, w, x_s, G, w_s, b, out, M, N, K,
                                         rg, st)
            : launch_gemm<false, 0, true>(a, w, x_s, 1, w_s, b, out, M, N, K,
                                          rg, st);
  } else if (group_wise) {
    if (out_kind == 0)
      e = launch_gemm<true, 0>(a, w, x_s, G, w_s, b, out, M, N, K, rg, st);
    else if (out_kind == 1)
      e = launch_gemm<true, 1>(a, w, x_s, G, w_s, b, out, M, N, K, rg, st);
    else
      e = launch_gemm<true, 2>(a, w, x_s, G, w_s, b, out, M, N, K, rg, st);
  } else {
    if (out_kind == 0)
      e = launch_gemm<false, 0>(a, w, x_s, 1, w_s, b, out, M, N, K, rg, st);
    else if (out_kind == 1)
      e = launch_gemm<false, 1>(a, w, x_s, 1, w_s, b, out, M, N, K, rg, st);
    else
      e = launch_gemm<false, 2>(a, w, x_s, 1, w_s, b, out, M, N, K, rg, st);
  }
  return static_cast<int>(e);
}

// The zero-point-corrected modes: A, Wt as vq_int8_gemm; xs [M] f32; xzp
// [M] f32 (asym acts) or null (sym acts: then wzp is needed); xrs [M] f32
// or null (zeros); ws [N] f32; wzp [N] f32 or null (sym weights); wcs [N]
// f32 (needed with xzp) or null; bias [N] f32 or null; out [M, N] f32 when
// f32_out, else bf16. K % 64 == 0, N % 16 == 0, A and Wt 16-byte aligned.
// res, gate, rows_per_gate: the residual epilogue as vq_int8_gemm's (bf16
// out).
VQ_EXPORT int vq_int8_gemm_zp(const void* A, const void* Wt, const void* xs,
                              const void* xzp, const void* xrs,
                              const void* ws, const void* wzp,
                              const void* wcs, const void* bias, void* out,
                              int M, int N, int K, int f32_out,
                              const void* res, const void* gate,
                              int rows_per_gate, void* stream) {
  const int8_t* a = static_cast<const int8_t*>(A);
  const int8_t* w = static_cast<const int8_t*>(Wt);
  vq::i8mma::ResGate rg;
  if (!vq::i8mma::tma_ok(a, w, K) || (xzp == nullptr && wzp == nullptr) ||
      (xzp != nullptr && wcs == nullptr) ||
      !vq::i8mma::res_gate(res, gate, rows_per_gate, &rg) ||
      (res != nullptr && f32_out))
    return cudaErrorInvalidValue;
  const auto p = [](const void* v) { return static_cast<const float*>(v); };
  const float* f[7] = {p(xs), p(xzp), p(xrs), p(ws), p(wzp), p(wcs), p(bias)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (res != nullptr)
    e = xzp != nullptr
            ? launch_gemm_zp<true, false, true>(a, w, f, out, M, N, K, rg, st)
            : launch_gemm_zp<false, false, true>(a, w, f, out, M, N, K, rg,
                                                 st);
  else if (xzp != nullptr)
    e = f32_out ? launch_gemm_zp<true, true>(a, w, f, out, M, N, K, rg, st)
                : launch_gemm_zp<true, false>(a, w, f, out, M, N, K, rg, st);
  else
    e = f32_out ? launch_gemm_zp<false, true>(a, w, f, out, M, N, K, rg, st)
                : launch_gemm_zp<false, false>(a, w, f, out, M, N, K, rg, st);
  return static_cast<int>(e);
}

// y [M, N] f32, cs [N] f32 (the column scales) or null -> q [M, N] int8,
// scales [M, N / gw] f32; gw a multiple of 16 that divides N, at most
// 32 * GQ_VECS * 4; y, cs and q 16-byte aligned.
VQ_EXPORT int vq_group_quant(const void* y, const void* cs, void* q,
                             void* scales, int M, int N, int gw,
                             void* stream) {
  if (gw <= 0 || gw % 16 != 0 || N % gw != 0 || gw > 32 * GQ_VECS * 4 ||
      reinterpret_cast<uintptr_t>(cs) % 16 != 0)
    return cudaErrorInvalidValue;
  const int items = M * (N / gw);
  const int threads = 256;
  const int blocks = (items * 32 + threads - 1) / threads;
  const auto kernel =
      cs != nullptr ? group_quant_kernel<true> : group_quant_kernel<false>;
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(cs),
      static_cast<int8_t*>(q), static_cast<float*>(scales), M, N, gw);
  return static_cast<int>(cudaGetLastError());
}
