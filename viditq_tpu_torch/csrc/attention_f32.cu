// K3 in float32: the one-shot attention's full, kv-masked and seg modes for
// f32 q/k/v and an f32 output, the dtype of the float32 block that AdaRound
// reconstruction runs (viditq_tpu/quant/reconstruction.py:431-461).
//
// Replaces the TPU kernel `_attn_kernel` behind `attention_bnhd`
// (viditq_tpu/kernels/attention.py:80-234) when its inputs are f32. Per
// (b, h, q row), the numerics of that kernel in f32 (attention.py:143-144,
// :198-203) and of the port's plain version (kernels/attention.py
// `attention_bnhd_plain`):
//   s = bf16(q * scale*log2e) . bf16(k)        (f32 sums)
//   m = rowmax(s); e = exp2(s - m); r = sum(e)
//   o = sum(e * v) * (1/r)                     (all f32)
//
// Full and kv-masked attention (mask [B, M] int32, 1 = attend) run the
// float32 core (csrc/attn_f32_core.cuh: q.k on the bf16 tensor cores, the
// PV as three TF32 products, one pass), as K6's float32 mode does.
//
// Seg mode (block-diagonal: a q row attends to the kv rows of its own
// segment of `seg` tokens; k/v co-indexed with q) has a kernel of its own.
// Its work is small (at STDiT's temporal site, [2, 16384, 16, 72] at seg
// 16: 2.4 GFLOP, 0.04 ms on the f32 CUDA cores) against its bytes (q/k/v/o
// in f32, 604 MB: 0.180 ms), so it is designed for the byte bound:
// - a warp owns a unit: one head and a group of whole segments (32 / seg
//   of them, up to 32 q rows) or, for seg > 32, 32 q rows of one segment;
//   a lane owns one q row, pre-scaled and rounded to bf16 in registers;
// - the unit's k and v rows of its head land in the warp's slice of shared
//   memory by 16-byte cp.async (a segment's rows in pieces of 32 for seg >
//   32); every other read and the output write are 16-byte vectors too;
// - scores only on the diagonal seg x seg blocks: a lane walks its own
//   segment's kv rows in chunks of 16, the scores of a chunk in registers,
//   then one exp2 pass and the PV as f32 FMAs; at seg <= 16 a segment is
//   one chunk, so its max is known after its single q.k and the softmax is
//   the plain version's (one pass, no rescale); longer segments rescale
//   once a chunk, as the core does a tile;
// - consecutive warps take consecutive heads of the same tokens, so a
//   block reads whole stretches of q/k/v rows.

#include "attn_f32_core.cuh"

namespace vq {
namespace attn_seg_f32 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 32;   // q rows of a unit, kv rows of a staged piece
constexpr int CHUNK = 16;  // kv rows scored at once by a lane

template <int D>
struct Seg {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  static constexpr int RS = D + 4;  // floats a staged row (16-byte aligned)
  static constexpr int WARP_FLOATS = 2 * ROWS * RS;  // k, then v
  static constexpr int BYTES = WARPS * WARP_FLOATS * 4;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// q/k/v/out [B, N, H*D] f32, 16-byte aligned; seg divides N
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
    attn_seg_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        float* __restrict__ out, int B, int N, int H,
                        int seg, float scale2) {
  using T = Seg<D>;
  constexpr int CH = D / 4;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* Ks = sm + warp * T::WARP_FLOATS;
  float* Vs = Ks + ROWS * T::RS;

  // the unit: (b, q chunk, head), head fastest
  const bool short_seg = seg <= ROWS;
  const int per_seg = short_seg ? 0 : (seg + ROWS - 1) / ROWS;
  const int unit_rows = short_seg ? (ROWS / seg) * seg : ROWS;
  const int n_chunks = short_seg ? (N + unit_rows - 1) / unit_rows
                                 : (N / seg) * per_seg;
  const long long u = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (u >= static_cast<long long>(B) * n_chunks * H) return;
  const int h = static_cast<int>(u % H);
  const int qc = static_cast<int>((u / H) % n_chunks);
  const int b = static_cast<int>(u / (static_cast<long long>(H) * n_chunks));
  int r0, n_rows, kv_lo, kv_hi;
  if (short_seg) {
    r0 = qc * unit_rows;
    n_rows = min(unit_rows, N - r0);
    kv_lo = r0;
    kv_hi = r0 + n_rows;
  } else {
    const int s0 = (qc / per_seg) * seg, c = qc % per_seg;
    r0 = s0 + c * ROWS;
    n_rows = min(ROWS, seg - c * ROWS);
    kv_lo = s0;
    kv_hi = s0 + seg;
  }
  const int C = H * D;
  const size_t base = static_cast<size_t>(b) * N * C + h * D;
  const bool has_row = lane < n_rows;
  const int row = r0 + lane;

  float qv[D];  // this lane's q row: bf16(q * scale2)
  float m_run = -INFINITY, r = 0.0f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;

  for (int p0 = kv_lo; p0 < kv_hi; p0 += ROWS) {
    const int p_rows = min(ROWS, kv_hi - p0);
    __syncwarp();  // every lane is done with the last piece
    for (int i = lane; i < p_rows * CH; i += 32) {
      const int rr = i / CH, c = i % CH;
      const size_t off = base + static_cast<size_t>(p0 + rr) * C + 4 * c;
      const uint32_t dst = (rr * T::RS + 4 * c) * 4;
      attn_f32::f32_cp_async16(smem_u32(Ks) + dst, k + off);
      attn_f32::f32_cp_async16(smem_u32(Vs) + dst, v + off);
    }
    attn_f32::f32_cp_async_commit();
    if (p0 == kv_lo) {  // the q row loads overlap the first piece's
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (has_row)
          x = *reinterpret_cast<const float4*>(
              q + base + static_cast<size_t>(row) * C + 4 * c);
        qv[4 * c] = bf16_round(x.x * scale2);
        qv[4 * c + 1] = bf16_round(x.y * scale2);
        qv[4 * c + 2] = bf16_round(x.z * scale2);
        qv[4 * c + 3] = bf16_round(x.w * scale2);
      }
    }
    attn_f32::f32_cp_async_wait_all();
    __syncwarp();
    // k rounded to bf16 in place, once for the warp
    for (int i = lane; i < p_rows * CH; i += 32) {
      float4* x = reinterpret_cast<float4*>(Ks + (i / CH) * T::RS +
                                            4 * (i % CH));
      const float4 y = *x;
      *x = make_float4(bf16_round(y.x), bf16_round(y.y), bf16_round(y.z),
                       bf16_round(y.w));
    }
    __syncwarp();

    // this lane's kv rows in the piece: its own segment's (none without a
    // q row)
    const int w_lo = short_seg ? (lane / seg) * seg : 0;
    const int w_len = !has_row ? 0 : short_seg ? seg : p_rows;
    for (int c0 = 0; c0 < w_len; c0 += CHUNK) {
      float s[CHUNK];
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) s[jj] = 0.0f;
      // s = q . k over the chunk's rows (bf16 operands: exact products)
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int jj = 0; jj < CHUNK; ++jj) {
          if (c0 + jj < w_len) {
            const float4 x = *reinterpret_cast<const float4*>(
                Ks + (w_lo + c0 + jj) * T::RS + 4 * c);
            float a = __fmaf_rn(qv[4 * c], x.x, s[jj]);
            a = __fmaf_rn(qv[4 * c + 1], x.y, a);
            a = __fmaf_rn(qv[4 * c + 2], x.z, a);
            s[jj] = __fmaf_rn(qv[4 * c + 3], x.w, a);
          }
        }
      }
      float tm = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj)
        if (c0 + jj < w_len) tm = fmaxf(tm, s[jj]);
      const float m_new = fmaxf(m_run, tm);
      const float corr = exp2f(m_run - m_new);
      m_run = m_new;
      float part = 0.0f;
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        s[jj] = c0 + jj < w_len ? exp2f(s[jj] - m_new) : 0.0f;
        part += s[jj];
      }
      r = r * corr + part;
      if (c0 > 0 || p0 > kv_lo) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
      }
#pragma unroll
      for (int jj = 0; jj < CHUNK; ++jj) {
        if (c0 + jj < w_len) {
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const float4 x = *reinterpret_cast<const float4*>(
                Vs + (w_lo + c0 + jj) * T::RS + 4 * c);
            acc[4 * c] = __fmaf_rn(s[jj], x.x, acc[4 * c]);
            acc[4 * c + 1] = __fmaf_rn(s[jj], x.y, acc[4 * c + 1]);
            acc[4 * c + 2] = __fmaf_rn(s[jj], x.z, acc[4 * c + 2]);
            acc[4 * c + 3] = __fmaf_rn(s[jj], x.w, acc[4 * c + 3]);
          }
        }
      }
    }
  }

  if (!has_row) return;
  const float inv = 1.0f / r;
  float* orow = out + base + static_cast<size_t>(row) * C;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    *reinterpret_cast<float4*>(orow + 4 * c) =
        make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                    acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int B, int N, int H, int seg, float scale2,
                   cudaStream_t st) {
  auto kernel = attn_seg_f32_kernel<D>;
  const int smem = Seg<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_chunks =
      seg <= ROWS ? (N + (ROWS / seg) * seg - 1) / ((ROWS / seg) * seg)
                  : static_cast<long long>(N / seg) * ((seg + ROWS - 1) / ROWS);
  const long long units = static_cast<long long>(B) * n_chunks * H;
  const long long blocks = (units + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, st>>>(
      q, k, v, out, B, N, H, seg, scale2);
  return cudaGetLastError();
}

}  // namespace attn_seg_f32
}  // namespace vq

// q [B, N, H*D], k/v [B, M, H*D], out [B, N, H*D], all f32 and 16-byte
// aligned; mask [B, M] int32 or null; seg > 0: block-diagonal in segments
// of seg tokens (M == N, N % seg == 0, no mask). scale2 = scale * log2(e).
VQ_EXPORT int vq_attention_f32(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int N,
                               int M, int H, int D, int seg, float scale2,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  if (seg == 0)
    return static_cast<int>(vq::attn_f32::launch_core_any(
        qp, kp, vp, static_cast<const int*>(mask), op, B, N, M, H, D,
        scale2, st));
  if (seg < 0 || M != N || N % seg != 0 || mask != nullptr || B <= 0 ||
      N <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 16:
      err = vq::attn_seg_f32::launch<16>(qp, kp, vp, op, B, N, H, seg, scale2,
                                         st);
      break;
    case 72:
      err = vq::attn_seg_f32::launch<72>(qp, kp, vp, op, B, N, H, seg, scale2,
                                         st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
