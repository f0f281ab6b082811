// K6 in float32: the kv-streaming (online-softmax) attention for f32 q/k/v
// and an f32 output, full or kv-masked: the float32 block of AdaRound
// reconstruction at kv lengths above the one-shot range (PixArt-Σ 1024's
// self-attention in blocks 0-13, N = M = 4096, 16 heads of 72;
// viditq_tpu/quant/reconstruction.py:431-461).
//
// Replaces the TPU kernel `_attn_stream_kernel` (viditq_tpu/kernels/
// attention.py:236-368, launched at :699) when its inputs are f32. Per
// (b, h, q row) the recurrence of that kernel in f32 (:287-291, :328-330,
// :343-346) and of the port's plain version (kernels/attention.py
// `attention_bnhd_stream_plain`):
//   s      = bf16(q * scale*log2e) . bf16(k)  (+ -inf where masked; f32 sums)
//   m_new  = max(m_old, rowmax(s));  m_safe = m_new, or 0 while the row is
//            fully masked
//   e      = exp2(s - m_safe);  corr = exp2(m_old - m_safe)
//   r      = r * corr + sum(e);  acc = acc * corr + sum(e * v)   (all f32)
// and at the end o = acc * (1 / max(r, 1e-30)). In float32 nothing is
// rounded against the running max (e and v stay f32), so the kv block that
// fixes the bf16 mode's numerics (C3) only moves f32 rounding here: the
// kernel updates the running max once per 64-row kv tile, in one pass, and
// takes no `bkv`.
//
// Design: a block owns 64 q rows of one (batch row, head), 16 a warp.
// q.k runs on the tensor cores: the operands are bf16-rounded by
// definition, so mma.sync m16n8k16 bf16 with f32 accumulation computes the
// same products (D = 72 padded with zeros to 80, five k16 steps); a warp
// keeps its 16 rows' q fragments in registers for the block's life. k (as
// bf16) and v (f32) tiles of 64 rows are staged in shared memory by all
// threads. The score accumulators give each row's tile max by a quad
// shuffle, then e, the row's partial sum and its corr; e goes to the warp's
// slice of shared memory. The PV runs as f32 FMAs on the CUDA cores: a lane
// holds 4 rows x D/8 output channels (rows rg + 4i, channels cg + 8j: the
// probabilities are read 4 distinct words at a time, v's row as D/8
// consecutive words, no bank conflict), rescaled by the row's corr before
// the tile's products are added.
//
// Bound on the card: operations. At Σ's shape q.k is 77.3 GFLOP of bf16
// (0.08 ms at 989 TFLOP/s) and the PV 77.3 GFLOP of f32 (1.15 ms at 67
// TFLOP/s): 1.23 ms; q/k/v/o are 151 MB (0.05 ms). The PV's shared-memory
// reads (13 words for 36 FMAs a lane) bound this design at about 70% of
// the f32 rate.

#include "common.cuh"

namespace vq {
namespace attn_stream_f32 {

constexpr int WARPS = 4;
constexpr int BQ = 16 * WARPS;    // q rows per block: 16 a warp
constexpr int BKV = 64;           // kv rows per tile
constexpr int THREADS = 32 * WARPS;
constexpr int PSTRIDE = BKV + 4;  // floats per row of a warp's e slice

template <int D>
struct Cfg {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int KP = (D + 15) / 16 * 16;  // D padded to k16 steps
  static constexpr int KS = KP / 16;
  static constexpr int KSTRIDE = KP + 8;  // bf16 a staged k row (no conflict)
  static constexpr int DJ = D / 8;        // output channels a lane
  static constexpr int K_BYTES = BKV * KSTRIDE * 2;
  static constexpr int V_BYTES = BKV * D * 4;
  static constexpr int P_BYTES = WARPS * 16 * PSTRIDE * 4;
  static constexpr int ROW_BYTES = WARPS * 16 * 4;  // a row's corr, then r
  static constexpr int BYTES =
      K_BYTES + V_BYTES + P_BYTES + ROW_BYTES + BKV * 4;  // + valid flags
};

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    attn_stream_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ mask,
                           float* __restrict__ out, int N, int M, int H,
                           float scale2) {
  using T = Cfg<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Vs = reinterpret_cast<float*>(smem + T::K_BYTES);
  float* Ps = reinterpret_cast<float*>(smem + T::K_BYTES + T::V_BYTES);
  float* Rs = Ps + WARPS * 16 * PSTRIDE;
  int* Ms = reinterpret_cast<int*>(Rs + WARPS * 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row, column
  const int rg = lane >> 3, cg = lane & 7;  // the PV's rows, channels
  const int n0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const float* qb = q + static_cast<size_t>(b) * N * C + h * D;
  const float* kb = k + static_cast<size_t>(b) * M * C + h * D;
  const float* vb = v + static_cast<size_t>(b) * M * C + h * D;
  float* Pw = Ps + warp * 16 * PSTRIDE;
  float* Rw = Rs + warp * 16;

  // k's pad columns D..KP-1 stay zero (the staging writes columns < D)
  if constexpr (T::KP > D) {
    constexpr int PAD = T::KP - D;
    for (int i = tid; i < BKV * PAD; i += THREADS)
      Ks[(i / PAD) * T::KSTRIDE + D + i % PAD] = __float2bfloat16(0.0f);
  }

  // the warp's q fragments: rows n0 + 16 warp + g (+ 8), bf16(q * scale2),
  // zero past D and N; a[0..3] = (row, k), (row + 8, k), (row, k + 8),
  // (row + 8, k + 8) at k = 16 kk + 2 t4
  uint32_t qa[T::KS][4];
#pragma unroll
  for (int kk = 0; kk < T::KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + warp * 16 + g + (i & 1) * 8;
      const int d = kk * 16 + 2 * t4 + (i >> 1) * 8;
      float x0 = 0.0f, x1 = 0.0f;
      if (row < N && d < D) {
        const float* p = qb + static_cast<size_t>(row) * C + d;
        x0 = p[0] * scale2;
        x1 = p[1] * scale2;
      }
      qa[kk][i] = bf16x2(x0, x1);
    }

  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float r_part[2] = {0.0f, 0.0f};           // this lane's columns' share
  float acc[4][T::DJ];                      // rows rg + 4i, channels cg + 8j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < T::DJ; ++j) acc[i][j] = 0.0f;

  for (int t0 = 0; t0 < M; t0 += BKV) {
    __syncthreads();  // every warp is done with the last tile
    for (int i = tid; i < BKV * (D / 4); i += THREADS) {
      const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
      const int m = t0 + r;
      float4 kv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = kv;
      if (m < M) {
        kv = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(m) * C +
                                              c4);
        vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(m) * C +
                                              c4);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + r * T::KSTRIDE + c4);
      kd[0] = bf16x2(kv.x, kv.y);
      kd[1] = bf16x2(kv.z, kv.w);
      *reinterpret_cast<float4*>(Vs + r * D + c4) = vv;
    }
    for (int r = tid; r < BKV; r += THREADS) {
      const int m = t0 + r;
      Ms[r] = m < M && (mask == nullptr ||
                        mask[static_cast<size_t>(b) * M + m] != 0);
    }
    __syncthreads();

    // scores: s[nt][e] is row g + 8 (e >> 1), column 8 nt + 2 t4 + (e & 1)
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk)
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        const __nv_bfloat16* kp =
            Ks + (nt * 8 + g) * T::KSTRIDE + kk * 16 + 2 * t4;
        mma_bf16(s[nt], qa[kk], ld32(kp), ld32(kp + 8));
      }

    // the online softmax of rows g and g + 8 over this tile
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float& x = s[nt][2 * hh + e2];
          if (!Ms[nt * 8 + 2 * t4 + e2]) x = -INFINITY;
          tm = fmaxf(tm, x);
        }
      const float m_new = fmaxf(m_run[hh], quad_max(tm));
      // rows masked so far keep m = -inf; exp2(-inf - 0) is exactly 0
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float corr = exp2f(m_run[hh] - m_safe);
      float part = 0.0f;
      float* prow = Pw + (g + 8 * hh) * PSTRIDE + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float e = exp2f(s[nt][2 * hh + e2] - m_safe);
          part += e;
          prow[nt * 8 + e2] = e;
        }
      r_part[hh] = r_part[hh] * corr + part;
      m_run[hh] = m_new;
      if (t4 == 0) Rw[g + 8 * hh] = corr;
    }
    __syncwarp();

    // acc = acc * corr + sum over the tile of e * v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = Rw[rg + 4 * i];
#pragma unroll
      for (int j = 0; j < T::DJ; ++j) acc[i][j] = acc[i][j] * corr;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Pw[(rg + 4 * i) * PSTRIDE + c];
#pragma unroll
      for (int j = 0; j < T::DJ; ++j) {
        const float vv = Vs[c * D + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(p[i], vv, acc[i][j]);
      }
    }
  }

  // o = acc * (1 / max(r, 1e-30))
  __syncwarp();  // every lane has read its rows' corr
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float r = quad_sum(r_part[hh]);
    if (t4 == 0) Rw[g + 8 * hh] = r;
  }
  __syncwarp();
  float* ob = out + static_cast<size_t>(b) * N * C + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + warp * 16 + rg + 4 * i;
    if (n >= N) continue;
    const float inv = 1.0f / fmaxf(Rw[rg + 4 * i], 1e-30f);
#pragma unroll
    for (int j = 0; j < T::DJ; ++j)
      ob[static_cast<size_t>(n) * C + cg + 8 * j] = acc[i][j] * inv;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* mask, float* out, int B, int N, int M, int H,
                   float scale2, cudaStream_t st) {
  auto kernel = attn_stream_f32_kernel<D>;
  const int smem = Cfg<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, st>>>(q, k, v, mask, out, N, M, H, scale2);
  return cudaGetLastError();
}

}  // namespace attn_stream_f32
}  // namespace vq

// q [B, N, H*D], k/v [B, M, H*D], out [B, N, H*D], all f32 and 16-byte
// aligned; mask [B, M] int32 (1 = attend) or null; scale2 = scale * log2(e).
VQ_EXPORT int vq_attention_stream_f32(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int B, int N, int M, int H,
                                      int D, float scale2, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const int* mp = static_cast<const int*>(mask);
  float* op = static_cast<float*>(out);
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 16:
      err = vq::attn_stream_f32::launch<16>(qp, kp, vp, mp, op, B, N, M, H,
                                            scale2, st);
      break;
    case 72:
      err = vq::attn_stream_f32::launch<72>(qp, kp, vp, mp, op, B, N, M, H,
                                            scale2, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
