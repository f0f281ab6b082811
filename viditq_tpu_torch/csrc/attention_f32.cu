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
// The products of the bf16-rounded operands are exact in f32, so q.k is the
// bf16 mode's; the softmax and the PV stay f32 (no rounding of e or v). The
// plain version normalises e before the PV (e * (1/r)); the kernel scales
// the f32 sum once per output, a difference of f32 rounding only.
//
// Modes: full (every kv row), kv-masked (mask [B, M] int32, 1 = attend:
// masked rows score -inf) and seg (block-diagonal: a q row attends to the kv
// rows of its own segment of `seg` tokens; k/v co-indexed with q).
//
// Design: a simple kernel on the CUDA cores. A block owns 64 q rows of one
// (batch row, head): 256 threads as 16 x 16, a thread 4 q rows (ty + 16 i)
// by 4 kv columns (tx + 16 j) of each 64-row kv tile, and 4 rows by
// ceil(D / 16) output channels (tx + 16 j). q (pre-scaled, rounded to bf16)
// sits in shared memory for the block's life; k (rounded to bf16) and v
// tiles are staged per tile. Two passes over the block's kv range: the row
// max, then exp2, the row sum and the PV (the probabilities of a tile
// staged in shared memory where the k tile was). The 16 threads of a row
// are one half-warp, so the row max and sum reduce by shuffles. In seg mode
// the kv range of a block is the segments its rows belong to (one tile at
// seg 16), and scores across segments are -inf. Bound on the card:
// operations, 4*N*M*D per (b, h) on the f32 CUDA cores at the spatial site
// (N = M = 1024), bytes at the seg and cross sites.

#include "common.cuh"

namespace vq {
namespace attn_f32 {

constexpr int BQ = 64;       // q rows per block
constexpr int BKV = 64;      // kv rows per tile
constexpr int THREADS = 256;

template <int D>
struct Smem {
  static constexpr int KP = (D + 1 > BKV + 1) ? D + 1 : BKV + 1;  // k or p
  static constexpr int FLOATS = BQ * D + BKV * KP + BKV * D;
  static constexpr int BYTES = FLOATS * 4 + BKV * 4;               // + mask
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const int* __restrict__ mask,
                float* __restrict__ out, int N, int M, int H, int seg,
                float scale2) {
  constexpr int KP = Smem<D>::KP;
  constexpr int DJ = (D + 15) / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D]
  float* Ks = Qs + BQ * D;          // [BKV][KP]; the probabilities [BKV][KP]
  float* Vs = Ks + BKV * KP;        // [BKV][D]
  int* Ms = reinterpret_cast<int*>(Vs + BKV * D);  // [BKV] valid kv rows

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const float* qb = q + (static_cast<size_t>(b) * N) * C + h * D;
  const float* kb = k + (static_cast<size_t>(b) * M) * C + h * D;
  const float* vb = v + (static_cast<size_t>(b) * M) * C + h * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int n = n0 + r;
    Qs[i] = n < N ? bf16_round(qb[static_cast<size_t>(n) * C + d] * scale2)
                  : 0.0f;
  }
  // the block's kv range: all of it, or the segments of its rows
  int kv_lo = 0, kv_hi = M;
  if (seg > 0) {
    const int last = min(n0 + BQ, N) - 1;
    kv_lo = (n0 / seg) * seg;
    kv_hi = min(N, (last / seg + 1) * seg);
  }

  // stage k tile t (and v and the valid flags): rows past kv_hi are zero
  auto load_tile = [&](int t0, bool with_v) {
    for (int i = tid; i < BKV * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int m = t0 + r;
      const bool in = m < kv_hi;
      Ks[r * KP + d] =
          in ? bf16_round(kb[static_cast<size_t>(m) * C + d]) : 0.0f;
      if (with_v) Vs[i] = in ? vb[static_cast<size_t>(m) * C + d] : 0.0f;
    }
    for (int r = tid; r < BKV; r += THREADS) {
      const int m = t0 + r;
      Ms[r] = m < kv_hi && (mask == nullptr ||
                            mask[static_cast<size_t>(b) * M + m] != 0);
    }
  };
  // this thread's 4 x 4 scores of the staged tile; -inf where masked
  auto scores = [&](int t0, float (&s)[4][4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const bool ok = Ms[c] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool same = seg == 0 ||
                          (n0 + ty + 16 * i) / seg == (t0 + c) / seg;
        if (!(ok && same)) s[i][j] = -INFINITY;
      }
    }
  };

  // pass 1: the row max
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int t0 = kv_lo; t0 < kv_hi; t0 += BKV) {
    __syncthreads();
    load_tile(t0, false);
    __syncthreads();
    float s[4][4];
    scores(t0, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[i] = fmaxf(mx[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));

  // pass 2: e = exp2(s - m), the row sum and the PV
  float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  for (int t0 = kv_lo; t0 < kv_hi; t0 += BKV) {
    __syncthreads();
    load_tile(t0, true);
    __syncthreads();
    float s[4][4];
    scores(t0, s);
    __syncthreads();  // every thread is done with the k tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f(s[i][j] - mx[i]);
        r[i] += e;
        Ks[(ty + 16 * i) * KP + tx + 16 * j] = e;
      }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ks[(ty + 16 * i) * KP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (D % 16 == 0 || d < D) {
          const float vv = Vs[c * D + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = __fmaf_rn(p[i], vv, acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      r[i] += __shfl_xor_sync(0xffffffffu, r[i], o);

  float* ob = out + (static_cast<size_t>(b) * N) * C + h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty + 16 * i;
    if (n >= N) continue;
    const float inv = 1.0f / r[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (D % 16 == 0 || d < D)
        ob[static_cast<size_t>(n) * C + d] = acc[i][j] * inv;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* mask, float* out, int B, int N, int M, int H,
                   int seg, float scale2, cudaStream_t st) {
  auto kernel = attn_f32_kernel<D>;
  const int smem = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, st>>>(q, k, v, mask, out, N, M, H, seg,
                                      scale2);
  return cudaGetLastError();
}

}  // namespace attn_f32
}  // namespace vq

// q [B, N, H*D], k/v [B, M, H*D], out [B, N, H*D], all f32; mask [B, M]
// int32 or null; seg > 0: block-diagonal in segments of seg tokens (M == N,
// no mask). scale2 = scale * log2(e).
VQ_EXPORT int vq_attention_f32(const void* q, const void* k, const void* v,
                               const void* mask, void* out, int B, int N,
                               int M, int H, int D, int seg, float scale2,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const int* mp = static_cast<const int*>(mask);
  float* op = static_cast<float*>(out);
  if (seg > 0 && (M != N || mask != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 16:
      err = vq::attn_f32::launch<16>(qp, kp, vp, mp, op, B, N, M, H, seg,
                                     scale2, st);
      break;
    case 72:
      err = vq::attn_f32::launch<72>(qp, kp, vp, mp, op, B, N, M, H, seg,
                                     scale2, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
