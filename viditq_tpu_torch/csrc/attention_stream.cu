// K6: kv-streaming (online-softmax) attention over [B, N, H*D] for kv
// lengths above the one-shot range (PixArt-Σ 1024 self-attention: N = M =
// 4096, 16 heads of 72), full or kv-masked, with a bf16 PV or the int8 PV.
//
// Replaces the TPU kernel `_attn_stream_kernel` (viditq_tpu/kernels/
// attention.py:236-368, dispatched at :643-714). Per (b, h, q row), for
// each kv block of exactly `bkv` rows (the numerics rule `stream_kv_block`):
//   s      = bf16(q * scale*log2e) . bf16(k)  (+ -inf where masked; f32 sums)
//   m_new  = max(m_old, rowmax(s over the whole block))
//   m_safe = m_new, or 0 while the row is fully masked
//   e      = exp2(s - m_safe);  corr = exp2(m_old - m_safe)
//   r      = r * corr + sum(e)
//   bf16 PV: pv = sum(bf16(e) * v)                              (f32)
//   int8 PV: pv = float(sum(round(e*127) * vq)) * (vs * (1/127^2))
//   acc    = acc * corr + pv
// and at the end o = acc * (1 / max(r, 1e-30)), written in bf16. The int8
// codes round against the RUNNING max (C3), so the max must be the whole
// block's, not a 64-row tile's: the kernel walks each block twice, once
// over QK^T for the block's row max and once for e, the row sum and PV.
// Emission is not done here: the wrapper quantizes the bf16 output with
// K4, as the JAX package does (attention.py:705-713).
//
// Bound on the card: tensor-core compute (4*B*H*N*M*D flops; at Σ-1024
// 154.6 GFLOP against 75 MB of q/k/v/o, about 0.16 ms at 989 TFLOP/s),
// plus B*H*N*M exp2, here computed once (scores are computed twice).
// Design (simple first): one block of 4 warps per (64 q rows, head,
// batch); each warp owns 16 q rows with q in registers; k (and v,
// transposed) tiles of 64 rows go through shared memory; QK^T and the bf16
// PV run on mma.sync m16n8k16 bf16 (f32 sums, D padded to a multiple of 16
// with zeros), the int8 PV on mma.sync m16n8k32 s8 with exact int32 sums
// per block. The s8 A operand comes straight from the QK^T accumulators:
// a thread's score columns are not the k32 fragment's, so the contraction
// index is permuted (a sum over kv rows does not depend on their order)
// and v is read from shared memory under the same permutation. D is a
// template parameter: 72 (PixArt/STDiT-XL) and 16 (the tiny models).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // q rows per block: 4 warps x 16
constexpr int TK = 64;  // kv rows per shared-memory tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two int8 pairs (each two adjacent bytes) -> one 4-byte operand register
__device__ __forceinline__ uint32_t ld_pairs(const int8_t* lo,
                                             const int8_t* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi))
          << 16);
}

// softmax codes round(e*127) in 0..127, lowest k index in the lowest byte
__device__ __forceinline__ uint32_t codes4(float e0, float e1, float e2,
                                           float e3) {
  return static_cast<uint32_t>(static_cast<int>(rintf(e0 * 127.0f))) |
         (static_cast<uint32_t>(static_cast<int>(rintf(e1 * 127.0f))) << 8) |
         (static_cast<uint32_t>(static_cast<int>(rintf(e2 * 127.0f))) << 16) |
         (static_cast<uint32_t>(static_cast<int>(rintf(e3 * 127.0f))) << 24);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, bool INT8>
__global__ void __launch_bounds__(128)
    attn_stream_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const void* __restrict__ v,
                       const float* __restrict__ vscale,
                       const int* __restrict__ mask,
                       __nv_bfloat16* __restrict__ out, int N, int M, int H,
                       int bkv, float scale2) {
  constexpr int DP = (D + 15) / 16 * 16;  // QK contraction, zero padded
  constexpr int KS = DP / 16;             // k16 steps of QK^T
  constexpr int NT = (D + 7) / 8;         // n8 tiles of the PV output
  constexpr int DV = NT * 8;
  constexpr int LDK = DP + 8;             // bf16 row strides (bank spread)
  constexpr int LDV = TK + 8;             // bf16 v^T row stride
  constexpr int LDV8 = TK + 16;           // int8 v^T row stride (bytes)
  constexpr int VBYTES = INT8 ? DV * LDV8 : DV * LDV * 2;
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LDK];
  __shared__ __align__(16) __nv_bfloat16 Ks[TK * LDK];
  __shared__ __align__(16) unsigned char Vbuf[VBYTES];
  __nv_bfloat16* Vt = reinterpret_cast<__nv_bfloat16*>(Vbuf);
  int8_t* Vt8 = reinterpret_cast<int8_t*>(Vbuf);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int C = H * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + g;  // accumulator rows g and g+8
  const int rows[2] = {row_lo, row_lo + 8};

  for (int idx = tid; idx < BQ * DP; idx += 128) {
    const int r = idx / DP;
    const int d = idx - r * DP;
    const int n = q0 + r;
    float val = 0.0f;
    if (n < N && d < D) {
      const float qf =
          __bfloat162float(q[(static_cast<size_t>(b) * N + n) * C + h * D + d]);
      val = qf * scale2;
    }
    Qs[r * LDK + d] = __float2bfloat16_rn(val);
  }
  __syncthreads();
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const __nv_bfloat16* p = Qs + (warp * 16 + g) * LDK + ks * 16 + t * 2;
    qa[ks][0] = ld32(p);
    qa[ks][1] = ld32(p + 8 * LDK);
    qa[ks][2] = ld32(p + 8);
    qa[ks][3] = ld32(p + 8 * LDK + 8);
  }

  // int8 PV: the dequant factor vs * (1/127^2) of this thread's columns
  float vsd[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = nt * 8 + t * 2 + j;
      vsd[nt][j] = 0.0f;
      if (INT8 && d < D)
        vsd[nt][j] = vscale[static_cast<size_t>(b) * C + h * D + d] *
                     static_cast<float>(1.0 / (127.0 * 127.0));
    }

  auto load_k = [&](int kv0) {
    for (int idx = tid; idx < TK * DP; idx += 128) {
      const int c = idx / DP;
      const int d = idx - c * DP;
      Ks[c * LDK + d] =
          d < D ? k[(static_cast<size_t>(b) * M + kv0 + c) * C + h * D + d]
                : __float2bfloat16_rn(0.0f);
    }
  };
  auto load_v = [&](int kv0) {
    for (int idx = tid; idx < TK * DV; idx += 128) {
      const int c = idx / DV;
      const int d = idx - c * DV;
      const size_t gi = (static_cast<size_t>(b) * M + kv0 + c) * C + h * D + d;
      if constexpr (INT8)
        Vt8[d * LDV8 + c] = d < D ? static_cast<const int8_t*>(v)[gi] : 0;
      else
        Vt[d * LDV + c] = d < D ? static_cast<const __nv_bfloat16*>(v)[gi]
                                : __float2bfloat16_rn(0.0f);
    }
  };
  // s[nt][e]: row rows[e >> 1], column kv0 + nt*8 + t*2 + (e & 1)
  auto scores = [&](int kv0, float (&s)[TK / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDK + t * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(kp + ks * 16), ld32(kp + ks * 16 + 8));
      if (mask != nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kv0 + nt * 8 + t * 2 + (e & 1);
          if (mask[static_cast<size_t>(b) * M + col] == 0) s[nt][e] = -INFINITY;
        }
      }
    }
  };

  float m_run[2] = {-INFINITY, -INFINITY};
  float r_run[2] = {0.0f, 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  for (int kb = 0; kb < M; kb += bkv) {
    // pass 1: the row max over the whole kv block
    float bm[2] = {-INFINITY, -INFINITY};
    for (int kv0 = kb; kv0 < kb + bkv; kv0 += TK) {
      __syncthreads();
      load_k(kv0);
      __syncthreads();
      float s[TK / 8][4];
      scores(kv0, s);
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          bm[hh] = fmaxf(bm[hh], fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
    }
    float m_new[2], m_safe[2], corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_new[hh] = fmaxf(m_run[hh], quad_max(bm[hh]));
      m_safe[hh] = m_new[hh] == -INFINITY ? 0.0f : m_new[hh];
      corr[hh] = exp2f(m_run[hh] - m_safe[hh]);
    }

    // pass 2: e, its row sum and the block's PV
    float rs[2] = {0.0f, 0.0f};
    float pv[NT][4];
    int pvi[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[nt][e] = 0.0f;
        pvi[nt][e] = 0;
      }
    for (int kv0 = kb; kv0 < kb + bkv; kv0 += TK) {
      __syncthreads();
      load_k(kv0);
      load_v(kv0);
      __syncthreads();
      float s[TK / 8][4];
      scores(kv0, s);
#pragma unroll
      for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - m_safe[e >> 1]);
          rs[e >> 1] += s[nt][e];
        }
      if constexpr (INT8) {
        // k32 chunk c: fragment k index t*4+j (+16) holds kv column
        // c*32 + {t*2, t*2+1, 8+t*2, 8+t*2+1}[j] (+16)
#pragma unroll
        for (int ch = 0; ch < TK / 32; ++ch) {
          const int n0 = ch * 4;
          const uint32_t pa[4] = {
              codes4(s[n0][0], s[n0][1], s[n0 + 1][0], s[n0 + 1][1]),
              codes4(s[n0][2], s[n0][3], s[n0 + 1][2], s[n0 + 1][3]),
              codes4(s[n0 + 2][0], s[n0 + 2][1], s[n0 + 3][0], s[n0 + 3][1]),
              codes4(s[n0 + 2][2], s[n0 + 2][3], s[n0 + 3][2], s[n0 + 3][3])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int8_t* vp = Vt8 + (nt * 8 + g) * LDV8 + ch * 32 + t * 2;
            mma_s8(pvi[nt], pa, ld_pairs(vp, vp + 8),
                   ld_pairs(vp + 16, vp + 24));
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                  pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                  pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                  pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* vp = Vt + (nt * 8 + g) * LDV + kk * 16 + t * 2;
            mma_bf16(pv[nt], pa, ld32(vp), ld32(vp + 8));
          }
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      r_run[hh] = r_run[hh] * corr[hh] + quad_sum(rs[hh]);
      m_run[hh] = m_new[hh];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = INT8 ? static_cast<float>(pvi[nt][e]) * vsd[nt][e & 1]
                             : pv[nt][e];
        acc[nt][e] = acc[nt][e] * corr[e >> 1] + p;
      }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = rows[hh];
    if (n >= N) continue;
    const float inv = 1.0f / fmaxf(r_run[hh], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = nt * 8 + t * 2 + j;
        if (d >= D) continue;
        out[(static_cast<size_t>(b) * N + n) * C + h * D + d] =
            __float2bfloat16_rn(acc[nt][2 * hh + j] * inv);
      }
  }
}

template <int D>
cudaError_t launch_stream(const void* q, const void* k, const void* v,
                          const float* vs, const int* mask, void* out, int B,
                          int N, int M, int H, int bkv, float scale2,
                          int int8_pv, cudaStream_t st) {
  dim3 grid((N + BQ - 1) / BQ, H, B);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (int8_pv)
    attn_stream_kernel<D, true><<<grid, 128, 0, st>>>(qp, kp, v, vs, mask, op,
                                                      N, M, H, bkv, scale2);
  else
    attn_stream_kernel<D, false><<<grid, 128, 0, st>>>(qp, kp, v, vs, mask, op,
                                                       N, M, H, bkv, scale2);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, H*D], k [B, M, H*D] bf16; v bf16, or (int8_pv) int8 codes from
// vq_attn_vquant at vgroup = M with scales vs [B, 1, H*D]; mask [B, M]
// int32 or null; out [B, N, H*D] bf16. D in {16, 72}; bkv a multiple of 64
// dividing M.
VQ_EXPORT int vq_attention_stream(const void* q, const void* k, const void* v,
                                  const void* vs, const void* mask, void* out,
                                  int B, int N, int M, int H, int D, int bkv,
                                  float scale2, int int8_pv, void* stream) {
  if (bkv <= 0 || bkv % TK != 0 || M % bkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const int* mp = static_cast<const int*>(mask);
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch_stream<16>(q, k, v, vsp, mp, out, B, N, M, H, bkv, scale2,
                              int8_pv, st);
      break;
    case 72:
      err = launch_stream<72>(q, k, v, vsp, mp, out, B, N, M, H, bkv, scale2,
                              int8_pv, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
