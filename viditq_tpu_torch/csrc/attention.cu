// K3: layout-native attention over [B, N, H*D] with an f32 base-2 softmax:
// block-diagonal (seg_len), full, and kv-masked modes; a bf16 PV or the
// int8 PV (round(e*127) codes x per-channel int8 v); optional int8 row
// emission of the output across all heads.
//
// Replaces the TPU kernel `_attn_kernel` behind `attention_bnhd` /
// `attention_bnhd_int8out` (viditq_tpu/kernels/attention.py:80-234,
// dispatch :599-785). Per (b, h, q row):
//   s = bf16(q * scale*log2e) . bf16(k)        (f32 sums)
//   m = rowmax(s); e = exp2(s - m); r = sum(e)
//   bf16 PV: o = sum(bf16(e * (1/r)) * v)
//   int8 PV: o = float(sum(round(e*127) * vq)) * ((1/127^2) / r) * vs
// The int8 codes round against the FULL row max (C3), so the kernel makes
// two passes over the kv range: the first finds the exact row max (and the
// row sum, online), the second recomputes s and runs the PV. The v codes
// and their per-(group x channel) scales come from vquant_kernel: one group
// of v_block tokens in seg mode (C2), the whole kv axis otherwise.
// Emission writes f32 rows to scratch and row_quant_kernel quantizes each
// row with the attention site's own form (C6):
//   smax = max(absmax, 1e-6); scale = smax/127; codes = round(o * (127/smax))
//
// Bound on the card: tensor-core compute at the spatial site (N = M = 1024,
// D = 72: three 16x1024x72 products per row block and head, two for the
// passes' scores and one for PV) plus the exp2 of every score, twice.
// Design: one block of 4 warps per (64 q rows, head, batch); each warp owns
// 16 q rows and runs mma.sync m16n8k16 bf16 with f32 sums for QK^T (q held
// in registers, k tiles of 64 rows in shared memory, D padded to a multiple
// of 16 with zeros) and for PV, whose A operand is the probability tile
// taken straight from the QK^T accumulators (the flash-attention register
// reuse) and whose B operand is v staged transposed in shared memory. The
// int8 PV runs on the same bf16 mma: codes 0..127 and -127..127 are exact
// in bf16, their products exact in f32, and every partial sum an integer
// below 2^24 while the kv range is at most 1040 tokens, so the sums equal
// the int32 PV's. D is a template parameter: 72 (STDiT-XL) and 16 (the tiny
// reference model).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // q rows per block: 4 warps x 16
constexpr int BKV = 64;  // kv rows per tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D, bool INT8>
__global__ void __launch_bounds__(128)
    attn_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const void* __restrict__ v, const float* __restrict__ vscale,
                int vgroup, int n_vgroups, const int* __restrict__ mask,
                void* __restrict__ out, int out_f32, int N, int M, int H,
                int seg, float scale2) {
  constexpr int DP = (D + 15) / 16 * 16;  // QK contraction, zero padded
  constexpr int KS = DP / 16;             // k16 steps of QK^T
  constexpr int NT = (D + 7) / 8;         // n8 tiles of the PV output
  constexpr int DV = NT * 8;
  constexpr int LDK = DP + 8;             // bf16 row strides (bank spread)
  constexpr int LDV = BKV + 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[BQ * LDK];
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[DV * LDV];

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

  int lo = 0, hi = M;
  if (seg > 0) {
    const int qlast = min(q0 + BQ, N) - 1;
    lo = (q0 / seg) * seg;
    hi = min(N, (qlast / seg + 1) * seg);
  }

  auto load_k = [&](int kv0) {
    for (int idx = tid; idx < BKV * DP; idx += 128) {
      const int c = idx / DP;
      const int d = idx - c * DP;
      const int n = kv0 + c;
      Ks[c * LDK + d] =
          (n < hi && d < D)
              ? k[(static_cast<size_t>(b) * M + n) * C + h * D + d]
              : __float2bfloat16_rn(0.0f);
    }
  };
  // s[nt][e]: row rows[e >> 1], column kv0 + nt*8 + t*2 + (e & 1)
  auto scores = [&](int kv0, float (&s)[BKV / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const __nv_bfloat16* kp = Ks + (nt * 8 + g) * LDK + t * 2;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(s[nt], qa[ks], ld32(kp + ks * 16), ld32(kp + ks * 16 + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + nt * 8 + t * 2 + (e & 1);
        const int row = rows[e >> 1];
        bool ok = col < hi;
        if (ok && seg > 0) ok = (row / seg) == (col / seg);
        if (ok && mask != nullptr)
          ok = mask[static_cast<size_t>(b) * M + col] != 0;
        if (!ok) s[nt][e] = -INFINITY;
      }
    }
  };

  // pass 1: exact row max, online row sum (rows are shared by a lane quad)
  float m_run[2] = {-INFINITY, -INFINITY};
  float r_run[2] = {0.0f, 0.0f};
  for (int kv0 = lo; kv0 < hi; kv0 += BKV) {
    __syncthreads();
    load_k(kv0);
    __syncthreads();
    float s[BKV / 8][4];
    scores(kv0, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
        tm = fmaxf(tm, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
      const float m_new = fmaxf(m_run[hh], tm);
      float part = 0.0f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int nt = 0; nt < BKV / 8; ++nt)
          part += exp2f(s[nt][2 * hh] - m_new) + exp2f(s[nt][2 * hh + 1] - m_new);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (m_new != -INFINITY) {
        r_run[hh] = r_run[hh] * exp2f(m_run[hh] - m_new) + part;
        m_run[hh] = m_new;
      }
    }
  }
  const float inv_r[2] = {1.0f / r_run[0], 1.0f / r_run[1]};

  // pass 2: probabilities (or softmax codes) and the PV product
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  for (int kv0 = lo; kv0 < hi; kv0 += BKV) {
    __syncthreads();
    load_k(kv0);
    for (int idx = tid; idx < BKV * DV; idx += 128) {
      const int c = idx / DV;
      const int d = idx - c * DV;
      const int n = kv0 + c;
      float val = 0.0f;
      if (n < hi && d < D) {
        const size_t gi = (static_cast<size_t>(b) * M + n) * C + h * D + d;
        if constexpr (INT8)
          val = static_cast<float>(static_cast<const int8_t*>(v)[gi]);
        else
          val = __bfloat162float(static_cast<const __nv_bfloat16*>(v)[gi]);
      }
      Vt[d * LDV + c] = __float2bfloat16_rn(val);
    }
    __syncthreads();
    float s[BKV / 8][4];
    scores(kv0, s);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ex = exp2f(s[2 * kk + j][e] - m_run[e >> 1]);
          p[j][e] = INT8 ? rintf(ex * 127.0f) : ex * inv_r[e >> 1];
        }
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                              pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]),
                              pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* vp = Vt + (nt * 8 + g) * LDV + kk * 16 + t * 2;
        mma_bf16(o[nt], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = rows[hh];
    if (n >= N) continue;
    const float tq = static_cast<float>(1.0 / (127.0 * 127.0)) / r_run[hh];
    const int grp = seg > 0 ? n / vgroup : 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = nt * 8 + t * 2 + j;
        if (d >= D) continue;
        float val = o[nt][2 * hh + j];
        if constexpr (INT8)
          val = (val * tq) *
                vscale[(static_cast<size_t>(b) * n_vgroups + grp) * C + h * D + d];
        const size_t oi = (static_cast<size_t>(b) * N + n) * C + h * D + d;
        if (out_f32)
          static_cast<float*>(out)[oi] = val;
        else
          static_cast<__nv_bfloat16*>(out)[oi] = __float2bfloat16_rn(val);
      }
  }
}

// Per (b, group, channel): vs = max(absmax over the group's vgroup tokens,
// 1e-6); codes = round(v * (127/vs)) (attention.py:176-180, :636-642).
__global__ void vquant_kernel(const __nv_bfloat16* __restrict__ v,
                              int8_t* __restrict__ vq,
                              float* __restrict__ vs, int B, int M, int C,
                              int vgroup) {
  const int G = M / vgroup;
  const size_t item = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= static_cast<size_t>(B) * G * C) return;
  const int c = static_cast<int>(item % C);
  const int bg = static_cast<int>(item / C);
  const int b = bg / G;
  const int grp = bg % G;
  const size_t base = (static_cast<size_t>(b) * M + static_cast<size_t>(grp) * vgroup) * C + c;
  float am = 0.0f;
  for (int r = 0; r < vgroup; ++r)
    am = fmaxf(am, fabsf(__bfloat162float(v[base + static_cast<size_t>(r) * C])));
  const float s = fmaxf(am, 1e-6f);
  const float mul = 127.0f / s;
  for (int r = 0; r < vgroup; ++r) {
    const float x = __bfloat162float(v[base + static_cast<size_t>(r) * C]);
    vq[base + static_cast<size_t>(r) * C] =
        static_cast<int8_t>(static_cast<int>(rintf(x * mul)));
  }
  vs[item] = s;
}

// One warp per row of o [rows, C] f32.
__global__ void row_quant_kernel(const float* __restrict__ o,
                                 int8_t* __restrict__ q,
                                 float* __restrict__ scales, int rows, int C) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + static_cast<size_t>(row) * C;
  float am = 0.0f;
  for (int c = lane; c < C; c += 32) am = fmaxf(am, fabsf(orow[c]));
  const float smax = fmaxf(vq::warp_max(am), 1e-6f);
  const float mul = 127.0f / smax;
  int8_t* qr = q + static_cast<size_t>(row) * C;
  for (int c = lane; c < C; c += 32) qr[c] = vq::round_sat_s8(orow[c] * mul);
  if (lane == 0) scales[row] = smax / 127.0f;
}

template <int D>
cudaError_t launch_attn(const void* q, const void* k, const void* v,
                        const float* vs, int vgroup, int n_vgroups,
                        const int* mask, void* out, int out_f32, int B, int N,
                        int M, int H, int seg, float scale2, int int8_pv,
                        cudaStream_t st) {
  dim3 grid((N + BQ - 1) / BQ, H, B);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  if (int8_pv)
    attn_kernel<D, true><<<grid, 128, 0, st>>>(qp, kp, v, vs, vgroup,
                                              n_vgroups, mask, out, out_f32,
                                              N, M, H, seg, scale2);
  else
    attn_kernel<D, false><<<grid, 128, 0, st>>>(qp, kp, v, vs, vgroup,
                                               n_vgroups, mask, out, out_f32,
                                               N, M, H, seg, scale2);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, H*D], k [B, M, H*D] bf16; v bf16, or (int8_pv) int8 codes from
// vq_attn_vquant with scales vs [B, n_vgroups, H*D]; mask [B, M] int32 or
// null; out [B, N, H*D] f32 (out_f32) or bf16. D in {16, 72};
// with int8_pv the kv range of a row is at most 1040 tokens.
VQ_EXPORT int vq_attention(const void* q, const void* k, const void* v,
                           const void* vs, int vgroup, int n_vgroups,
                           const void* mask, void* out, int out_f32, int B,
                           int N, int M, int H, int D, int seg, float scale2,
                           int int8_pv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const int* mp = static_cast<const int*>(mask);
  cudaError_t err;
  switch (D) {
#define VQ_ATTN_CASE(DD)                                                    \
  case DD:                                                                  \
    err = launch_attn<DD>(q, k, v, vsp, vgroup, n_vgroups, mp, out, out_f32, \
                          B, N, M, H, seg, scale2, int8_pv, st);            \
    break;
    VQ_ATTN_CASE(16)
    VQ_ATTN_CASE(72)
#undef VQ_ATTN_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// v [B, M, C] bf16 -> codes [B, M, C] int8, scales [B, M / vgroup, C] f32.
VQ_EXPORT int vq_attn_vquant(const void* v, void* vq, void* vs, int B, int M,
                             int C, int vgroup, void* stream) {
  const size_t items = static_cast<size_t>(B) * (M / vgroup) * C;
  const int threads = 256;
  const int blocks = static_cast<int>((items + threads - 1) / threads);
  vquant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<int8_t*>(vq),
      static_cast<float*>(vs), B, M, C, vgroup);
  return static_cast<int>(cudaGetLastError());
}

// o [rows, C] f32 -> codes [rows, C] int8, scales [rows] f32.
VQ_EXPORT int vq_attn_row_quant(const void* o, void* q, void* scales,
                                int rows, int C, void* stream) {
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  row_quant_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(o), static_cast<int8_t*>(q),
      static_cast<float*>(scales), rows, C);
  return static_cast<int>(cudaGetLastError());
}
