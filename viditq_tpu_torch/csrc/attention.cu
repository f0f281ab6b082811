// K3: layout-native attention over [B, N, H*D] with an f32 base-2 softmax:
// full, kv-masked and block-diagonal (seg_len) modes; a bf16 PV or the int8
// PV (round(e*127) codes x per-channel int8 v); optional int8 row emission
// of the output across all heads.
//
// Replaces the TPU kernel `_attn_kernel` behind `attention_bnhd` /
// `attention_bnhd_int8out` (viditq_tpu/kernels/attention.py:80-234,
// dispatch :599-785). Per (b, h, q row):
//   s = bf16(q * scale*log2e) . bf16(k)        (f32 sums)
//   m = rowmax(s); e = exp2(s - m); r = sum(e)
//   bf16 PV: o = sum(bf16(e * (1/r)) * v)
//   int8 PV: o = float(sum(round(e*127) * vq)) * ((1/127^2) / r) * vs
// The bf16 PV normalizes before the product, so r must be known first, and
// the int8 codes round against the FULL row max (C3): the kernel makes two
// passes over the kv range. bf16 PV: pass 1 is QK^T with the online (max,
// sum), pass 2 QK^T, exp2, normalize and PV. Int8 PV: pass 1 is QK^T and
// the max only, pass 2 exp2, r (summed from that max, as the plain version
// and the JAX kernel write it), codes and PV. A one-pass flash form would
// round each probability against another max (ROADMAP C9). The v codes and
// their per-(group x channel) scales come from a v-quantize pass: one group
// of v_block tokens in seg mode (C2), the whole kv axis otherwise, where
// the codes are stored transposed per head for the s8 wgmma.
// Emission writes f32 rows to scratch and row_quant_kernel quantizes each
// row with the attention site's own forms (C6; attention.py:217-233):
//   sym : smax = max(absmax, 1e-6); scale = smax/127;
//         codes = round(o * (127/smax))
//   asym: `_quantize_rows_f32`'s (common.cuh RowQuant: inv = 1/scale, zp)
// and, where asked for (asym proj weights), the code row sum.
//
// Bound on the card, full modes: at the spatial site (N = M = 1024, D = 72)
// the tensor-core work of three 64x64x80 products per 64 q rows and kv tile
// (0.26 ms at 989 TFLOP/s for [32, 1024, 16, 72]) and two exp2 per score in
// bf16 PV (0.29 ms on the MUFU pipe), one in int8 PV; at the cross sites
// (kv 120 / 300: two to five tiles) the bytes of q and o.
// Design, full modes (attn_kernel_full): the shared core (attn_core.cuh),
// 128 q rows per block in two wgmma warpgroups, k/v tiles of 64 rows
// through a 3-slot cp.async ring (pass 1 streams k only, pass 2 k and v),
// QK^T and PV on wgmma, the kv mask staged per tile, the output staged
// through shared memory and written with 16-byte stores. The int8 PV runs
// on s8 wgmma with exact int32 sums, so its kv range is not bounded.
// Seg mode (attn_kernel_seg, temporal attention, seg 16): a 128-row q tile
// would waste 7/8 of its block-diagonal products, so it keeps the 64-row
// mma.sync kernel: one block of 4 warps per (64 q rows, head, batch), each
// warp 16 q rows in registers, k (and v, transposed) staged per 64-row tile,
// m16n8k16 bf16 products with f32 sums for QK^T (D padded to 16) and PV (A
// operand taken from the QK^T accumulators). Its int8 PV runs on the same
// bf16 mma: codes 0..127 and -127..127 are exact in bf16, their products
// exact in f32, and every partial sum an integer below 2^24 while the kv
// range of a q tile is at most 1040 tokens. D is a template parameter: 72
// (STDiT-XL) and 16 (the tiny reference model).
#include "attn_core.cuh"

namespace {

using namespace vq;
using namespace vq::attn;

// ---------------------------------------------------------------- full modes

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
    attn_kernel_full(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const void* __restrict__ v,
                     const float* __restrict__ vscale,
                     const int* __restrict__ mask, void* __restrict__ out,
                     int out_f32, int N, int M, int H, float scale2) {
  using T = Tile<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* ring = smem + T::Q_BYTES;
  const Lane ln;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int C = H * D;
  const bool masked = mask != nullptr;
  zero_pads<D, INT8>(ring);
  load_q<D>(qs, q, b, h, q0, N, C, scale2);

  const int nt = (M + BKV - 1) / BKV;  // kv tiles
  const int Mp = nt * BKV;             // the v^T codes' padded kv length
  const int steps = 2 * nt;
  auto slot_of = [&](int step) {
    return Slot<D>(ring + (step % STAGES) * T::STAGE_BYTES);
  };
  auto prefetch = [&](int step) {
    if (step < steps)
      load_tile<D, INT8>(slot_of(step), k, v, mask, b, h, (step % nt) * BKV,
                         M, M, Mp, C, H, step >= nt);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) prefetch(i);

  float m_run[2] = {-INFINITY, -INFINITY};
  float r_run[2] = {0.0f, 0.0f};
  float inv_r[2] = {0.0f, 0.0f};
  float o[INT8 ? 1 : T::NO];
  int acc[INT8 ? T::NO8 : 1];
  if constexpr (!INT8) {
#pragma unroll
    for (int i = 0; i < T::NO; ++i) o[i] = 0.0f;
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    prefetch(step + STAGES - 1);
    const Slot<D> slot = slot_of(step);
    float s[32];
    scores<D>(s, qs, slot, ln, (step % nt) * BKV, M, masked);
    if (step < nt) {
      // pass 1: the exact row max (bf16 PV: and the row sum, online)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tm = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tm = fmaxf(tm, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        if constexpr (INT8) {
          m_run[hh] = fmaxf(m_run[hh], tm);
        } else {
          const float m_new = fmaxf(m_run[hh], quad_max(tm));
          float part = 0.0f;
          if (m_new != -INFINITY) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              part += exp2f(s[4 * j + 2 * hh] - m_new) +
                      exp2f(s[4 * j + 2 * hh + 1] - m_new);
          }
          part = quad_sum(part);
          if (m_new != -INFINITY) {
            r_run[hh] = r_run[hh] * exp2f(m_run[hh] - m_new) + part;
            m_run[hh] = m_new;
          }
        }
      }
      if (step == nt - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if constexpr (INT8)
            m_run[hh] = quad_max(m_run[hh]);
          else
            inv_r[hh] = 1.0f / r_run[hh];
        }
      }
      continue;
    }
    // pass 2: probabilities (or softmax codes) and the PV product
    if constexpr (INT8) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = exp2f(s[i] - m_run[(i >> 1) & 1]);
        r_run[(i >> 1) & 1] += s[i];
      }
      uint32_t a[BKV / 32][4];
      pack_codes(a, s);
      pv_s8<D>(acc, a, slot, step > nt ? 1 : 0);
    } else {
      uint32_t p[BKV / 16][4];
      pack_p(p, s, [&](float x, int hh) {
        return exp2f(x - m_run[hh]) * inv_r[hh];
      });
      pv_bf16<D>(o, p, slot, 1);
    }
  }
  cp_async_wait<0>();

  auto value = [&](int i) -> float {
    if constexpr (INT8) {
      const int hh = (i >> 1) & 1;
      const int d = 8 * (i >> 2) + 2 * ln.t4 + (i & 1);
      return (static_cast<float>(acc[i]) * inv_r[hh]) *
             vscale[static_cast<size_t>(b) * C + h * D + d];
    } else {
      return o[i];
    }
  };
  if constexpr (INT8) {
    // int8 PV: inv_r becomes (1/127^2) / r, r summed from the exact max
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      inv_r[hh] =
          static_cast<float>(1.0 / (127.0 * 127.0)) / quad_sum(r_run[hh]);
  }
  if (out_f32)
    store_out<D>(ring, static_cast<float*>(out), ln, b, h, q0, N, C, value);
  else
    store_out<D>(ring, static_cast<__nv_bfloat16*>(out), ln, b, h, q0, N, C,
                 value);
}

// ------------------------------------------------------------------ seg mode

constexpr int SEG_BQ = 64;   // q rows per block: 4 warps x 16
constexpr int SEG_BKV = 64;  // kv rows per tile

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
    attn_kernel_seg(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const void* __restrict__ v,
                    const float* __restrict__ vscale, int vgroup,
                    int n_vgroups, void* __restrict__ out, int out_f32, int N,
                    int H, int seg, float scale2) {
  constexpr int DP = (D + 15) / 16 * 16;  // QK contraction, zero padded
  constexpr int KS = DP / 16;             // k16 steps of QK^T
  constexpr int NT = (D + 7) / 8;         // n8 tiles of the PV output
  constexpr int DV = NT * 8;
  constexpr int LDK = DP + 8;             // bf16 row strides (bank spread)
  constexpr int LDV = SEG_BKV + 8;
  __shared__ __align__(16) __nv_bfloat16 Qs[SEG_BQ * LDK];
  __shared__ __align__(16) __nv_bfloat16 Ks[SEG_BKV * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[DV * LDV];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * SEG_BQ;
  const int C = H * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + g;  // accumulator rows g and g+8
  const int rows[2] = {row_lo, row_lo + 8};

  for (int idx = tid; idx < SEG_BQ * DP; idx += 128) {
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

  const int qlast = min(q0 + SEG_BQ, N) - 1;
  const int lo = (q0 / seg) * seg;
  const int hi = min(N, (qlast / seg + 1) * seg);

  auto load_k = [&](int kv0) {
    for (int idx = tid; idx < SEG_BKV * DP; idx += 128) {
      const int c = idx / DP;
      const int d = idx - c * DP;
      const int n = kv0 + c;
      Ks[c * LDK + d] =
          (n < hi && d < D)
              ? k[(static_cast<size_t>(b) * N + n) * C + h * D + d]
              : __float2bfloat16_rn(0.0f);
    }
  };
  // s[nt][e]: row rows[e >> 1], column kv0 + nt*8 + t*2 + (e & 1)
  auto scores = [&](int kv0, float (&s)[SEG_BKV / 8][4]) {
#pragma unroll
    for (int nt = 0; nt < SEG_BKV / 8; ++nt) {
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
        if (col >= hi || (row / seg) != (col / seg)) s[nt][e] = -INFINITY;
      }
    }
  };

  // pass 1: exact row max, online row sum (rows are shared by a lane quad)
  float m_run[2] = {-INFINITY, -INFINITY};
  float r_run[2] = {0.0f, 0.0f};
  for (int kv0 = lo; kv0 < hi; kv0 += SEG_BKV) {
    __syncthreads();
    load_k(kv0);
    __syncthreads();
    float s[SEG_BKV / 8][4];
    scores(kv0, s);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < SEG_BKV / 8; ++nt)
        tm = fmaxf(tm, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      tm = quad_max(tm);
      const float m_new = fmaxf(m_run[hh], tm);
      float part = 0.0f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int nt = 0; nt < SEG_BKV / 8; ++nt)
          part += exp2f(s[nt][2 * hh] - m_new) + exp2f(s[nt][2 * hh + 1] - m_new);
      }
      part = quad_sum(part);
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
  for (int kv0 = lo; kv0 < hi; kv0 += SEG_BKV) {
    __syncthreads();
    load_k(kv0);
    for (int idx = tid; idx < SEG_BKV * DV; idx += 128) {
      const int c = idx / DV;
      const int d = idx - c * DV;
      const int n = kv0 + c;
      float val = 0.0f;
      if (n < hi && d < D) {
        const size_t gi = (static_cast<size_t>(b) * N + n) * C + h * D + d;
        if constexpr (INT8)
          val = static_cast<float>(static_cast<const int8_t*>(v)[gi]);
        else
          val = __bfloat162float(static_cast<const __nv_bfloat16*>(v)[gi]);
      }
      Vt[d * LDV + c] = __float2bfloat16_rn(val);
    }
    __syncthreads();
    float s[SEG_BKV / 8][4];
    scores(kv0, s);
#pragma unroll
    for (int kk = 0; kk < SEG_BKV / 16; ++kk) {
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
    const int grp = n / vgroup;
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

// -------------------------------------------------------- v quantize, emission

// Per (b, group, channel): vs = max(absmax over the group's vgroup tokens,
// 1e-6); codes = round(v * (127/vs)) (attention.py:176-180, :636-642),
// written in v's layout [B, M, C] unless vq is null (scales only).
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
  vs[item] = s;
  if (vq == nullptr) return;
  const float mul = 127.0f / s;
  for (int r = 0; r < vgroup; ++r) {
    const float x = __bfloat162float(v[base + static_cast<size_t>(r) * C]);
    vq[base + static_cast<size_t>(r) * C] =
        static_cast<int8_t>(static_cast<int>(rintf(x * mul)));
  }
}

// kv row of byte k of a 32-byte chunk of v^T: the k32 fragment order of
// pack_codes (kernels/attention.py KV_PERM)
__device__ __forceinline__ int kv_perm(int k) {
  return (k >> 4) * 16 + ((k & 3) >> 1) * 8 + ((k & 15) >> 2) * 2 + (k & 1);
}

// codes of v [B, M, H*D] against the per-channel scales vs [B, 1, H*D],
// transposed per head: vt [B, H, D, Mp], the 32 kv rows of each chunk in
// kv_perm order, zero past M. One thread per (b, h, chunk, d).
__global__ void vquant_kernel_t(const __nv_bfloat16* __restrict__ v,
                                const float* __restrict__ vs,
                                int8_t* __restrict__ vt, int B, int M, int H,
                                int D, int Mp) {
  const int chunks = Mp / 32;
  const size_t item =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (item >= static_cast<size_t>(B) * H * chunks * D) return;
  const int d = static_cast<int>(item % D);
  size_t rest = item / D;
  const int ch = static_cast<int>(rest % chunks);
  rest /= chunks;
  const int h = static_cast<int>(rest % H);
  const int b = static_cast<int>(rest / H);
  const int C = H * D;
  const int c = h * D + d;
  const float mul = 127.0f / vs[static_cast<size_t>(b) * C + c];
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = ch * 32 + kv_perm(i * 4 + j);
      int code = 0;
      if (n < M)
        code = static_cast<int>(rintf(
            __bfloat162float(v[(static_cast<size_t>(b) * M + n) * C + c]) *
            mul));
      word |= (static_cast<uint32_t>(code) & 0xffu) << (8 * j);
    }
    w[i] = word;
  }
  uint4* dst = reinterpret_cast<uint4*>(
      vt + ((static_cast<size_t>(b) * H + h) * D + d) * Mp + ch * 32);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One warp per row of o [rows, C] f32.
template <bool SYM>
__global__ void row_quant_kernel(const float* __restrict__ o,
                                 int8_t* __restrict__ q,
                                 float* __restrict__ scales,
                                 float* __restrict__ zp,
                                 float* __restrict__ rowsum, int rows, int C) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + static_cast<size_t>(row) * C;
  int8_t* qr = q + static_cast<size_t>(row) * C;
  int sum = 0;
  if constexpr (SYM) {
    float am = 0.0f;
    for (int c = lane; c < C; c += 32) am = fmaxf(am, fabsf(orow[c]));
    const float smax = fmaxf(vq::warp_max(am), 1e-6f);
    const float mul = 127.0f / smax;
    for (int c = lane; c < C; c += 32) {
      const int8_t code = vq::round_sat_s8(orow[c] * mul);
      sum += code;
      qr[c] = code;
    }
    if (rowsum != nullptr) sum = vq::warp_sum_int(sum);
    if (lane == 0) {
      scales[row] = smax / 127.0f;
      if (rowsum != nullptr) rowsum[row] = static_cast<float>(sum);
    }
  } else {
    float lo = 0.0f, hi = 0.0f;
    for (int c = lane; c < C; c += 32) {
      lo = fminf(lo, orow[c]);
      hi = fmaxf(hi, orow[c]);
    }
    const vq::RowQuant rq =
        vq::RowQuant::asym(vq::warp_min(lo), vq::warp_max(hi));
    for (int c = lane; c < C; c += 32) {
      const int8_t code = rq.code<false>(orow[c]);
      sum += code;
      qr[c] = code;
    }
    rq.store<false>(row, lane, sum, scales, zp, rowsum);
  }
}

template <int D, bool INT8>
cudaError_t launch_full(const void* q, const void* k, const void* v,
                        const float* vs, const int* mask, void* out,
                        int out_f32, int B, int N, int M, int H, float scale2,
                        cudaStream_t st) {
  auto kernel = attn_kernel_full<D, INT8>;
  const int smem = Tile<D>::SMEM_BYTES;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, vs, mask, out, out_f32, N, M,
      H, scale2);
  return cudaGetLastError();
}

template <int D, bool INT8>
cudaError_t launch_seg(const void* q, const void* k, const void* v,
                       const float* vs, int vgroup, int n_vgroups, void* out,
                       int out_f32, int B, int N, int H, int seg, float scale2,
                       cudaStream_t st) {
  dim3 grid((N + SEG_BQ - 1) / SEG_BQ, H, B);
  attn_kernel_seg<D, INT8><<<grid, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, vs, vgroup, n_vgroups, out,
      out_f32, N, H, seg, scale2);
  return cudaGetLastError();
}

}  // namespace

// q [B, N, H*D], k [B, M, H*D] bf16; v bf16 [B, M, H*D], or (int8_pv) the
// codes with scales vs [B, n_vgroups, H*D]: in seg mode from vq_attn_vquant
// ([B, M, H*D], vgroup tokens per group, kv range of a 64-row q tile at
// most 1040 tokens), otherwise from vq_attn_vquant_t ([B, H, D, Mp], Mp =
// M rounded up to 64, n_vgroups = 1); mask [B, M] int32 or null (full
// modes only); out [B, N, H*D] f32 (out_f32) or bf16. D in {16, 72};
// every pointer 16-byte aligned.
VQ_EXPORT int vq_attention(const void* q, const void* k, const void* v,
                           const void* vs, int vgroup, int n_vgroups,
                           const void* mask, void* out, int out_f32, int B,
                           int N, int M, int H, int D, int seg, float scale2,
                           int int8_pv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const int* mp = static_cast<const int*>(mask);
  if (seg > 0 && (mask != nullptr || M != N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D * 4 + (seg > 0 ? 2 : 0) + (int8_pv ? 1 : 0)) {
#define VQ_ATTN_CASE(DD, I8)                                                 \
  case DD * 4 + I8:                                                          \
    err = launch_full<DD, I8 != 0>(q, k, v, vsp, mp, out, out_f32, B, N, M,  \
                                   H, scale2, st);                           \
    break;                                                                   \
  case DD * 4 + 2 + I8:                                                      \
    err = launch_seg<DD, I8 != 0>(q, k, v, vsp, vgroup, n_vgroups, out,      \
                                  out_f32, B, N, H, seg, scale2, st);        \
    break;
    VQ_ATTN_CASE(16, 0)
    VQ_ATTN_CASE(16, 1)
    VQ_ATTN_CASE(72, 0)
    VQ_ATTN_CASE(72, 1)
#undef VQ_ATTN_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// v [B, M, C] bf16 -> codes [B, M, C] int8, scales [B, M / vgroup, C] f32
// (the seg-mode layout).
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

// v [B, M, H*D] bf16 -> scales vs [B, 1, H*D] f32 over the whole kv axis and
// codes vt [B, H, D, Mp] int8 (transposed per head, kv_perm order, zero
// past M; Mp a multiple of 64 not below M): the full modes' layout.
VQ_EXPORT int vq_attn_vquant_t(const void* v, void* vt, void* vs, int B,
                               int M, int H, int D, int Mp, void* stream) {
  if (Mp % BKV != 0 || Mp < M) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const size_t scales = static_cast<size_t>(B) * H * D;
  vquant_kernel<<<static_cast<int>((scales + threads - 1) / threads), threads,
                  0, st>>>(static_cast<const __nv_bfloat16*>(v), nullptr,
                           static_cast<float*>(vs), B, M, H * D, M);
  const size_t items = scales * (Mp / 32);
  vquant_kernel_t<<<static_cast<int>((items + threads - 1) / threads), threads,
                    0, st>>>(static_cast<const __nv_bfloat16*>(v),
                             static_cast<const float*>(vs),
                             static_cast<int8_t*>(vt), B, M, H, D, Mp);
  return static_cast<int>(cudaGetLastError());
}

// o [rows, C] f32 -> codes [rows, C] int8, scales [rows] f32; zp [rows] f32
// selects the asymmetric quantizer (null: symmetric); rowsum [rows] f32 or
// null (not written).
VQ_EXPORT int vq_attn_row_quant(const void* o, void* q, void* scales,
                                void* zp, void* rowsum, int rows, int C,
                                void* stream) {
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* op = static_cast<const float*>(o);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  float* zpp = static_cast<float*>(zp);
  float* rp = static_cast<float*>(rowsum);
  if (zpp == nullptr)
    row_quant_kernel<true><<<blocks, threads, 0, st>>>(op, qp, sp, zpp, rp,
                                                       rows, C);
  else
    row_quant_kernel<false><<<blocks, threads, 0, st>>>(op, qp, sp, zpp, rp,
                                                        rows, C);
  return static_cast<int>(cudaGetLastError());
}
