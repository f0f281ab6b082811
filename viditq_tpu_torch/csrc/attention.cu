// K3: layout-native attention over [B, N, H*D] with an f32 base-2
// softmax, a bf16 PV or the int8 PV (round(e*127) codes x per-channel int8
// v), and optional int8 row emission of the output across all heads, in
// three kernels: the full and kv-masked modes (attn_kernel_full) and seg
// mode, block-diagonal attention in segments of `seg` tokens (STDiT's
// temporal attention: attn_seg_tiled, and attn_seg_rows for the shapes the
// tiled kernel does not take).
//
// Replaces the TPU kernel `_attn_kernel` behind `attention_bnhd` /
// `attention_bnhd_int8out` (viditq_tpu/kernels/attention.py:80-234,
// dispatch :599-785). Per (b, h, q row):
//   s = bf16(q * scale*log2e) . bf16(k)        (f32 sums)
//   m = rowmax(s); e = exp2(s - m); r = sum(e)
//   bf16 PV: o = sum(bf16(e * (1/r)) * v)
//   int8 PV: o = float(sum(round(e*127) * vq)) * ((1/127^2) / r) * vs
// with v's scales per channel over the whole kv axis, or in seg mode per
// (v_block tokens x channel) (C2). The bf16 PV normalizes before the
// product, so r must be known first, and the int8 codes round against the
// FULL row max (C3): the full modes make two passes over the kv range.
// bf16 PV: pass 1 is QK^T with the online (max, sum), pass 2 QK^T, exp2,
// normalize and PV. Int8 PV: pass 1 is QK^T and the max only, pass 2 exp2,
// r (summed from that max, as the plain version and the JAX kernel write
// it), codes and PV. A one-pass flash form would
// round each probability against another max (ROADMAP C9). The v codes and
// their per-channel scales over the whole kv axis come from a v-quantize
// pass that stores the codes transposed per head for the s8 wgmma.
// Emission quantizes each f32 output row with the attention site's own
// forms (C6; attention.py:217-233), after multiplying it by the proj's
// channel-balancing column scale where one is given (`out_col_scale`,
// attention.py:213-216: o * cs[c] before the row statistic,
// RowQuant::balance); the full modes write the rows to an f32 scratch that
// row_quant_kernel quantizes, seg mode in the kernel:
//   sym : smax = max(absmax, 1e-6); scale = smax/127;
//         codes = round(o * (127/smax))
//   asym: `_quantize_rows_f32`'s (common.cuh RowQuant: inv = 1/scale, zp)
// and, where asked for (asym proj weights), the code row sum.
//
// Bound on the card: at the spatial site (N = M = 1024, D = 72) the
// tensor-core work of three 64x64x80 products per 64 q rows and kv tile
// (0.26 ms at 989 TFLOP/s for [32, 1024, 16, 72]) and two exp2 per score in
// bf16 PV (0.29 ms on the MUFU pipe), one in int8 PV; at the cross sites
// (kv 120 / 300: two to five tiles) the bytes of q and o.
// Design (attn_kernel_full): the shared core (attn_core.cuh), 128 q rows
// per block in two wgmma warpgroups, k/v tiles of 64 rows through a 3-slot
// cp.async ring (pass 1 streams k only, pass 2 k and v), QK^T and PV on
// wgmma, the kv mask staged per tile, the output staged through shared
// memory and written with 16-byte stores. The int8 PV runs on s8 wgmma
// with exact int32 sums, so its kv range is not bounded. D is a template
// parameter: 72 (STDiT-XL, PixArt), 64 (DiT-L/2), 16, 32, 128, 192 and
// 256 (two blocks a head, each with half its output columns: attn_core.cuh
// `block_cols`); the wrappers pad any other D up to the next of these.
//
// Seg mode. Bound on the card: bytes. At the main path ([2, 16384, 16,
// 72], seg 16) q, k and v are read once and o written once: 8*B*N*C bytes
// in bf16 (0.090 ms at 3.35 TB/s), 6*B*N*C + B*N*(C + 4) with int8 PV and
// emission (0.079 ms); the products (2 x 16x16x72 per head and segment)
// are a few GFLOP, far below the tensor cores, so wgmma's 64-row tiles buy
// nothing.
//
// Design (`attn_seg_tiled`, every seg dividing 16 with H even, H <= 32):
// - A block owns one tile of 16 consecutive rows of one batch row, whole
//   segments, across all H heads: H/2 warps, two heads each. The tile's
//   rows are contiguous in q, k and v, so one thread issues one
//   cp.async.bulk copy a row (and one for the tile's int8 v codes) on one
//   mbarrier: ~110 KB (bf16 PV) in flight, no address arithmetic per
//   element. Rows are padded by 16 bytes in shared memory (a row stride of
//   4 words mod 8: the fragment loads are conflict-free). Two blocks fit an
//   SM, so one block's loads overlap the other's math and stores.
// - A 16-row tile is one m16 row block, so every score row is whole in
//   registers after QK^T (mma.sync m16n8k16 bf16, D = 72 as 4 k16 steps and
//   one m16n8k8): the exact max, r and the probabilities or codes follow in
//   one pass, k and v are read once, and no product is masked away at
//   seg 16 (seg < 16: the -inf mask keeps each row in its segment).
// - bf16 PV: mma.sync m16n8k16 with the probabilities as the A operand (the
//   score accumulators' layout) and v^T fragments by ldmatrix.trans.
// - Int8 PV: mma.sync m16n8k16 s8 with exact int32 sums (no kv-range
//   limit). The A operand packs four codes a register from the score
//   accumulators, whose columns are not the k16 fragment's, so the
//   v-quantize pass (`vquant_tiles_kernel`, which reads v once) stores each
//   tile's codes per channel as 16 bytes in that order (`kv16`): one 32-bit
//   shared load per B fragment.
// - Emission: the block holds its rows' f32 outputs for all heads in
//   registers; each row's absmax (or min and max) reduces over the lane
//   quad by shuffles and across warps through shared memory; the codes are
//   staged in shared memory and leave, as every output does, in 16-byte
//   stores of whole rows. No f32 output and no second pass.
//
// At D = 192 and 256 a warp owns half a head (`seg_parts`): the head's
// q.k whole, the PV, output and emission of half its columns (48 or 64
// sums a thread), so H <= 8 (16 warps).
//
// `attn_seg_rows` (the earlier design) takes every other shape (a seg that
// does not divide 16, such as 1088, H odd, or D = 128): one block of 4
// warps per (64 q rows, head, batch; at D = 192 and 256 a 64-column part of
// the head, `rows_cols`, the q fragments read from q itself), k (and v transposed) staged per 64-row tile,
// two passes (the max and r, then PV). Its int8 PV sums in int32 on
// mma.sync m16n8k32 s8, so its kv range is not bounded either. A block
// holds one head, so its emission takes two launches: per-(row, head)
// output ranges, then the codes from the row's range (no f32 output).
//
// Build: the kernels' instantiations are spread over translation units so
// that the build compiles them in parallel. This file holds the C entry
// points and head dim 16's kernels; parts/attention_d{32,64,72,128,192,256}.cu
// include it with VQ_K3_PART set to their head dim and instantiate that
// dim's launchers alone (`VQ_K3_LAUNCHERS`), which the entry points here
// declare extern.
#include "attn_core.cuh"

namespace vq {
namespace k3 {

using namespace vq::attn;

// ---------------------------------------------------------------- full modes

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS, D > 72 ? 1 : 2)
    attn_kernel_full(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const void* __restrict__ v,
                     const float* __restrict__ vscale,
                     const int* __restrict__ mask, void* __restrict__ out,
                     int out_f32, int N, int M, int H, float scale2) {
  constexpr int DV = block_cols(D);  // this block's output columns
  using T = Tile<D, DV>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* qs = smem;
  uint8_t* ring = smem + T::Q_BYTES;
  const Lane ln;
  const int b = blockIdx.z;
  const int h = blockIdx.y / (D / DV);
  const int c0 = blockIdx.y % (D / DV) * DV;  // the head's first column here
  const int q0 = blockIdx.x * BQ;
  const int C = H * D;
  const bool masked = mask != nullptr;
  zero_pads<D, DV, INT8>(ring);
  load_q<D>(qs, q, b, h, q0, N, C, scale2);

  const int nt = (M + BKV - 1) / BKV;  // kv tiles
  const int Mp = nt * BKV;             // the v^T codes' padded kv length
  const int steps = 2 * nt;
  auto slot_of = [&](int step) {
    return Slot<D, DV>(ring + (step % STAGES) * T::STAGE_BYTES);
  };
  auto prefetch = [&](int step) {
    if (step < steps)
      load_tile<D, DV, INT8>(slot_of(step), k, v, mask, b, h, c0,
                             (step % nt) * BKV, M, M, Mp, C, H, step >= nt);
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
    const Slot<D, DV> slot = slot_of(step);
    float s[32];
    scores<D, DV>(s, qs, slot, ln, (step % nt) * BKV, M, masked);
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
      pv_s8<D, DV>(acc, a, slot, step > nt ? 1 : 0);
    } else {
      uint32_t p[BKV / 16][4];
      pack_p(p, s, [&](float x, int hh) {
        return exp2f(x - m_run[hh]) * inv_r[hh];
      });
      pv_bf16<D, DV>(o, p, slot, 1);
    }
  }
  cp_async_wait<0>();

  auto value = [&](int i) -> float {
    if constexpr (INT8) {
      const int hh = (i >> 1) & 1;
      const int d = 8 * (i >> 2) + 2 * ln.t4 + (i & 1);
      return (static_cast<float>(acc[i]) * inv_r[hh]) *
             vscale[static_cast<size_t>(b) * C + h * D + c0 + d];
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
    store_out<DV>(ring, static_cast<float*>(out), ln, b, h * D + c0, q0, N,
                  C, value);
  else
    store_out<DV>(ring, static_cast<__nv_bfloat16*>(out), ln, b, h * D + c0,
                  q0, N, C, value);
}

// -------------------------------------------------------- v quantize, emission

// kv row of byte k of a 32-byte chunk of v^T: the k32 fragment order of
// pack_codes (kernels/attention.py KV_PERM)
__device__ __forceinline__ int kv_perm(int k) {
  return (k >> 4) * 16 + ((k & 3) >> 1) * 8 + ((k & 15) >> 2) * 2 + (k & 1);
}

#ifndef VQ_K3_PART  // (the entry points' own kernels, to the row quant)

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

// One warp per row of o [rows, C] f32 (CS: each value times cs[c] first).
template <bool SYM, bool CS>
__global__ void row_quant_kernel(const float* __restrict__ o,
                                 const float* __restrict__ cs,
                                 int8_t* __restrict__ q,
                                 float* __restrict__ scales,
                                 float* __restrict__ zp,
                                 float* __restrict__ rowsum, int rows, int C) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* orow = o + static_cast<size_t>(row) * C;
  int8_t* qr = q + static_cast<size_t>(row) * C;
  const auto val = [&](int c) {
    if constexpr (CS) return vq::RowQuant::balance(orow[c], __ldg(cs + c));
    return orow[c];
  };
  int sum = 0;
  if constexpr (SYM) {
    float am = 0.0f;
    for (int c = lane; c < C; c += 32) am = fmaxf(am, fabsf(val(c)));
    const float smax = fmaxf(vq::warp_max(am), 1e-6f);
    const float mul = 127.0f / smax;
    for (int c = lane; c < C; c += 32) {
      const int8_t code = vq::round_sat_s8(val(c) * mul);
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
      const float x = val(c);
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
    const vq::RowQuant rq =
        vq::RowQuant::asym(vq::warp_min(lo), vq::warp_max(hi));
    for (int c = lane; c < C; c += 32) {
      const int8_t code = rq.code<false>(val(c));
      sum += code;
      qr[c] = code;
    }
    rq.store<false>(row, lane, sum, scales, zp, rowsum);
  }
}

#endif  // VQ_K3_PART

template <int D, bool INT8>
cudaError_t launch_full(const void* q, const void* k, const void* v,
                        const float* vs, const int* mask, void* out,
                        int out_f32, int B, int N, int M, int H, float scale2,
                        cudaStream_t st) {
  auto kernel = attn_kernel_full<D, INT8>;
  const int smem = Tile<D, block_cols(D)>::SMEM_BYTES;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H * (D / block_cols(D)), B);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, vs, mask, out, out_f32, N, M,
      H, scale2);
  return cudaGetLastError();
}


// ------------------------------------------------------------------ seg mode
// (the design: the header)

__device__ __forceinline__ uint32_t ld32(const void* p) {
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

__device__ __forceinline__ void mma_bf16_k8(float* c, uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_s8_k16(int* c, uint32_t a0, uint32_t a1,
                                           uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_s8_k32(int* c, const uint32_t* a,
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

// bf16 pair -> bf16(f32(x) * scale2), the plain version's q pre-scale
__device__ __forceinline__ uint32_t scaled(uint32_t w, float scale2) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  return pack_bf16(f.x * scale2, f.y * scale2);
}

// ----------------------------------------------------- the tiled kernel

constexpr int TR = 16;         // rows of a tile (one m16 row block)
constexpr int HPW = 2;         // heads a warp
constexpr int MAX_WARPS = 16;  // H <= 32

// A warp's share of the heads at head dim D: up to 72, HPW whole heads;
// at 192 and 256 half a head (its q.k whole, the PV and output of half its
// columns), so a warp holds 48 or 64 output sums a thread, as D = 72's
// two heads hold 72. (128's two heads would hold 128: the row kernel
// takes it.)
__host__ __device__ constexpr int seg_parts(int D) { return D > 128 ? 2 : 1; }

// warps of a tiled block over H heads of D (0: the shape is not taken)
__host__ __device__ constexpr int seg_warps(int D, int H) {
  return seg_parts(D) > 1 ? H * seg_parts(D) : H % HPW == 0 ? H / HPW : 0;
}

// tile row held by byte k of a channel's 16 v codes: the k index of the s8
// mma's A operand packed from the score accumulators holds that column
// (kernels/attention.py KV_PERM[:16])
__device__ __forceinline__ int kv16(int k) {
  return ((k & 3) >> 1) * 8 + (k >> 2) * 2 + (k & 1);
}

// shared memory of a tile: q, k (and bf16 v) rows of 2C + 16 bytes, or the
// int8 v codes [C][16]; then the cross-warp row reductions and the barrier
struct SegSmem {
  int rs, v_bytes, red_off, sum_off, bar_off, total;
  __host__ __device__ SegSmem(int C, bool int8) {
    rs = 2 * C + 16;
    v_bytes = int8 ? C * TR : TR * rs;
    red_off = 2 * TR * rs + v_bytes;
    sum_off = red_off + MAX_WARPS * TR * 2 * 4;
    bar_off = sum_off + MAX_WARPS * TR * 4;
    total = bar_off + 16;
  }
};

// EMIT: 0 bf16 out, 1 sym codes, 2 asym codes (zp; rowsum where not null;
// the outputs times the column scales cs first where cs is not null)
template <int D, bool INT8, int EMIT>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    attn_seg_tiled(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const void* __restrict__ v,
                   const float* __restrict__ vscale, int vgroup,
                   int n_vgroups, __nv_bfloat16* __restrict__ out,
                   const float* __restrict__ cs,
                   int8_t* __restrict__ codes, float* __restrict__ scales,
                   float* __restrict__ zps, float* __restrict__ rowsums,
                   int N, int H, int seg_shift, float scale2) {
  constexpr int KS = D / 16;         // k16 steps of QK^T
  constexpr bool K8 = D % 16 != 0;   // and one k8 step (D = 72)
  constexpr int PARTS = seg_parts(D);
  constexpr int HW = PARTS > 1 ? 1 : HPW;  // heads a warp
  constexpr int NT = D / PARTS / 8;        // n8 tiles of a warp's PV
  extern __shared__ __align__(128) uint8_t smem[];
  const int C = H * D;
  const SegSmem L(C, INT8);
  uint8_t* qs = smem;
  uint8_t* ks = smem + TR * L.rs;
  uint8_t* vs = smem + 2 * TR * L.rs;
  float* red = reinterpret_cast<float*>(smem + L.red_off);   // [w][row][2]
  int* red_sum = reinterpret_cast<int*>(smem + L.sum_off);   // [w][row]
  const uint32_t bar = smem_u32(smem + L.bar_off);

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int n0 = tile * TR;
  const int rows = min(TR, N - n0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int warps = blockDim.x >> 5;
  const size_t row0 = static_cast<size_t>(b) * N + n0;
  const int rb = 2 * C;  // bytes of a bf16 row
  // the first column of the warp's head j, and of its output columns in
  // that head
  auto head_col = [&](int j) {
    return (PARTS > 1 ? warp / PARTS : warp * HPW + j) * D;
  };
  const int c0 = PARTS > 1 ? warp % PARTS * (D / PARTS) : 0;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0)
      mbar_expect_tx(bar, rows * rb * (INT8 ? 2 : 3) + (INT8 ? C * TR : 0));
    __syncwarp();
    if (lane < rows) {
      const size_t off = (row0 + lane) * C;
      bulk_load(smem_u32(qs + lane * L.rs), q + off, rb, bar);
      bulk_load(smem_u32(ks + lane * L.rs), k + off, rb, bar);
      if constexpr (!INT8)
        bulk_load(smem_u32(vs + lane * L.rs),
                  static_cast<const __nv_bfloat16*>(v) + off, rb, bar);
    }
    if (INT8 && lane == 0)
      bulk_load(smem_u32(vs),
                static_cast<const int8_t*>(v) +
                    (static_cast<size_t>(b) * gridDim.x + tile) * C * TR,
                C * TR, bar);
  }
  // rows past N (a ragged last tile): zeros, so no score or product sees
  // stale bits; the int8 v codes are zero there already
  for (int i = tid; i < (TR - rows) * (rb / 16); i += blockDim.x) {
    const int r = rows + i / (rb / 16);
    const int c16 = i % (rb / 16);
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(qs + r * L.rs + c16 * 16) = z;
    *reinterpret_cast<uint4*>(ks + r * L.rs + c16 * 16) = z;
    if constexpr (!INT8)
      *reinterpret_cast<uint4*>(vs + r * L.rs + c16 * 16) = z;
  }
  mbar_wait(bar, 0);
  __syncthreads();

  // o[j][nt][e]: the warp's head j, row g + 8*(e >> 1), column
  // c0 + nt*8 + 2*t4 + (e & 1) of the head
  float o[HW][NT][4];
#pragma unroll
  for (int j = 0; j < HW; ++j) {
    const int cq = head_col(j);  // the head's first column
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint8_t* qp = qs + g * L.rs + (cq + kk * 16 + 2 * t4) * 2;
      const uint32_t a[4] = {scaled(ld32(qp), scale2),
                             scaled(ld32(qp + 8 * L.rs), scale2),
                             scaled(ld32(qp + 16), scale2),
                             scaled(ld32(qp + 8 * L.rs + 16), scale2)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint8_t* kp =
            ks + (nt * 8 + g) * L.rs + (cq + kk * 16 + 2 * t4) * 2;
        mma_bf16(s[nt], a, ld32(kp), ld32(kp + 16));
      }
    }
    if constexpr (K8) {
      const uint8_t* qp = qs + g * L.rs + (cq + KS * 16 + 2 * t4) * 2;
      const uint32_t a0 = scaled(ld32(qp), scale2);
      const uint32_t a1 = scaled(ld32(qp + 8 * L.rs), scale2);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_bf16_k8(s[nt], a0, a1,
                    ld32(ks + (nt * 8 + g) * L.rs +
                         (cq + KS * 16 + 2 * t4) * 2));
    }
    // each row in its segment; the row's max, e and r, in one pass
    float m[2], r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = g + 8 * hh;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * t4 + e;
          float& x = s[nt][2 * hh + e];
          if ((col >> seg_shift) != (row >> seg_shift)) x = -INFINITY;
          mx = fmaxf(mx, x);
        }
      m[hh] = quad_max(mx);
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * hh + e];
          x = exp2f(x - m[hh]);
          sum += x;
        }
      r[hh] = quad_sum(sum);
    }
    if constexpr (INT8) {
      const uint32_t a0 = codes4(s[0][0], s[0][1], s[1][0], s[1][1]);
      const uint32_t a1 = codes4(s[0][2], s[0][3], s[1][2], s[1][3]);
      float tq[2];
      int grp[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tq[hh] = static_cast<float>(1.0 / (127.0 * 127.0)) / r[hh];
        const int n = n0 + g + 8 * hh;
        grp[hh] = n < N ? n / vgroup : 0;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int acc[4] = {0, 0, 0, 0};
        mma_s8_k16(acc, a0, a1,
                   ld32(vs + (cq + c0 + nt * 8 + g) * TR + 4 * t4));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int c = cq + c0 + nt * 8 + 2 * t4 + (e & 1);
          o[j][nt][e] =
              (static_cast<float>(acc[e]) * tq[hh]) *
              vscale[(static_cast<size_t>(b) * n_vgroups + grp[hh]) * C + c];
        }
      }
    } else {
      const float inv_r[2] = {1.0f / r[0], 1.0f / r[1]};
      const uint32_t p[4] = {pack_bf16(s[0][0] * inv_r[0], s[0][1] * inv_r[0]),
                             pack_bf16(s[0][2] * inv_r[1], s[0][3] * inv_r[1]),
                             pack_bf16(s[1][0] * inv_r[0], s[1][1] * inv_r[0]),
                             pack_bf16(s[1][2] * inv_r[1], s[1][3] * inv_r[1])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][nt][e] = 0.0f;
      // lane l: row l % 8 of matrix l / 8 = (kv rows 8*(mi & 1) .., the
      // n8 tile nt + (mi >> 1))
      const int mi = lane >> 3;
      const uint8_t* vrow = vs + ((mi & 1) * 8 + (lane & 7)) * L.rs;
#pragma unroll
      for (int nt = 0; nt + 1 < NT; nt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_t(bv,
                      smem_u32(vrow + (cq + c0 + (nt + (mi >> 1)) * 8) * 2));
        mma_bf16(o[j][nt], p, bv[0], bv[1]);
        mma_bf16(o[j][nt + 1], p, bv[2], bv[3]);
      }
      if constexpr (NT % 2 == 1) {
        uint32_t bv[2];
        ldmatrix_x2_t(bv, smem_u32(vrow + (cq + c0 + (NT - 1) * 8) * 2));
        mma_bf16(o[j][NT - 1], p, bv[0], bv[1]);
      }
    }
  }

  if constexpr (EMIT == 0) {
    // each warp stages its bf16 outputs in their own q columns, then the
    // block writes whole rows; a head's q columns are read by no other
    // warp, except by the other half's warp at D > 128 (a barrier first)
    if constexpr (PARTS > 1) __syncthreads();
#pragma unroll
    for (int j = 0; j < HW; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(
              qs + (g + 8 * hh) * L.rs +
              (head_col(j) + c0 + nt * 8 + 2 * t4) * 2) =
              pack_bf16(o[j][nt][2 * hh], o[j][nt][2 * hh + 1]);
    __syncthreads();
    const int vec = rb / 16;
    for (int i = tid; i < rows * vec; i += blockDim.x) {
      const int r = i / vec;
      const int c16 = i % vec;
      *reinterpret_cast<uint4*>(out + (row0 + r) * C + c16 * 8) =
          *reinterpret_cast<const uint4*>(qs + r * L.rs + c16 * 16);
    }
    return;
  } else {
    if (cs != nullptr) {  // the proj's 1/cs, before the row statistic
#pragma unroll
      for (int j = 0; j < HW; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // columns c, c + 1 of the head: c even, so an aligned float2
          const float2 s = __ldg(reinterpret_cast<const float2*>(
              cs + head_col(j) + c0 + nt * 8 + 2 * t4));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            o[j][nt][2 * hh] = RowQuant::balance(o[j][nt][2 * hh], s.x);
            o[j][nt][2 * hh + 1] =
                RowQuant::balance(o[j][nt][2 * hh + 1], s.y);
          }
        }
    }
    // the row's absmax (sym) or min(o, 0) and max(o, 0) (asym): lane quad,
    // then across warps
    float hi[2] = {0.0f, 0.0f};
    float lo[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < HW; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = o[j][nt][e];
          if constexpr (EMIT == 1) {
            hi[e >> 1] = fmaxf(hi[e >> 1], fabsf(x));
          } else {
            hi[e >> 1] = fmaxf(hi[e >> 1], x);
            lo[e >> 1] = fminf(lo[e >> 1], x);
          }
        }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      hi[hh] = quad_max(hi[hh]);
      lo[hh] = -quad_max(-lo[hh]);
      if (t4 == 0) {
        red[(warp * TR + g + 8 * hh) * 2] = hi[hh];
        red[(warp * TR + g + 8 * hh) * 2 + 1] = lo[hh];
      }
    }
    __syncthreads();  // every warp is past its q reads too
    RowQuant rq[2];
    float mul[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = g + 8 * hh;
      float h2 = red[row * 2];
      float l2 = red[row * 2 + 1];
      for (int w = 1; w < warps; ++w) {
        h2 = fmaxf(h2, red[(w * TR + row) * 2]);
        l2 = fminf(l2, red[(w * TR + row) * 2 + 1]);
      }
      if constexpr (EMIT == 1) {
        const float smax = fmaxf(h2, 1e-6f);
        mul[hh] = 127.0f / smax;
        rq[hh] = {smax / 127.0f, 0.0f, 0.0f};
      } else {
        rq[hh] = RowQuant::asym(l2, h2);
        mul[hh] = 0.0f;
      }
    }
    int sum[2] = {0, 0};
#pragma unroll
    for (int j = 0; j < HW; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          int8_t c2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = o[j][nt][2 * hh + e];
            c2[e] = EMIT == 1 ? round_sat_s8(x * mul[hh])
                              : rq[hh].code<false>(x);
            sum[hh] += c2[e];
          }
          *reinterpret_cast<uint16_t*>(
              qs + (g + 8 * hh) * L.rs + head_col(j) + c0 + nt * 8 +
              2 * t4) =
              static_cast<uint16_t>(static_cast<uint8_t>(c2[0]) |
                                    (static_cast<uint8_t>(c2[1]) << 8));
        }
    const bool want_sum = rowsums != nullptr;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (want_sum) {
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
        if (t4 == 0) red_sum[warp * TR + g + 8 * hh] = sum[hh];
      }
    }
    __syncthreads();
    const int vec = C / 16;
    for (int i = tid; i < rows * vec; i += blockDim.x) {
      const int r = i / vec;
      const int c16 = i % vec;
      *reinterpret_cast<uint4*>(codes + (row0 + r) * C + c16 * 16) =
          *reinterpret_cast<const uint4*>(qs + r * L.rs + c16 * 16);
    }
    if (warp == 0 && t4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = g + 8 * hh;
        if (row >= rows) continue;
        scales[row0 + row] = rq[hh].s;
        if constexpr (EMIT == 2) zps[row0 + row] = rq[hh].zp;
        if (want_sum) {
          int total = 0;
          for (int w = 0; w < warps; ++w) total += red_sum[w * TR + row];
          rowsums[row0 + row] = static_cast<float>(total);
        }
      }
    }
  }
}

// v [B, N, C] bf16 -> scales vs [B, N / vgroup, C] (max(absmax over the
// group's tokens, 1e-6)) and codes round(v * (127/vs)) as vt [B, NT, C, 16]:
// per 16-row tile and channel, the rows in kv16 order, zero past N. One
// block per (64-channel chunk, group, batch row) holds the group's rows in
// shared memory, so v is read once; codes leave 16 bytes a (tile,
// channel), or byte by byte where a tile holds rows of two groups.
constexpr int VQ_CH = 64;
constexpr int VQ_THREADS = 256;

#ifndef VQ_K3_PART
__global__ void __launch_bounds__(VQ_THREADS)
    vquant_tiles_kernel(const __nv_bfloat16* __restrict__ v,
                        int8_t* __restrict__ vt, float* __restrict__ vs,
                        int N, int C, int vgroup) {
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* rows_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* part = reinterpret_cast<float*>(smem + vgroup * VQ_CH * 2);
  float* scl = part + (VQ_THREADS / 32) * VQ_CH;
  const int c0 = blockIdx.x * VQ_CH;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;
  const int G = N / vgroup;
  const int NT = (N + TR - 1) / TR;
  const int nch = min(VQ_CH, C - c0);
  const int g0 = grp * vgroup;
  const int tid = threadIdx.x;
  const int vec = tid & 7;     // 8-channel vector of the chunk
  float am[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) am[i] = 0.0f;
  constexpr int RSTEP = VQ_THREADS / 8;  // rows a pass of the block
  constexpr int BATCH = 8;               // loads in flight a thread
  if (vec * 8 < nch) {
    for (int r0 = tid >> 3; r0 < vgroup; r0 += BATCH * RSTEP) {
      uint4 raw[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int r = r0 + j * RSTEP;
        if (r < vgroup)
          raw[j] = *reinterpret_cast<const uint4*>(
              v + (static_cast<size_t>(b) * N + g0 + r) * C + c0 + vec * 8);
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int r = r0 + j * RSTEP;
        if (r >= vgroup) continue;
        *reinterpret_cast<uint4*>(rows_s + r * VQ_CH + vec * 8) = raw[j];
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          am[2 * i] = fmaxf(am[2 * i], fabsf(f.x));
          am[2 * i + 1] = fmaxf(am[2 * i + 1], fabsf(f.y));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    am[i] = fmaxf(am[i], __shfl_xor_sync(0xffffffffu, am[i], 8));
    am[i] = fmaxf(am[i], __shfl_xor_sync(0xffffffffu, am[i], 16));
  }
  if ((tid & 31) < 8)
#pragma unroll
    for (int i = 0; i < 8; ++i) part[(tid >> 5) * VQ_CH + vec * 8 + i] = am[i];
  __syncthreads();
  if (tid < nch) {
    float a = part[tid];
    for (int w = 1; w < VQ_THREADS / 32; ++w)
      a = fmaxf(a, part[w * VQ_CH + tid]);
    a = fmaxf(a, 1e-6f);
    scl[tid] = a;
    vs[(static_cast<size_t>(b) * G + grp) * C + c0 + tid] = a;
  }
  __syncthreads();
  const int t_lo = g0 / TR;
  const int t_hi = (g0 + vgroup - 1) / TR;
  const int g1 = grp == G - 1 ? NT * TR : g0 + vgroup;  // last: rows past N
  for (int it = tid; it < (t_hi - t_lo + 1) * nch; it += VQ_THREADS) {
    const int t = t_lo + it / nch;
    const int c = it % nch;
    const float mul = 127.0f / scl[c];
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int kk = 0; kk < TR; ++kk) {
      const int n = t * TR + kv16(kk);
      int code = 0;
      if (n >= g0 && n < g0 + vgroup)
        code = static_cast<int>(rintf(
            __bfloat162float(rows_s[(n - g0) * VQ_CH + c]) * mul));
      w[kk >> 2] |= (static_cast<uint32_t>(code) & 0xffu) << (8 * (kk & 3));
    }
    int8_t* dst = vt + ((static_cast<size_t>(b) * NT + t) * C + c0 + c) * TR;
    if (t * TR >= g0 && t * TR + TR <= g1) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      // a tile shared with a neighbouring group: only this group's rows
      // (and, in the last group, the rows past N)
#pragma unroll
      for (int kk = 0; kk < TR; ++kk) {
        const int n = t * TR + kv16(kk);
        if (n >= g0 && n < g1)
          dst[kk] = static_cast<int8_t>((w[kk >> 2] >> (8 * (kk & 3))) & 0xffu);
      }
    }
  }
}

#endif  // VQ_K3_PART

// ------------------------------------------------------- the row kernel

constexpr int SEG_BQ = 64;   // q rows per block: 4 warps x 16
constexpr int SEG_BKV = 64;  // kv rows per tile

// Output columns of a row-kernel block at head dim D: the head whole up to
// 128; at 192 and 256 a block per 64 of them (the grid's y axis runs over
// (head, part)), each taking the head's q.k whole, so a thread holds 32
// output sums (and 32 int32) where the whole head would hold 128 (256).
__host__ __device__ constexpr int rows_cols(int D) {
  return D > 128 ? 64 : D;
}

// MODE 0: bf16 out. Emission in two launches, since a block holds one
// head of its rows (or a 64-column part of one, `rows_cols`): MODE 1
// writes each (row, head part)'s max(o, 0) and min(o, 0) to stats [B*N,
// gridDim.y]; MODE 2 (sym) / 3 (asym) computes o again (the same
// arithmetic, the same values), takes the row's range over all heads from
// stats and writes its codes, the scale and zero point (the first head's
// blocks) and adds its code sum to rowsum (zeroed by the caller; integer
// partial sums, exact in f32 in any order).
template <int D, bool INT8, int MODE>
__global__ void __launch_bounds__(128)
    attn_seg_rows(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const void* __restrict__ v,
                  const float* __restrict__ vscale, int vgroup,
                  int n_vgroups, __nv_bfloat16* __restrict__ out,
                  const float* __restrict__ cs,
                  float2* __restrict__ stats, int8_t* __restrict__ codes,
                  float* __restrict__ scales, float* __restrict__ zps,
                  float* __restrict__ rowsums, int N, int H, int seg,
                  float scale2) {
  constexpr int DP = (D + 15) / 16 * 16;  // QK contraction, zero padded
  constexpr int KS = DP / 16;             // k16 steps of QK^T
  constexpr int DW = rows_cols(D);        // the block's output columns
  constexpr bool WIDE = DW < D;           // q fragments straight from q
  constexpr int NT = (DW + 7) / 8;        // n8 tiles of the PV output
  constexpr int DV = NT * 8;
  constexpr int LDK = DP + 8;             // bf16 row strides (bank spread)
  constexpr int LDV = SEG_BKV + 8;
  constexpr int LDV8 = SEG_BKV + 16;      // int8 v^T row stride (bytes)
  // q is staged once, read into registers and left behind a barrier
  // before the first bf16 v^T tile is written: the two share one buffer
  // (at D = 128 the three would pass the 48 KB of static shared memory);
  // wider heads read their q fragments from q itself (no staging: k's
  // tile alone is 33 KB at 256)
  constexpr int QS = WIDE ? 8 : SEG_BQ * LDK;
  constexpr int QV = QS > DV * LDV ? QS : DV * LDV;
  __shared__ __align__(16) __nv_bfloat16 QVs[INT8 ? QS : QV];
  __shared__ __align__(16) __nv_bfloat16 Ks[SEG_BKV * LDK];
  __nv_bfloat16* const Qs = QVs;
  __nv_bfloat16* const Vt = QVs;
  __shared__ __align__(16) int8_t Vt8[INT8 ? DV * LDV8 : 16];

  const int b = blockIdx.z;
  const int h = blockIdx.y / (D / DW);
  const int c0 = blockIdx.y % (D / DW) * DW;  // the head's first column here
  const int q0 = blockIdx.x * SEG_BQ;
  const int C = H * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row_lo = q0 + warp * 16 + g;  // accumulator rows g and g+8
  const int rows[2] = {row_lo, row_lo + 8};

  // qa[ks]: rows g, g + 8 of the warp at columns 16 ks + 2t (+ 8), as
  // bf16(q * scale2)
  uint32_t qa[KS][4];
  if constexpr (WIDE) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = rows[i & 1];
        qa[ks][i] = n < N ? scaled(ld32(q + (static_cast<size_t>(b) * N + n) *
                                                C + h * D + ks * 16 + 2 * t +
                                            8 * (i >> 1)),
                                   scale2)
                          : 0u;
      }
  } else {
    for (int idx = tid; idx < SEG_BQ * DP; idx += 128) {
      const int r = idx / DP;
      const int d = idx - r * DP;
      const int n = q0 + r;
      float val = 0.0f;
      if (n < N && d < D) {
        const float qf = __bfloat162float(
            q[(static_cast<size_t>(b) * N + n) * C + h * D + d]);
        val = qf * scale2;
      }
      Qs[r * LDK + d] = __float2bfloat16_rn(val);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const __nv_bfloat16* p = Qs + (warp * 16 + g) * LDK + ks * 16 + t * 2;
      qa[ks][0] = ld32(p);
      qa[ks][1] = ld32(p + 8 * LDK);
      qa[ks][2] = ld32(p + 8);
      qa[ks][3] = ld32(p + 8 * LDK + 8);
    }
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

  // pass 1: exact row max (bf16 PV: and the online row sum)
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
      if constexpr (INT8) {
        m_run[hh] = m_new;
        continue;
      }
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

  // pass 2: probabilities (or softmax codes, and r from the exact max) and
  // the PV product
  float o[NT][4];
  int acc[INT8 ? NT : 1][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[nt][e] = 0.0f;
      if constexpr (INT8) acc[nt][e] = 0;
    }
  for (int kv0 = lo; kv0 < hi; kv0 += SEG_BKV) {
    __syncthreads();
    load_k(kv0);
    if constexpr (INT8) {
      // v^T codes, byte k of each 32-row chunk holding kv row kv_perm(k)
      for (int idx = tid; idx < SEG_BKV * DV; idx += 128) {
        const int c = idx % SEG_BKV;
        const int d = idx / SEG_BKV;
        const int n = kv0 + (c >> 5) * 32 + kv_perm(c & 31);
        Vt8[d * LDV8 + c] =
            (n < hi && d < DW)
                ? static_cast<const int8_t*>(
                      v)[(static_cast<size_t>(b) * N + n) * C + h * D + c0 +
                         d]
                : int8_t{0};
      }
    } else {
      for (int idx = tid; idx < SEG_BKV * DV; idx += 128) {
        const int c = idx / DV;
        const int d = idx - c * DV;
        const int n = kv0 + c;
        float val = 0.0f;
        if (n < hi && d < DW)
          val = __bfloat162float(static_cast<const __nv_bfloat16*>(
              v)[(static_cast<size_t>(b) * N + n) * C + h * D + c0 + d]);
        Vt[d * LDV + c] = __float2bfloat16_rn(val);
      }
    }
    __syncthreads();
    float s[SEG_BKV / 8][4];
    scores(kv0, s);
    if constexpr (INT8) {
#pragma unroll
      for (int nt = 0; nt < SEG_BKV / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f(s[nt][e] - m_run[e >> 1]);
          r_run[e >> 1] += s[nt][e];
        }
#pragma unroll
      for (int kc = 0; kc < SEG_BKV / 32; ++kc) {
        const float(*c)[4] = s + 4 * kc;
        const uint32_t a[4] = {codes4(c[0][0], c[0][1], c[1][0], c[1][1]),
                               codes4(c[0][2], c[0][3], c[1][2], c[1][3]),
                               codes4(c[2][0], c[2][1], c[3][0], c[3][1]),
                               codes4(c[2][2], c[2][3], c[3][2], c[3][3])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int8_t* vp = Vt8 + (nt * 8 + g) * LDV8 + kc * 32 + 4 * t;
          mma_s8_k32(acc[nt], a, ld32(vp), ld32(vp + 16));
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < SEG_BKV / 16; ++kk) {
        float p[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[j][e] = exp2f(s[2 * kk + j][e] - m_run[e >> 1]) * inv_r[e >> 1];
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
  }

  // the outputs o[nt][e] of rows rows[e >> 1], head columns nt*8 + 2t + (e&1)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float tq = INT8 ? static_cast<float>(1.0 / (127.0 * 127.0)) /
                                quad_sum(r_run[hh])
                          : 0.0f;
    if constexpr (INT8) {
      const int n = rows[hh];
      const int grp = n < N ? n / vgroup : 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          o[nt][2 * hh + j] =
              (static_cast<float>(acc[nt][2 * hh + j]) * tq) *
              vscale[(static_cast<size_t>(b) * n_vgroups + grp) * C + h * D +
                     c0 + nt * 8 + t * 2 + j];
    }
  }
  if (MODE != 0 && cs != nullptr) {  // the proj's 1/cs, in both emission
                                     // launches, before the statistic
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 s = __ldg(reinterpret_cast<const float2*>(
          cs + h * D + c0 + nt * 8 + t * 2));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        o[nt][2 * hh] = RowQuant::balance(o[nt][2 * hh], s.x);
        o[nt][2 * hh + 1] = RowQuant::balance(o[nt][2 * hh + 1], s.y);
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int n = rows[hh];
    const size_t orow = (static_cast<size_t>(b) * N + n) * C + h * D + c0;
    if constexpr (MODE == 0) {
      if (n >= N) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(out + orow + nt * 8 + t * 2) =
            pack_bf16(o[nt][2 * hh], o[nt][2 * hh + 1]);
    } else if constexpr (MODE == 1) {
      float hi = 0.0f, lo = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          hi = fmaxf(hi, o[nt][2 * hh + j]);
          lo = fminf(lo, o[nt][2 * hh + j]);
        }
      hi = quad_max(hi);
      lo = -quad_max(-lo);
      if (t == 0 && n < N)
        stats[(static_cast<size_t>(b) * N + n) * gridDim.y + blockIdx.y] =
            make_float2(hi, lo);
    } else {
      const size_t srow =
          (static_cast<size_t>(b) * N + min(n, N - 1)) * gridDim.y;
      float hi = 0.0f, lo = 0.0f;
      for (int hd = 0; hd < static_cast<int>(gridDim.y); ++hd) {
        const float2 st = stats[srow + hd];
        hi = fmaxf(hi, st.x);
        lo = fminf(lo, st.y);
      }
      RowQuant rq;
      float mul = 0.0f;
      if constexpr (MODE == 2) {
        const float smax = fmaxf(fmaxf(hi, -lo), 1e-6f);
        mul = 127.0f / smax;
        rq = {smax / 127.0f, 0.0f, 0.0f};
      } else {
        rq = RowQuant::asym(lo, hi);
      }
      int sum = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        int8_t c2[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = o[nt][2 * hh + j];
          c2[j] = MODE == 2 ? round_sat_s8(x * mul) : rq.code<false>(x);
          sum += c2[j];
        }
        if (n < N)
          *reinterpret_cast<uint16_t*>(codes + orow + nt * 8 + t * 2) =
              static_cast<uint16_t>(static_cast<uint8_t>(c2[0]) |
                                    (static_cast<uint8_t>(c2[1]) << 8));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t != 0 || n >= N) continue;
      const size_t row = static_cast<size_t>(b) * N + n;
      if (rowsums != nullptr) atomicAdd(rowsums + row, static_cast<float>(sum));
      if (blockIdx.y == 0) {
        scales[row] = rq.s;
        if constexpr (MODE == 3) zps[row] = rq.zp;
      }
    }
  }
}

template <int D, bool INT8, int EMIT>
cudaError_t launch_tiled(const void* q, const void* k, const void* v,
                         const float* vs, int vgroup, int n_vgroups,
                         void* out, const float* cs, void* codes,
                         void* scales, void* zp,
                         void* rowsum, int B, int N, int H, int seg_shift,
                         float scale2, cudaStream_t st) {
  auto kernel = attn_seg_tiled<D, INT8, EMIT>;
  const int smem = SegSmem(H * D, INT8).total;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TR - 1) / TR, B);
  kernel<<<grid, seg_warps(D, H) * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, vs, vgroup, n_vgroups,
      static_cast<__nv_bfloat16*>(out), cs, static_cast<int8_t*>(codes),
      static_cast<float*>(scales), static_cast<float*>(zp),
      static_cast<float*>(rowsum), N, H, seg_shift, scale2);
  return cudaGetLastError();
}

template <int D, bool INT8, int MODE>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const float* vs, int vgroup, int n_vgroups, void* out,
                        const float* cs, void* stats, void* codes,
                        void* scales, void* zp,
                        void* rowsum, int B, int N, int H, int seg,
                        float scale2, cudaStream_t st) {
  dim3 grid((N + SEG_BQ - 1) / SEG_BQ, H * (D / rows_cols(D)), B);
  attn_seg_rows<D, INT8, MODE><<<grid, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, vs, vgroup, n_vgroups,
      static_cast<__nv_bfloat16*>(out), cs, static_cast<float2*>(stats),
      static_cast<int8_t*>(codes), static_cast<float*>(scales),
      static_cast<float*>(zp), static_cast<float*>(rowsum), N, H, seg,
      scale2);
  return cudaGetLastError();
}

}  // namespace k3
}  // namespace vq

// One head dim's launchers: the full modes and the row kernel at every
// dim, the tiled kernel at every dim but 128. PRE: empty (the explicit
// instantiations, in the dim's own translation unit) or extern (their
// declarations, here).
#define VQ_K3_FULL(PRE, DD, I8)                                             \
  PRE template cudaError_t vq::k3::launch_full<DD, I8>(                     \
      const void*, const void*, const void*, const float*, const int*,      \
      void*, int, int, int, int, int, float, cudaStream_t);
#define VQ_K3_TILED(PRE, DD, I8, EM)                                        \
  PRE template cudaError_t vq::k3::launch_tiled<DD, I8, EM>(                \
      const void*, const void*, const void*, const float*, int, int, void*, \
      const float*, void*, void*, void*, void*, int, int, int, int, float,  \
      cudaStream_t);
#define VQ_K3_ROWS(PRE, DD, I8, MO)                                         \
  PRE template cudaError_t vq::k3::launch_rows<DD, I8, MO>(                 \
      const void*, const void*, const void*, const float*, int, int, void*, \
      const float*, void*, void*, void*, void*, void*, int, int, int, int,  \
      float, cudaStream_t);
#define VQ_K3_MODES(PRE, DD, I8)                                            \
  VQ_K3_FULL(PRE, DD, I8)                                                   \
  VQ_K3_ROWS(PRE, DD, I8, 0) VQ_K3_ROWS(PRE, DD, I8, 1)                     \
  VQ_K3_ROWS(PRE, DD, I8, 2) VQ_K3_ROWS(PRE, DD, I8, 3)
#define VQ_K3_TILED_MODES(PRE, DD, I8)                                      \
  VQ_K3_TILED(PRE, DD, I8, 0) VQ_K3_TILED(PRE, DD, I8, 1)                   \
  VQ_K3_TILED(PRE, DD, I8, 2)
#define VQ_K3_LAUNCHERS(PRE, DD, TILED)                                     \
  VQ_K3_MODES(PRE, DD, false) VQ_K3_MODES(PRE, DD, true)                    \
  TILED(PRE, DD, false) TILED(PRE, DD, true)
#define VQ_K3_NONE(PRE, DD, I8)

#ifdef VQ_K3_PART
#if VQ_K3_PART == 128
VQ_K3_LAUNCHERS(, 128, VQ_K3_NONE)
#else
VQ_K3_LAUNCHERS(, VQ_K3_PART, VQ_K3_TILED_MODES)
#endif
#else  // the entry points

VQ_K3_LAUNCHERS(extern, 32, VQ_K3_TILED_MODES)
VQ_K3_LAUNCHERS(extern, 64, VQ_K3_TILED_MODES)
VQ_K3_LAUNCHERS(extern, 72, VQ_K3_TILED_MODES)
VQ_K3_LAUNCHERS(extern, 128, VQ_K3_NONE)
VQ_K3_LAUNCHERS(extern, 192, VQ_K3_TILED_MODES)
VQ_K3_LAUNCHERS(extern, 256, VQ_K3_TILED_MODES)

using namespace vq::k3;

// q [B, N, H*D], k [B, M, H*D] bf16; v bf16 [B, M, H*D], or (int8_pv)
// the codes vt [B, H, D, Mp] from vq_attn_vquant_t (Mp = M rounded up to
// 64) with scales vs [B, 1, H*D]; mask [B, M] int32 or null; out
// [B, N, H*D] f32 (out_f32) or bf16. D in {16, 32, 64, 72, 128, 192,
// 256}; every pointer 16-byte aligned.
VQ_EXPORT int vq_attention(const void* q, const void* k, const void* v,
                           const void* vs, const void* mask, void* out,
                           int out_f32, int B, int N, int M, int H, int D,
                           float scale2, int int8_pv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const int* mp = static_cast<const int*>(mask);
  cudaError_t err;
  switch (D * 2 + (int8_pv ? 1 : 0)) {
#define VQ_ATTN_CASE(DD, I8)                                                 \
  case DD * 2 + I8:                                                          \
    err = launch_full<DD, I8 != 0>(q, k, v, vsp, mp, out, out_f32, B, N, M,  \
                                   H, scale2, st);                           \
    break;
    VQ_ATTN_CASE(16, 0)
    VQ_ATTN_CASE(16, 1)
    VQ_ATTN_CASE(32, 0)
    VQ_ATTN_CASE(32, 1)
    VQ_ATTN_CASE(64, 0)
    VQ_ATTN_CASE(64, 1)
    VQ_ATTN_CASE(72, 0)
    VQ_ATTN_CASE(72, 1)
    VQ_ATTN_CASE(128, 0)
    VQ_ATTN_CASE(128, 1)
    VQ_ATTN_CASE(192, 0)
    VQ_ATTN_CASE(192, 1)
    VQ_ATTN_CASE(256, 0)
    VQ_ATTN_CASE(256, 1)
#undef VQ_ATTN_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// v [B, M, C] bf16 -> codes [B, M, C] int8, scales [B, M / vgroup, C] f32
// (the layout of the seg row kernel, attn_seg_rows).
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

// o [rows, C] f32, cs [C] f32 (the column scales) or null -> codes
// [rows, C] int8, scales [rows] f32; zp [rows] f32 selects the asymmetric
// quantizer (null: symmetric); rowsum [rows] f32 or null (not written).
VQ_EXPORT int vq_attn_row_quant(const void* o, const void* cs, void* q,
                                void* scales, void* zp, void* rowsum,
                                int rows, int C, void* stream) {
  const int threads = 256;
  const int blocks = (rows * 32 + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* op = static_cast<const float*>(o);
  const float* csp = static_cast<const float*>(cs);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  float* zpp = static_cast<float*>(zp);
  float* rp = static_cast<float*>(rowsum);
  const auto kernel =
      zpp == nullptr ? (csp == nullptr ? row_quant_kernel<true, false>
                                       : row_quant_kernel<true, true>)
                     : (csp == nullptr ? row_quant_kernel<false, false>
                                       : row_quant_kernel<false, true>);
  kernel<<<blocks, threads, 0, st>>>(op, csp, qp, sp, zpp, rp, rows, C);
  return static_cast<int>(cudaGetLastError());
}

// The tiled kernel: q, k [B, N, H*D] bf16; v bf16 [B, N, H*D], or (int8_pv)
// codes vt [B, ceil(N/16), H*D, 16] with scales vs [B, n_vgroups, H*D] from
// vq_attn_vquant_tiles; seg divides 16 (and N); D in {16, 32, 64, 72} at H
// even, at most 32, or D in {192, 256} at H at most 8 (`seg_warps`; D =
// 128's two heads a warp would hold 128 accumulators: the row kernel takes
// it). emit 0: out [B, N, H*D] bf16; 1 (sym) or 2 (asym): codes
// [B*N, H*D] int8, scales [B*N] f32, zp [B*N] f32 (asym), rowsum [B*N] f32
// or null, of the outputs times cs [H*D] f32 (the column scales) where cs
// is not null. Every pointer 16-byte aligned.
VQ_EXPORT int vq_attention_seg(const void* q, const void* k, const void* v,
                               const void* vs, int vgroup, int n_vgroups,
                               void* out, const void* cs, void* codes,
                               void* scales, void* zp,
                               void* rowsum, int B, int N, int H, int D,
                               int seg, float scale2, int int8_pv, int emit,
                               void* stream) {
  int shift = 0;
  while ((1 << shift) < seg) ++shift;
  if (seg <= 0 || (1 << shift) != seg || seg > TR || N % seg != 0 ||
      seg_warps(D, H) == 0 || seg_warps(D, H) > MAX_WARPS || emit < 0 ||
      emit > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const float* csp = static_cast<const float*>(cs);
  cudaError_t err;
  switch ((D * 2 + (int8_pv ? 1 : 0)) * 3 + emit) {
#define VQ_SEG_CASE(DD, I8, EM)                                               \
  case (DD * 2 + I8) * 3 + EM:                                                \
    err = launch_tiled<DD, I8 != 0, EM>(q, k, v, vsp, vgroup, n_vgroups, out, \
                                        csp, codes, scales, zp, rowsum, B, N, \
                                        H, shift, scale2, st);                \
    break;
#define VQ_SEG_MODES(DD) \
  VQ_SEG_CASE(DD, 0, 0)     \
  VQ_SEG_CASE(DD, 0, 1)     \
  VQ_SEG_CASE(DD, 0, 2)     \
  VQ_SEG_CASE(DD, 1, 0)     \
  VQ_SEG_CASE(DD, 1, 1)     \
  VQ_SEG_CASE(DD, 1, 2)
    VQ_SEG_MODES(16)
    VQ_SEG_MODES(32)
    VQ_SEG_MODES(64)
    VQ_SEG_MODES(72)
    VQ_SEG_MODES(192)
    VQ_SEG_MODES(256)
#undef VQ_SEG_MODES
#undef VQ_SEG_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The row kernel: q, k [B, N, H*D] bf16; v bf16 [B, N, H*D] or (int8_pv)
// codes [B, N, H*D] with scales [B, n_vgroups, H*D] from vq_attn_vquant;
// N % seg == 0; D in {16, 32, 64, 72, 128, 192, 256}. mode 0: out [B, N,
// H*D] bf16; 1: stats [B*N, H * D / rows_cols(D)] float2 (each head's, or
// each 64-column part's at D > 128, max(o, 0), min(o, 0)); 2 (sym) / 3
// (asym), after mode 1 on the same inputs: codes [B*N, H*D] int8, scales [B*N],
// zp [B*N] (asym), rowsum [B*N] f32 zeroed by the caller, or null. cs
// [H*D] f32 or null: modes 1-3 take the outputs times these column scales.
VQ_EXPORT int vq_attention_seg_rows(const void* q, const void* k,
                                    const void* v, const void* vs, int vgroup,
                                    int n_vgroups, void* out, const void* cs,
                                    void* stats,
                                    void* codes, void* scales, void* zp,
                                    void* rowsum, int B, int N, int H, int D,
                                    int seg, float scale2, int int8_pv,
                                    int mode, void* stream) {
  if (seg <= 0 || N % seg != 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const float* csp = static_cast<const float*>(cs);
  cudaError_t err;
  switch ((D * 2 + (int8_pv ? 1 : 0)) * 4 + mode) {
#define VQ_ROWS_CASE(DD, I8, MO)                                             \
  case (DD * 2 + I8) * 4 + MO:                                               \
    err = launch_rows<DD, I8 != 0, MO>(q, k, v, vsp, vgroup, n_vgroups, out, \
                                       csp, stats, codes, scales, zp,        \
                                       rowsum, B, N, H, seg, scale2, st);    \
    break;
#define VQ_ROWS_MODES(DD, I8) \
  VQ_ROWS_CASE(DD, I8, 0)     \
  VQ_ROWS_CASE(DD, I8, 1)     \
  VQ_ROWS_CASE(DD, I8, 2)     \
  VQ_ROWS_CASE(DD, I8, 3)
    VQ_ROWS_MODES(16, 0)
    VQ_ROWS_MODES(16, 1)
    VQ_ROWS_MODES(32, 0)
    VQ_ROWS_MODES(32, 1)
    VQ_ROWS_MODES(64, 0)
    VQ_ROWS_MODES(64, 1)
    VQ_ROWS_MODES(72, 0)
    VQ_ROWS_MODES(72, 1)
    VQ_ROWS_MODES(128, 0)
    VQ_ROWS_MODES(128, 1)
    VQ_ROWS_MODES(192, 0)
    VQ_ROWS_MODES(192, 1)
    VQ_ROWS_MODES(256, 0)
    VQ_ROWS_MODES(256, 1)
#undef VQ_ROWS_MODES
#undef VQ_ROWS_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// v [B, N, C] bf16 -> codes vt [B, ceil(N/16), C, 16] int8 (the tiled
// kernel's layout, zero past N) and scales vs [B, N / vgroup, C] f32;
// vgroup divides N (a block holds vgroup * 128 + 2304 bytes of shared
// memory: vgroup <= 1024 as the wrapper sends it); C % 8 == 0.
VQ_EXPORT int vq_attn_vquant_tiles(const void* v, void* vt, void* vs, int B,
                                   int N, int C, int vgroup, void* stream) {
  if (vgroup <= 0 || N % vgroup != 0 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = vgroup * VQ_CH * 2 + (VQ_THREADS / 32 + 1) * VQ_CH * 4;
  cudaError_t err = vq::attn::set_smem(vquant_tiles_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((C + VQ_CH - 1) / VQ_CH, N / vgroup, B);
  vquant_tiles_kernel<<<grid, VQ_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<int8_t*>(vt),
      static_cast<float*>(vs), N, C, vgroup);
  return static_cast<int>(cudaGetLastError());
}

#endif  // VQ_K3_PART
