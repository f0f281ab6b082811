// The float32 attention core: full and kv-masked attention for f32 q/k/v
// and an f32 output, the dtype of the float32 block that AdaRound
// reconstruction runs (viditq_tpu/quant/reconstruction.py:431-461). K3's
// float32 mode (csrc/attention_f32.cu, M <= ONESHOT_MAX_M) and K6's
// (csrc/attention_stream_f32.cu, M > ONESHOT_MAX_M) both launch it.
//
// Per (b, h, q row), the online softmax of the TPU kernels in f32
// (viditq_tpu/kernels/attention.py:143-144, :198-203 and :287-291,
// :328-346), one kv tile of BKV rows a step:
//   s      = bf16(q * scale*log2e) . bf16(k)  (+ -inf where masked; f32 sums)
//   m_new  = max(m_old, rowmax(s));  m_safe = m_new, or 0 while the row is
//            fully masked
//   e      = exp2(s - m_safe);  corr = exp2(m_old - m_safe)
//   r      = r * corr + sum(e);  acc = acc * corr + sum(e * v)   (all f32)
// and at the end o = acc * (1 / max(r, 1e-30)). In float32 nothing is
// rounded against the running max (e and v stay f32), so the one pass
// moves only f32 rounding against the plain versions' global max (K3) or
// kv block (K6). A row masked whole gives 0 (K6's rule; K3's plain version
// gives NaN there, and no caller masks a row whole).
//
// Design. A block of two warpgroups owns BQ = 128 q rows of one (batch row,
// head), 64 a warpgroup, and walks the kv range in tiles of BKV = 64 rows:
// - q.k on the bf16 tensor cores (wgmma m64n64k16, f32 sums): its operands
//   are bf16-rounded by definition and their products are exact in f32, so
//   this is the reference's q.k. A warpgroup holds its rows' q (pre-scaled,
//   rounded once) as the register A operand for the block's life.
// - The PV on the TF32 tensor cores as three products (wgmma m64nDk8
//   .tf32, A from registers): p = p_hi + p_lo and v = v_hi + v_lo with
//   x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi) (11 + 11 significant
//   bits), and p.v ~ p_hi.v_hi + p_hi.v_lo + p_lo.v_hi, each product exact
//   in f32. What is dropped (p_lo.v_lo and the residues below x_lo) is
//   about 2^-21 of each product, inside the float32 tolerance (1e-5); one
//   TF32 product (2^-11) is not (tests/test_torch_f32_split.py emulates
//   both).
// - p never leaves registers: the score accumulator holds columns 2t, 2t+1
//   of rows g, g+8 of each 8-column group (t = lane % 4, g = lane / 4), and
//   the tf32 A fragment wants k-indices t and t + 4 of the same rows. The
//   contraction does not care about order, so k-index t is kv row 2t and
//   t + 4 is kv row 2t + 1 of each 8-row step, and v^T is staged to match
//   (K-major, the layout tf32 wgmma takes: 4-kv chunks [kv 8s + {0,2,4,6}],
//   [kv 8s + {1,3,5,7}], each d row 16 bytes).
// - The tensor cores' f32 sums are not rounded to nearest: they lose
//   toward zero, up to an ulp of the sum an instruction, so a sum carried
//   through the whole kv range drifts (2.9e-5 relative at M = 4096 on the
//   card). Each tile's products start from zero (24 instructions), and
//   acc = acc * corr + pv is taken on the CUDA cores.
// - Staging: a raw tile (k, v and the mask, f32 as they lie) lands by
//   cp.async while the tile before it is computed; every thread then
//   converts it once for both warpgroups (k to bf16 in wgmma's core-matrix
//   layout, v split into v^T hi and lo, the valid flags). Two warpgroups
//   share a conversion, which is what holds the design back: at one block
//   an SM (211 registers a thread) the conversion and its two barriers a
//   tile leave the tensor cores idle (PERF.md §6).
// - A kv tile masked whole (or past M) adds e = 0 with corr = 1: skipped.
//
// Bound on the card: operations. At N = M = 4096 (PixArt-Σ's
// self-attention) or N = M = 1024 over 32 batch rows (STDiT's spatial), 16
// heads of 72: q.k 77.3 GFLOP of bf16 (0.078 ms at 989 TFLOP/s) and the PV
// 3 x 77.3 GFLOP of TF32 (0.469 ms at 495 TFLOP/s), 0.55 ms; q/k/v/o are
// 151 MB (0.045 ms). The exp2 (537 M a call) runs on the MUFU beside them.
#pragma once

#include "common.cuh"

namespace vq {
namespace attn_f32 {

constexpr int WGS = 2;              // warpgroups a block
constexpr int BQ = 64 * WGS;        // q rows a block: 64 a warpgroup
constexpr int BKV = 64;             // kv rows a tile
constexpr int THREADS = 128 * WGS;

// Shared memory: the raw tile, then the converted operands.
// Layouts (no swizzle; a core matrix is 8 rows of 16 bytes, contiguous):
// k as [8-d chunk][kv row][16 bytes] bf16 (K-major B of q.k, the chunk
// past D zero), v^T hi and lo as [4-kv chunk][d row][16 bytes] tf32
// (K-major B of the PV; chunk 2s holds kv rows 8s + {0, 2, 4, 6}, chunk
// 2s + 1 rows 8s + {1, 3, 5, 7}), then the valid flags.
template <int D>
struct Core {
  static_assert(D % 8 == 0, "head dim must be a multiple of 8");
  static constexpr int KP = (D + 15) / 16 * 16;  // D padded to k16 steps
  static constexpr int KS = KP / 16;             // k16 steps of q.k
  static constexpr int NO = D / 2;               // PV sums a thread
  static constexpr int CH = D / 4;               // 16-byte chunks a row
  static constexpr int RAW = D + 4;  // floats a raw row (16-byte aligned)
  static constexpr int RAW_K = 0;
  static constexpr int RAW_V = RAW_K + BKV * RAW * 4;
  static constexpr int RAW_M = RAW_V + BKV * RAW * 4;
  static constexpr int K_LBO = BKV * 16;  // next 8-d chunk of k
  static constexpr int V_LBO = D * 16;    // next 4-kv chunk of v^T
  static constexpr int S_K = 0;
  static constexpr int S_VH = S_K + (KP / 8) * K_LBO;
  static constexpr int S_VL = S_VH + (BKV / 4) * V_LBO;
  static constexpr int S_OK = S_VL + (BKV / 4) * V_LBO;
  static constexpr int STAGE = (S_OK + BKV * 4 + 127) / 128 * 128;
  static constexpr int STAGE0 = (RAW_M + BKV * 4 + 127) / 128 * 128;
  static constexpr int BYTES = STAGE0 + STAGE;
  static constexpr int K_ITEMS = BKV * (D / 8);   // 16-byte k chunks
  static constexpr int V_ITEMS = (BKV / 4) * D;   // v^T rows of 16 bytes
};

__device__ __forceinline__ uint32_t f32_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float f32_quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float f32_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x rounded to TF32 (10 stored mantissa bits), to nearest, ties away from
// zero, as an f32 bit pattern
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + (a residue below 2^-21 |x|); x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void f32_cp_async16(uint32_t dst,
                                               const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void f32_cp_async4(uint32_t dst,
                                              const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void f32_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void f32_cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// no-swizzle wgmma matrix descriptor
__device__ __forceinline__ uint64_t f32_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// s (+)= q . k^T over one k16 step: A (bf16) from registers, B K-major
__device__ __forceinline__ void wgmma_qk(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// pv (+)= p . v over one k8 step: A (tf32) from registers, B K-major;
// fragment a: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's
// 16 rows
__device__ __forceinline__ void wgmma_pv(float (&d)[36],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// the raw kv tile at t0 (k, v rows < M; the mask entries) by cp.async
template <int D>
__device__ __forceinline__ void issue_tile(uint8_t* smem, const float* kb,
                                           const float* vb,
                                           const int* maskb, int t0, int M,
                                           int C) {
  using T = Core<D>;
  const uint32_t rk = smem_u32(smem + T::RAW_K);
  const uint32_t rv = smem_u32(smem + T::RAW_V);
  for (int i = threadIdx.x; i < BKV * T::CH; i += THREADS) {
    const int r = i / T::CH, c = i % T::CH;
    const int m = t0 + r;
    if (m < M) {
      const size_t off = static_cast<size_t>(m) * C + c * 4;
      const uint32_t dst = (r * T::RAW + c * 4) * 4;
      f32_cp_async16(rk + dst, kb + off);
      f32_cp_async16(rv + dst, vb + off);
    }
  }
  const int tid = threadIdx.x;
  if (maskb != nullptr && tid < BKV && t0 + tid < M)
    f32_cp_async4(smem_u32(smem + T::RAW_M) + tid * 4, maskb + t0 + tid);
  f32_cp_async_commit();
}

// The raw tile at t0 (landed, after a block barrier) converted into
// `stage`: rows past M and masked rows get a zero valid flag, rows past M
// zero operands. Returns whether any row is valid (the same in every
// thread).
template <int D>
__device__ __forceinline__ bool convert_tile(uint8_t* smem, uint8_t* stage,
                                             bool masked, int t0, int M) {
  using T = Core<D>;
  const float* rawk = reinterpret_cast<const float*>(smem + T::RAW_K);
  const float* rawv = reinterpret_cast<const float*>(smem + T::RAW_V);
  const int* rawm = reinterpret_cast<const int*>(smem + T::RAW_M);
  const int tid = threadIdx.x, lane = tid & 31;
  const bool ok0 = t0 + lane < M && (!masked || rawm[lane] != 0);
  const bool ok1 = t0 + lane + 32 < M && (!masked || rawm[lane + 32] != 0);
  if (!__any_sync(0xffffffffu, ok0 || ok1)) return false;
  if (tid < BKV)
    reinterpret_cast<int*>(stage + T::S_OK)[tid] = (tid < 32 ? ok0 : ok1);
  // k: 8 bf16 of a row a thread and step
#pragma unroll
  for (int s = 0; s < (T::K_ITEMS + THREADS - 1) / THREADS; ++s) {
    const int i = tid + s * THREADS;
    if (i < T::K_ITEMS) {
      const int r = i % BKV, c = i / BKV;
      float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
      if (t0 + r < M) {
        x0 = *reinterpret_cast<const float4*>(rawk + r * T::RAW + 8 * c);
        x1 = *reinterpret_cast<const float4*>(rawk + r * T::RAW + 8 * c + 4);
      }
      *reinterpret_cast<uint4*>(stage + T::S_K + c * T::K_LBO + r * 16) =
          make_uint4(f32_bf16x2(x0.x, x0.y), f32_bf16x2(x0.z, x0.w),
                     f32_bf16x2(x1.x, x1.y), f32_bf16x2(x1.z, x1.w));
    }
  }
  // v^T: the 4 kv rows of a chunk at one d a thread and step, split
#pragma unroll
  for (int s = 0; s < (T::V_ITEMS + THREADS - 1) / THREADS; ++s) {
    const int i = tid + s * THREADS;
    if (i < T::V_ITEMS) {
      const int d = i % D, ch = i / D;
      const int r0 = (ch >> 1) * 8 + (ch & 1);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = r0 + 2 * p;
        split_tf32(t0 + r < M ? rawv[r * T::RAW + d] : 0.0f, hi[p], lo[p]);
      }
      *reinterpret_cast<uint4*>(stage + T::S_VH + ch * T::V_LBO + d * 16) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(stage + T::S_VL + ch * T::V_LBO + d * 16) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  fence_proxy_async();  // the stage is read by wgmma (the async proxy)
  return true;
}

// The kernel and its launch have internal linkage: the two sources that
// launch the core each hold their own instance.
namespace {

// q [B, N, H*D], k/v [B, M, H*D], out [B, N, H*D], all f32, 16-byte
// aligned; mask [B, M] int32 (1 = attend) or null; scale2 = scale*log2(e).
// Grid (ceil(N / BQ), H, B), THREADS threads, Core<D>::BYTES of shared
// memory.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    attn_f32_core_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ mask,
                         float* __restrict__ out, int N, int M, int H,
                         float scale2) {
  using T = Core<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16 + g;  // rows row0, row0 + 8 of the block
  const int n0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * D;
  const float* qb = q + static_cast<size_t>(b) * N * C + h * D;
  const float* kb = k + static_cast<size_t>(b) * M * C + h * D;
  const float* vb = v + static_cast<size_t>(b) * M * C + h * D;
  const int* maskb =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * M;
  uint8_t* st = smem + T::STAGE0;
  const uint32_t sa = smem_u32(st);

  issue_tile<D>(smem, kb, vb, maskb, 0, M, C);
  // the k chunk past D stays zero
  if constexpr (T::KP > D) {
    for (int i = tid; i < BKV; i += THREADS)
      *reinterpret_cast<uint4*>(st + T::S_K + (D / 8) * T::K_LBO + i * 16) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  // the warp's q fragments: rows n0 + row0 (+ 8), bf16(q * scale2), zero
  // past D and N; a[0..3] = (row, k), (row + 8, k), (row, k + 8),
  // (row + 8, k + 8) at k = 16 ks + 2t
  uint32_t qa[T::KS][4];
#pragma unroll
  for (int ks = 0; ks < T::KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + row0 + (i & 1) * 8;
      const int d = ks * 16 + 2 * t + (i >> 1) * 8;
      float x0 = 0.0f, x1 = 0.0f;
      if (row < N && d < D) {
        const float2 x = *reinterpret_cast<const float2*>(
            qb + static_cast<size_t>(row) * C + d);
        x0 = x.x * scale2;
        x1 = x.y * scale2;
      }
      qa[ks][i] = f32_bf16x2(x0, x1);
    }

  float m_run[2] = {-INFINITY, -INFINITY};  // rows row0, row0 + 8
  float r_part[2] = {0.0f, 0.0f};           // this lane's columns' share
  float acc[T::NO];  // column 8 (i >> 2) + 2t + (i & 1), row + 8 ((i >> 1) & 1)
#pragma unroll
  for (int i = 0; i < T::NO; ++i) acc[i] = 0.0f;

  const int n_tiles = (M + BKV - 1) / BKV;
  for (int it = 0; it < n_tiles; ++it) {
    f32_cp_async_wait_all();
    __syncthreads();  // tile it has landed; both warpgroups are done with
                      // tile it - 1
    const bool live = convert_tile<D>(smem, st, maskb != nullptr, it * BKV, M);
    __syncthreads();  // the converted tile is complete; the raw one is free
    if (it + 1 < n_tiles)
      issue_tile<D>(smem, kb, vb, maskb, (it + 1) * BKV, M, C);
    if (!live) continue;

    // scores: s[4 nt + e] is row row0 + 8 (e >> 1), kv column 8 nt + 2t +
    // (e & 1)
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks)
      wgmma_qk(s, qa[ks],
               f32_desc(sa + T::S_K + ks * 2 * T::K_LBO, T::K_LBO, 128),
               ks > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    const int* ok = reinterpret_cast<const int*>(st + T::S_OK);
    // the online softmax of rows row0 and row0 + 8; s becomes e
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tm = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float& x = s[4 * nt + 2 * hh + e2];
          if (!ok[nt * 8 + 2 * t + e2]) x = -INFINITY;
          tm = fmaxf(tm, x);
        }
      const float m_new = fmaxf(m_run[hh], f32_quad_max(tm));
      // rows masked so far keep m = -inf; exp2(-inf - 0) is exactly 0
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      corr[hh] = exp2f(m_run[hh] - m_safe);
      float part = 0.0f;
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          float& x = s[4 * nt + 2 * hh + e2];
          x = exp2f(x - m_safe);
          part += x;
        }
      r_part[hh] = r_part[hh] * corr[hh] + part;
      m_run[hh] = m_new;
    }
    // A fragments of each 8-row step: k-index t is kv column 8 nt + 2t
    // (e = 0, 2), t + 4 is 8 nt + 2t + 1 (e = 1, 3)
    uint32_t ph[BKV / 8][4], pl[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      split_tf32(s[4 * nt + 0], ph[nt][0], pl[nt][0]);
      split_tf32(s[4 * nt + 2], ph[nt][1], pl[nt][1]);
      split_tf32(s[4 * nt + 1], ph[nt][2], pl[nt][2]);
      split_tf32(s[4 * nt + 3], ph[nt][3], pl[nt][3]);
    }
    // pv = e . v over the tile from zero, three products a step; then
    // acc = acc * corr + pv on the CUDA cores
    float pv[T::NO];
    wgmma_fence();
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      const uint32_t c = nt * 2 * T::V_LBO;
      const uint64_t dh = f32_desc(sa + T::S_VH + c, T::V_LBO, 128);
      const uint64_t dl = f32_desc(sa + T::S_VL + c, T::V_LBO, 128);
      wgmma_pv(pv, pl[nt], dh, nt > 0 ? 1 : 0);
      wgmma_pv(pv, ph[nt], dl, 1);
      wgmma_pv(pv, ph[nt], dh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < T::NO; ++i)
      acc[i] = acc[i] * corr[(i >> 1) & 1] + pv[i];
  }

  // o = acc * (1 / max(r, 1e-30))
  float* ob = out + static_cast<size_t>(b) * N * C + h * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float r = f32_quad_sum(r_part[hh]);
    const float inv = 1.0f / fmaxf(r, 1e-30f);
    const int n = n0 + row0 + 8 * hh;
    if (n >= N) continue;
    float* orow = ob + static_cast<size_t>(n) * C + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(
          acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
  }
}

template <int D>
cudaError_t launch_core(const float* q, const float* k, const float* v,
                        const int* mask, float* out, int B, int N, int M,
                        int H, float scale2, cudaStream_t st) {
  auto kernel = attn_f32_core_kernel<D>;
  const int smem = Core<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, st>>>(q, k, v, mask, out, N, M, H, scale2);
  return cudaGetLastError();
}

// the C entry points' dispatch over the head dims the port instantiates
cudaError_t launch_core_any(const float* q, const float* k, const float* v,
                            const int* mask, float* out, int B, int N, int M,
                            int H, int D, float scale2, cudaStream_t st) {
  if (B <= 0 || N <= 0 || M <= 0 || H <= 0) return cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return launch_core<16>(q, k, v, mask, out, B, N, M, H, scale2, st);
    case 72:
      return launch_core<72>(q, k, v, mask, out, B, N, M, H, scale2, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace attn_f32
}  // namespace vq
