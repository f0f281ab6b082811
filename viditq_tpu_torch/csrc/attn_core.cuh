// The attention core shared by K3 (attention.cu, full and kv-masked modes)
// and K6 (attention_stream.cu): tile shapes, the shared-memory layouts of
// the wgmma operands, the cp.async ring that fills them, the QK^T and PV
// products on wgmma, and the staged 16-byte output store.
//
// What bounds attention on this card: at the spatial and Σ self-attention
// sites (N = M = 1024 / 4096, D = 72) the tensor-core work of two or three
// 64x64x80 products per 64 q rows and kv tile, and the exp2 of every score
// on the 16-per-clock MUFU pipe; bytes only at the cross sites, where the
// kv range is one to five tiles and q and o dominate.
//
// Design:
// - A block of two consumer warpgroups (256 threads) owns 128 q rows of one
//   (batch, head); each warpgroup owns 64 rows and runs wgmma m64nNk16. Two
//   blocks share an SM (at most 128 registers a thread, 78 KB of shared
//   memory a block at D = 72), so one warpgroup's softmax overlaps
//   another's products.
// - q is loaded once with 16-byte loads, pre-scaled and rounded to bf16 as
//   the plain version does, and stored as the A operand of QK^T in shared
//   memory; D = 72 is padded to 80 with zero columns.
// - k and v tiles of 64 rows stream through a ring of STAGES slots filled by
//   16-byte cp.async copies made by all 256 threads (rows past the kv
//   range are zero-filled by the copy itself); one block barrier per tile
//   hands a slot from the copies to the tensor cores, and the copies of the
//   next STAGES-1 tiles are in flight while a tile is computed. cp.async,
//   not TMA: a 72-wide bf16 head row is 144 bytes, no swizzle width, so a
//   TMA box would need a 3-D map per operand (or two boxes per row), each
//   encoded per call by cuTensorMapEncodeTiled; the cp.async copies land the
//   operands straight in the no-swizzle core-matrix layout wgmma reads, with
//   no extra pass.
// - Layouts (no swizzle; a core matrix is 8 rows of 16 bytes, 128 bytes
//   contiguous): q and k as [16-byte column chunk][row][16 bytes] (K-major,
//   the k chunk past D zeroed once); bf16 v as [d chunk][kv row][16 bytes],
//   the MN-major B operand (transpose bit set): no element-wise transpose;
//   int8 v^T as [16-kv chunk][d row][16 bytes], the K-major B operand the
//   s8 wgmma needs, written transposed per head by the v-quantize pass.
// - QK^T: wgmma m64n64k16 bf16, both operands from shared memory, f32
//   scores in registers. bf16 PV: wgmma m64nDk16 with the probabilities
//   taken from the score registers as the register A operand (the
//   flash-attention reuse). Int8 PV: wgmma m64n{80,16}k32 s8 with exact
//   int32 sums; the register A operand packs four codes per register from
//   the score registers, whose columns are not the k32 fragment's, so the
//   contraction index is permuted (a sum over kv rows does not depend on
//   their order) and the v-quantize pass stores v^T under the same
//   permutation (`kv_perm`, kernels/attention.py `KV_PERM`).
// - The kv mask tile (int32) rides in the same ring slot (4-byte cp.async,
//   zero past the kv range), so no score reads device memory.
// - The output is staged through the ring's shared memory and written with
//   16-byte stores, one contiguous head row at a time.
// - Heads wider than 128 (D = 192, 256) take another layout of the same
//   arithmetic (attn_wide.cuh): a block of 64 q rows whose two consumer
//   warpgroups split each tile's scores by kv columns and the PV by output
//   columns over probabilities shared in shared memory, fed by a producer
//   warpgroup. The kernels here take D <= 128.
#pragma once

#include <math.h>

#include "common.cuh"

namespace vq {
namespace attn {

constexpr int BQ = 128;      // q rows per block: two warpgroups of 64
constexpr int BKV = 64;      // kv rows per tile
constexpr int STAGES = 3;    // ring slots
constexpr int THREADS = 256;

template <int D>
struct Tile {
  static constexpr int CH = D / 8;               // 16-byte chunks of a head row
  static constexpr int DP = (D + 15) / 16 * 16;  // QK^T depth, zero padded
  static constexpr int QCH = DP / 8;             // chunks of a padded row
  static constexpr int KS = DP / 16;             // k16 steps of QK^T
  static constexpr int VCH = D / 8;              // 16-byte v chunks
  static constexpr int DVP = (D + 15) / 16 * 16;   // s8-PV width, padded
  static constexpr int NO = D / 2;                // bf16-PV sums a thread
  static constexpr int NO8 = DVP / 2;             // s8-PV sums a thread
  // columns of one PV wgmma (128 takes two of 64)
  static constexpr int PW = D > 72 && D % 64 == 0 ? 64 : D;
  static constexpr int PW8 = DVP > 80 && DVP % 64 == 0 ? 64 : DVP;
  static constexpr int Q_BYTES = QCH * BQ * 16;
  static constexpr int K_BYTES = QCH * BKV * 16;
  static constexpr int VB_BYTES = VCH * BKV * 16;          // bf16 v tile
  static constexpr int V8_BYTES = (BKV / 16) * DVP * 16;  // int8 v^T tile
  static constexpr int V_BYTES = VB_BYTES > V8_BYTES ? VB_BYTES : V8_BYTES;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES + BKV * 4;
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES;
  static_assert(D % 8 == 0 && D <= 128, "head dim must be a multiple "
                "of 8, at most 128 (attn_wide.cuh takes 192 and 256)");
  static_assert(D % PW == 0 && DVP % PW8 == 0, "PV widths");
  static_assert(BQ * D * 4 <= STAGES * STAGE_BYTES, "output staging");
  static_assert(SMEM_BYTES <= 232448, "shared memory of a block");
};

// n consecutive accumulators of a flat array, as one wgmma's operand
template <int n, typename V>
__device__ __forceinline__ V (&part(V* p))[n] {
  return *reinterpret_cast<V(*)[n]>(p);
}

// descriptor strides (bytes) of the operand layouts above
constexpr uint32_t ROW8 = 128;  // next 8 rows inside a chunk column
template <int D>
struct Desc {
  static constexpr uint32_t Q_LBO = BQ * 16;   // next k chunk of q
  static constexpr uint32_t K_LBO = BKV * 16;  // next k chunk of k
  // MN-major bf16 v: leading = next 8 kv rows, stride = next 8 d columns
  static constexpr uint32_t V_LBO = ROW8;
  static constexpr uint32_t V_SBO = BKV * 16;
  // K-major int8 v^T: leading = next 16 kv bytes, stride = next 8 d rows
  static constexpr uint32_t V8_LBO = Tile<D>::DVP * 16;
};

// no-swizzle wgmma matrix descriptor
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wgmma wrappers: _ss both operands in shared memory, _rs A in registers;
// _tb: B is MN-major (transpose bit); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_tb(float (&d)[36],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_tb(float (&d)[8],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[40],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, "
      "{%40, %41, %42, %43}, %44, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[8],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}


// the PV products at the other head widths (32, and 64 for D = 64 and as
// the two halves of D = 128)
__device__ __forceinline__ void wgmma_rs_bf16_tb(float (&d)[16],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_bf16_tb(float (&d)[32],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[16],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[32],
    const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),
        "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

// The calling thread's place in the block: warpgroup wg (64 q rows), warp
// w in it (16 rows), lane quad g (rows g, g + 8) and t4 (columns 2*t4, +1 of
// every 8-column group of an accumulator).
struct Lane {
  int tid, wg, g, t4, row0;
  __device__ __forceinline__ Lane() {
    tid = threadIdx.x;
    wg = tid >> 7;
    const int lane = tid & 31;
    g = lane >> 2;
    t4 = lane & 3;
    row0 = wg * 64 + ((tid >> 5) & 3) * 16 + g;  // local rows row0, row0 + 8
  }
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// softmax codes round(e*127) in 0..127, lowest k index in the lowest byte
__device__ __forceinline__ uint32_t codes4(float e0, float e1, float e2,
                                           float e3) {
  return static_cast<uint32_t>(static_cast<int>(rintf(e0 * 127.0f))) |
         (static_cast<uint32_t>(static_cast<int>(rintf(e1 * 127.0f))) << 8) |
         (static_cast<uint32_t>(static_cast<int>(rintf(e2 * 127.0f))) << 16) |
         (static_cast<uint32_t>(static_cast<int>(rintf(e3 * 127.0f))) << 24);
}

// q rows q0.. of (b, h) -> the QK^T A operand: bf16(f32(q) * scale2), zero
// past N and in the padding columns
template <int D>
__device__ __forceinline__ void load_q(uint8_t* qs,
                                       const __nv_bfloat16* __restrict__ q,
                                       int b, int h, int q0, int N, int C,
                                       float scale2) {
  using T = Tile<D>;
  for (int idx = threadIdx.x; idx < T::QCH * BQ; idx += THREADS) {
    const int r = idx % BQ;
    const int c = idx / BQ;
    const int n = q0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (c < T::CH && n < N) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (static_cast<size_t>(b) * N + n) * C + h * D + c * 8);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[j]));
        o[j] = pack_bf16(f.x * scale2, f.y * scale2);
      }
    }
    *reinterpret_cast<uint4*>(qs + c * (BQ * 16) + r * 16) = out;
  }
}

// zero the parts of every ring slot that no copy writes: the k chunks past
// D, and (int8 v^T) the d rows past D
template <int D, bool INT8>
__device__ __forceinline__ void zero_pads(uint8_t* ring) {
  using T = Tile<D>;
  constexpr int KPAD = (T::QCH - T::CH) * BKV;           // 16-byte units
  constexpr int VPAD = INT8 ? (BKV / 16) * (T::DVP - D) : 0;
  constexpr int VP = VPAD > 0 ? T::DVP - D : 1;  // pad d rows a v^T chunk
  if constexpr (KPAD + VPAD > 0) {
    for (int idx = threadIdx.x; idx < STAGES * (KPAD + VPAD);
         idx += THREADS) {
      const int s = idx / (KPAD + VPAD);
      const int i = idx % (KPAD + VPAD);
      uint8_t* slot = ring + s * T::STAGE_BYTES;
      uint8_t* dst;
      if (i < KPAD) {
        dst = slot + T::CH * (BKV * 16) + i * 16;
      } else {
        const int j = i - KPAD;
        const int kc = j / VP;
        const int d = D + j % VP;
        dst = slot + T::K_BYTES + kc * (T::DVP * 16) + d * 16;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Ring slot of one kv tile: k [BKV rows][DP], v (bf16 [D chunks][BKV rows]
// or int8 v^T [BKV/16 chunks][DVP rows]), mask [BKV] int32.
template <int D>
struct Slot {
  uint8_t* base;
  __device__ __forceinline__ explicit Slot(uint8_t* p) : base(p) {}
  __device__ __forceinline__ uint8_t* k() const { return base; }
  __device__ __forceinline__ uint8_t* v() const {
    return base + Tile<D>::K_BYTES;
  }
  __device__ __forceinline__ const int* mask() const {
    return reinterpret_cast<const int*>(base + Tile<D>::K_BYTES +
                                        Tile<D>::V_BYTES);
  }
};

// Start the copies of kv rows kv0 .. kv0+BKV-1 of (b, h) into a slot; rows
// at or past hi are zero-filled (k, bf16 v) or masked (mask = 0). k and v
// are [B, M, C] bf16; vt is int8 v^T [B, H, D, Mp] (kv_perm order, zero
// past M); with_v = false copies k and the mask only.
template <int D, bool INT8>
__device__ __forceinline__ void load_tile(
    Slot<D> slot, const __nv_bfloat16* __restrict__ k,
    const void* __restrict__ v,
    const int* __restrict__ mask, int b, int h, int kv0, int hi,
    int M, int Mp, int C, int H, bool with_v) {
  using T = Tile<D>;
  const int tid = threadIdx.x;
  const uint32_t ks = smem_u32(slot.k());
  for (int idx = tid; idx < T::CH * BKV; idx += THREADS) {
    const int r = idx % BKV;
    const int c = idx / BKV;
    const int n = kv0 + r;
    const bool ok = n < hi;
    cp_async16(ks + c * (BKV * 16) + r * 16,
               k + (static_cast<size_t>(b) * M + (ok ? n : 0)) * C + h * D +
                   c * 8,
               ok ? 16 : 0);
  }
  if (mask != nullptr && tid < BKV) {
    const int n = kv0 + tid;
    const bool ok = n < hi;
    cp_async4(smem_u32(slot.mask()) + tid * 4,
              mask + static_cast<size_t>(b) * M + (ok ? n : 0), ok ? 4 : 0);
  }
  if (!with_v) return;
  const uint32_t vs = smem_u32(slot.v());
  if constexpr (INT8) {
    const int8_t* vt =
        static_cast<const int8_t*>(v) +
        ((static_cast<size_t>(b) * H + h) * D) * Mp + kv0;
    for (int idx = tid; idx < D * (BKV / 16); idx += THREADS) {
      const int d = idx % D;
      const int kc = idx / D;
      cp_async16(vs + kc * (T::DVP * 16) + d * 16,
                 vt + static_cast<size_t>(d) * Mp + kc * 16, 16);
    }
  } else {
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
    for (int idx = tid; idx < T::VCH * BKV; idx += THREADS) {
      const int r = idx % BKV;
      const int c = idx / BKV;
      const int n = kv0 + r;
      const bool ok = n < hi;
      cp_async16(vs + c * (BKV * 16) + r * 16,
                 vb + (static_cast<size_t>(b) * M + (ok ? n : 0)) * C +
                     h * D + c * 8,
                 ok ? 16 : 0);
    }
  }
}

// d = the k16 steps KS0 .. KS0+N-1 of a warpgroup's q (A at qa) . k (B at
// ka), from zero
template <int KS0, int N>
__device__ __forceinline__ void qk_chain(float (&d)[32], uint32_t qa,
                                         uint32_t ka) {
  wgmma_fence();
#pragma unroll
  for (int ks = KS0; ks < KS0 + N; ++ks)
    wgmma_ss_bf16(d, make_desc(qa + ks * 2 * (BQ * 16), BQ * 16, ROW8),
                  make_desc(ka + ks * 2 * (BKV * 16), BKV * 16, ROW8),
                  ks > KS0 ? 1 : 0);
  wgmma_commit();
  wgmma_wait<0>();
}

// s = this warpgroup's 64 q rows . the slot's 64 k rows (f32), then -inf
// at columns at or past hi and where the staged mask is 0. s[4*nt + e] is
// row row0 + 8*(e >> 1), column kv0 + 8*nt + 2*t4 + (e & 1).
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], const uint8_t* qs,
                                       Slot<D> slot, const Lane& ln,
                                       int kv0, int hi, bool masked) {
  using T = Tile<D>;
  const uint32_t qa = smem_u32(qs) + ln.wg * (64 * 16);
  const uint32_t ka = smem_u32(slot.k());
  qk_chain<0, T::KS>(s, qa, ka);
  if (masked || kv0 + BKV > hi) {
    const int* mk = slot.mask();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nt * 8 + ln.t4 * 2 + j;
        if (kv0 + col >= hi || (masked && mk[col] == 0)) {
          s[4 * nt + j] = -INFINITY;
          s[4 * nt + 2 + j] = -INFINITY;
        }
      }
  }
}

// o += p . v over the slot's 64 kv rows; p[kk] is the A fragment of kv
// rows 16*kk .. 16*kk+15 (pack_bf16 of the score layout); scale_d = 0
// overwrites o
template <int D>
__device__ __forceinline__ void pv_bf16(float (&o)[Tile<D>::NO],
                                        const uint32_t (&p)[BKV / 16][4],
                                        Slot<D> slot, int scale_d) {
  using T = Tile<D>;
  using Ds = Desc<D>;
  const uint32_t va = smem_u32(slot.v());
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    if constexpr (T::PW == D) {
      wgmma_rs_bf16_tb(o, p[kk],
                       make_desc(va + kk * 16 * 16, Ds::V_LBO, Ds::V_SBO),
                       kk > 0 ? 1 : scale_d);
    } else {
#pragma unroll
      for (int c = 0; c < D / T::PW; ++c)  // the columns c*PW .. of o
        wgmma_rs_bf16_tb(
            part<T::PW / 2>(o + c * (T::PW / 2)), p[kk],
            make_desc(va + kk * 16 * 16 + c * (T::PW / 8) * Ds::V_SBO,
                      Ds::V_LBO, Ds::V_SBO),
            kk > 0 ? 1 : scale_d);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// p fragments of the score layout: p[kk] covers score groups 2kk, 2kk+1
template <typename F>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BKV / 16][4],
                                       const float (&s)[32], F f) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const float* a = s + 8 * kk;
    p[kk][0] = pack_bf16(f(a[0], 0), f(a[1], 0));
    p[kk][1] = pack_bf16(f(a[2], 1), f(a[3], 1));
    p[kk][2] = pack_bf16(f(a[4], 0), f(a[5], 0));
    p[kk][3] = pack_bf16(f(a[6], 1), f(a[7], 1));
  }
}

// k32 A fragments of softmax codes from e in the score layout: fragment
// k index 4*t4 + j (+16) holds kv column {2t4, 2t4+1, 8+2t4, 8+2t4+1}[j]
// (+16) of its 32-row chunk: kv_perm
__device__ __forceinline__ void pack_codes(uint32_t (&a)[BKV / 32][4],
                                           const float (&e)[32]) {
#pragma unroll
  for (int ch = 0; ch < BKV / 32; ++ch) {
    const float* x = e + 16 * ch;
    a[ch][0] = codes4(x[0], x[1], x[4], x[5]);
    a[ch][1] = codes4(x[2], x[3], x[6], x[7]);
    a[ch][2] = codes4(x[8], x[9], x[12], x[13]);
    a[ch][3] = codes4(x[10], x[11], x[14], x[15]);
  }
}

// acc += codes . vq over the slot's 64 kv rows (exact int32); scale_d = 0
// overwrites acc
template <int D>
__device__ __forceinline__ void pv_s8(int (&acc)[Tile<D>::NO8],
                                      const uint32_t (&a)[BKV / 32][4],
                                      Slot<D> slot, int scale_d) {
  using T = Tile<D>;
  using Ds = Desc<D>;
  const uint32_t va = smem_u32(slot.v());
  wgmma_fence();
#pragma unroll
  for (int ch = 0; ch < BKV / 32; ++ch) {
    if constexpr (T::PW8 == T::DVP) {
      wgmma_rs_s8(acc, a[ch],
                  make_desc(va + ch * 2 * Ds::V8_LBO, Ds::V8_LBO, ROW8),
                  ch > 0 ? 1 : scale_d);
    } else {
#pragma unroll
      for (int c = 0; c < T::DVP / T::PW8; ++c)  // d rows c*PW8 .. of v^T
        wgmma_rs_s8(part<T::PW8 / 2>(acc + c * (T::PW8 / 2)), a[ch],
                    make_desc(va + ch * 2 * Ds::V8_LBO + c * T::PW8 * 16,
                              Ds::V8_LBO, ROW8),
                    ch > 0 ? 1 : scale_d);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
}

// Write the block's [BQ, W] output tile (rows at or past N dropped) to
// columns col0 .. col0+W-1 of out [B, N, C]: value(i) is the float of
// accumulator i (layout of a W-wide PV: column 8*(i >> 2) + 2*t4 + (i & 1),
// row row0 + 8*((i >> 1) & 1)), staged in `buf` (the ring, free after a
// block barrier) and copied out in 16-byte stores.
template <int W, typename OutT, typename F>
__device__ __forceinline__ void store_out(uint8_t* buf, OutT* __restrict__ out,
                                          const Lane& ln, int b, int col0,
                                          int q0, int N, int C, F value) {
  __syncthreads();  // every warpgroup is done with the ring
  OutT* st = reinterpret_cast<OutT*>(buf);
#pragma unroll
  for (int i = 0; i < W / 2; i += 2) {
    const int col = 8 * (i >> 2) + 2 * ln.t4;
    const int row = ln.row0 + 8 * ((i >> 1) & 1);
    if constexpr (sizeof(OutT) == 2) {
      *reinterpret_cast<uint32_t*>(st + row * W + col) =
          pack_bf16(value(i), value(i + 1));
    } else {
      *reinterpret_cast<float2*>(st + row * W + col) =
          make_float2(value(i), value(i + 1));
    }
  }
  __syncthreads();
  constexpr int CPR = W * static_cast<int>(sizeof(OutT)) / 16;  // per row
  for (int idx = threadIdx.x; idx < BQ * CPR; idx += THREADS) {
    const int r = idx / CPR;
    const int c = idx % CPR;
    const int n = q0 + r;
    if (n >= N) continue;
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(
        out + (static_cast<size_t>(b) * N + n) * C + col0) + c * 16) =
        *reinterpret_cast<const uint4*>(buf + (r * W * sizeof(OutT)) + c * 16);
  }
}

// Dynamic shared memory above 48 KB needs the attribute on every kernel.
template <typename K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace attn
}  // namespace vq
