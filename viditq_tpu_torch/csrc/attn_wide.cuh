// The attention core of the heads wider than 128 (D = 192 and 256), shared
// by K3's full and kv-masked modes (attention.cu) and K6 (attention_stream
// .cu) as one kernel, `attn_wide_kernel`: the same two score passes and the
// same arithmetic per score as attn_core.cuh's kernels at D <= 128, laid
// out so that each score's q.k and exp2 is computed once in each pass.
//
// What bounds it on this card: the tensor cores (at [32, 1024, 6, 192]
// 3 x 2*N*M*D a head with the second q.k pass: 0.23 ms at 989 TFLOP/s) and
// the exp2 of every score on the MUFU pipe (fewer heads than D = 72 at the
// same C: a third to a quarter of its exp2).
//
// Design:
// - A block owns 64 q rows of one (batch, head) and the head's whole output
//   width, in three warpgroups: two consumers and one producer
//   (setmaxnreg gives the consumers the producer's registers).
// - Producer: one thread issues the TMA loads of each kv tile (k in boxes of
//   64 columns x 64 rows, 128-byte swizzle; bf16 v in boxes of 32 columns,
//   or the int8 v^T codes in one box of 64 kv bytes x D rows, 64-byte
//   swizzle; zero past the kv range) into a ring of STAGES slots (2 to 4: as
//   many as 227 KB holds beside q and the probability tiles), its warp the
//   4-byte cp.async copies of the kv mask (zero past the range) beside
//   them; each slot has a full mbarrier (the TMA bytes, and the mask copies'
//   cp.async.mbarrier.arrive.noinc) and an empty one (one arrival per
//   consumer warp). The consumers make no copy. cp.async copies from 128
//   producer threads into the no-swizzle layout of attn_core.cuh, tried
//   first, held the kernel at the rate of those copies (PERF.md section 6,
//   PR 25).
// - Scores: consumer warpgroup w computes the 64 q rows . kv columns
//   32w .. 32w+31 of each 64-row kv tile (wgmma m64n32k16, q and k from
//   shared memory), so every score is computed by one warpgroup, once a
//   pass. The q.k runs in chains of QK_CHAIN k16 steps (one 64-column box),
//   each from zero, added on the CUDA cores in chain order (one chain of 12
//   or 16 steps moved the scores by several times D = 64's, and K6's codes
//   through K4 past the 0.1% mismatch limit: PERF.md section 6). The chains
//   are issued asynchronously in one commit group, their k16 steps
//   interleaved so that consecutive wgmmas are independent (three at a time
//   in the int8 PV modes, whose sums leave fewer registers: the fourth
//   chain's products then overlap the adds of the second and third).
// - Row statistics: each warpgroup keeps those of its 32 columns; the two
//   meet in shared memory where the recurrence needs the row's whole tile
//   range: K3 at the end of pass 1 (bf16 PV: max and sum, combined as two
//   online partials; int8 PV: the max) and at the end (int8 PV: the sum);
//   K6 at the end of each kv block's pass 1 (the block max) and at the end
//   (the sum, both warpgroups' partials scaled by the same corr).
// - PV: the PV columns are split over the two warpgroups of one block,
//   D/2 each (96: m64n96, 128: m64n128), every mode alike. Each warpgroup
//   writes the bf16 probabilities (or int8 softmax codes) of its 32 kv
//   columns into a shared 64 x 64 tile in the K-major no-swizzle layout of
//   a wgmma A operand (double-buffered), one named barrier of the 256
//   consumer threads hands the tile over, and both warpgroups' PV read it
//   from shared memory with v (bf16, MN-major) or v^T codes (int8, K-major,
//   kv_perm order: the codes are stored in the register fragment's k
//   order, so the permutation of attn_core.cuh holds unchanged). Why split
//   the columns rather than keep one warpgroup's 64 x D accumulator: at
//   D = 256 that is 128 f32 registers a thread for the bf16 PV, and K6's
//   int8 PV keeps an exact int32 block sum beside the f32 accumulator,
//   128 + 128 registers, over the limit of 255. Split, a thread holds D/4
//   f32 (and D/4 int32) sums: 64 (+ 64) at 256.
// - A PV stays in flight while the next tile's q.k chains issue; the slot
//   it read is released once the groups issued before those chains are done
//   (wgmma groups complete in order). The bf16 PV's accumulator is first
//   written by the walk's first PV: an f32 accumulator that other
//   instructions define while a wgmma group is open makes ptxas serialize
//   every wgmma of the kernel.
// - The output is staged through the ring's shared memory and written with
//   16-byte stores, one contiguous head row at a time.
#pragma once

#include <type_traits>

#include "attn_core.cuh"
#include "tma.cuh"

namespace vq {
namespace attn {
namespace wide {

constexpr int BQW = 64;          // q rows a block
constexpr int WTHREADS = 384;    // consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMERS = 256;
constexpr int CONSUMER_REGS = 232;  // setmaxnreg: 2 x 128 x 232 +
constexpr int PRODUCER_REGS = 40;   // 128 x 40 <= 384 x 168 registers
constexpr int LAUNCH_REGS = 168;    // per thread at launch (384 threads)
constexpr int HALF = BKV / 2;       // kv columns of a warpgroup's scores
constexpr int QK_CHAIN = 4;         // k16 steps of a q.k chain
constexpr int CONSUMER_BAR = 1;     // named barrier of the consumers

// Shared memory, from a 1024-byte aligned base: q [D/64 boxes][64 rows]
// [128 bytes] (128-byte swizzle), the ring's slots (k [D/64][64 rows][128]
// in the 128-byte swizzle; bf16 v [D/32][64 rows][64] or int8 v^T [D rows]
// [64] in the 64-byte swizzle), the slots' kv masks [64] int32, the two
// probability tiles, the row-statistic exchange and the mbarriers.
template <int D, bool INT8>
struct Layout {
  static constexpr int CH = D / 8;   // 16-byte chunks of a bf16 head row
  static constexpr int KS = D / 16;  // k16 steps of q.k
  static constexpr int CHAINS = KS / QK_CHAIN;
  static constexpr int DH = D / 2;   // a warpgroup's PV columns
  static constexpr int NO = DH / 2;  // PV sums a thread
  static constexpr int KBOX = 64 * 128;  // a q or k box: 64 rows x 128 bytes
  static constexpr int VBOX = 64 * 64;   // a bf16 v box: 64 rows x 64 bytes
  static constexpr int Q_BYTES = BQW * D * 2;
  static constexpr int K_BYTES = BKV * D * 2;
  static constexpr int V_BYTES = INT8 ? D * BKV : BKV * D * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int MASK_BYTES = BKV * 4;
  // one probability (bf16) or code (int8) tile [k chunk][q row][16 bytes]
  static constexpr int P_BYTES = BQW * BKV * (INT8 ? 1 : 2);
  // row statistics exchanged between the warpgroups: [2 uses][wg][row][2]
  static constexpr int XCH_FLOATS = 2 * 2 * BQW * 2;
  static constexpr int BAR_BYTES = 8 * 2 * 4;  // full and empty, <= 4 slots
  // + 1024: the base aligned up to the 128-byte swizzle's 1024-byte atom
  static constexpr int FIXED = 1024 + Q_BYTES + 4 * MASK_BYTES +
                               2 * P_BYTES + XCH_FLOATS * 4 + BAR_BYTES;
  static constexpr int FIT = (232448 - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM_BYTES = FIXED + STAGES * STAGE_BYTES;
  static_assert(D == 192 || D == 256, "the wide kernel takes D = 192, 256");
  static_assert(KS % QK_CHAIN == 0 && CHAINS >= 3, "q.k chains");
  static_assert(STAGES >= 2, "ring too shallow");
  static_assert(STAGE_BYTES % 1024 == 0 && Q_BYTES % 1024 == 0,
                "swizzled boxes stay 1024-byte aligned");
  static_assert(BQW * D * 4 <= STAGES * STAGE_BYTES, "output staging");
};

// wgmma matrix descriptor of a swizzled layout (mode 1: 128-byte swizzle,
// 2: 64-byte); K-major operands leave the leading offset unused (16)
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint32_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(mode) << 62);
}

// ---- wgmma: q.k m64n32 (both operands in shared memory), PV m64n{96,128}
// with the probabilities or codes from shared memory (bf16 v MN-major: the
// transpose bit)

__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[16], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16_tb(float (&d)[48], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "%48, %49, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_bf16_tb(float (&d)[64], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_s8(int (&d)[48], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "%48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_s8(int (&d)[64], uint64_t a,
    uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}


// the full mbarrier of a slot counts this thread's cp.async copies done
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// d[c] = q.k chain C0 + c (the k16 steps (C0+c)*QK_CHAIN .., each chain
// from zero) for c < NC, issued as one commit group with the chains'
// steps interleaved, so that consecutive wgmmas are independent: q at qa,
// k at ka (this warpgroup's 32 kv rows), both K-major in boxes of 64 rows
// x 128 bytes (64 columns), 128-byte swizzle: a chain is one box, a k16
// step 32 bytes into it.
template <int C0, int NC>
__device__ __forceinline__ void qk_issue(float (&d0)[16], float (&d1)[16],
                                         float (&d2)[16], float (&d3)[16],
                                         uint32_t qa, uint32_t ka) {
  static_assert(QK_CHAIN == 4, "a chain is one 64-column box");
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < QK_CHAIN; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      wgmma_ss_bf16(c == 0 ? d0 : c == 1 ? d1 : c == 2 ? d2 : d3,
                    sw_desc(qa + (C0 + c) * (64 * 128) + j * 32, 16, 1024, 1),
                    sw_desc(ka + (C0 + c) * (64 * 128) + j * 32, 16, 1024, 1),
                    j > 0 ? 1 : 0);
  wgmma_commit();
}

__device__ __forceinline__ void add_to(float (&s)[16], const float (&t)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] += t[i];
}

// s = chain 0 + chain 1 + chain 2 (+ chain 3), added on the CUDA cores in
// that order. NA chains are in flight together (all of them, or, where
// registers are short, three and then the fourth while the second and third
// are added). release() runs once every wgmma group issued before this
// call (the previous tile's PV) is done.
template <int CHAINS, int NA, typename F>
__device__ __forceinline__ void qk_scores(float (&s)[16], uint32_t qa,
                                          uint32_t ka, F release) {
  static_assert(NA == 3 || NA == CHAINS, "chains in flight");
  float t[NA - 1][16];
  qk_issue<0, NA>(s, t[0], t[1], t[NA - 2], qa, ka);
  wgmma_wait<1>();
  release();
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int c = 0; c < NA - 1; ++c) fence_regs(t[c]);
  add_to(s, t[0]);
  if constexpr (CHAINS > NA) {  // the fourth chain into t[0]
    qk_issue<3, 1>(t[0], t[0], t[0], t[0], qa, ka);
    add_to(s, t[1]);
    wgmma_wait<0>();
    fence_regs(t[0]);
    add_to(s, t[0]);
  } else {
#pragma unroll
    for (int c = 1; c < NA - 1; ++c) add_to(s, t[c]);
  }
}

// q rows q0 .. q0+63 of (b, h) -> the q.k A operand: bf16(f32(q) * scale2),
// zero past N, in the k boxes' layout (16-byte chunk c of row r of a box at
// r * 128 + ((c ^ (r % 8)) * 16)); by the 256 consumer threads
template <int D>
__device__ __forceinline__ void load_q(uint8_t* qs,
                                       const __nv_bfloat16* __restrict__ q,
                                       int ct, int b, int h, int q0, int N,
                                       int C, float scale2) {
  constexpr int CH = D / 8;
  for (int idx = ct; idx < CH * BQW; idx += CONSUMERS) {
    const int c = idx % CH;  // neighbouring threads on one row's chunks
    const int r = idx / CH;
    const int n = q0 + r;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) {
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
    *reinterpret_cast<uint4*>(qs + (c >> 3) * (64 * 128) + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) = out;
  }
}

// Per (b, h, q row), over kv tiles of 64 rows, both modes:
// K3 (STREAM = false; one kv block, the whole range; attention.cu):
//   bf16 PV: pass 1 the online (max, sum), pass 2 o += bf16(exp2(s - m) / r) . v
//   int8 PV: pass 1 the max, pass 2 r += e = exp2(s - m), acc += codes(e) . vq,
//            o = (acc * ((1/127^2) / r)) * vs
// K6 (STREAM = true; kv blocks of bkv rows; attention_stream.cu): per block
//   pass 1 its max, pass 2 e = exp2(s - m_safe), the row sum and its PV,
//   acc = acc * corr + pv; o = acc / max(r, 1e-30)
// out [B, N, H*D] (K3: f32 where out_f32, else bf16; K6: bf16).
// map_k: k [B, M, C] bf16 in boxes of 64 columns x 64 rows (128-byte
// swizzle); map_v: v [B, M, C] bf16 in boxes of 32 columns x 64 rows, or
// (INT8) the v^T codes [B*H*D, Mp] int8 in boxes of 64 kv bytes x D rows
// (64-byte swizzle); zero outside the tensors.
template <int D, bool INT8, bool STREAM>
__global__ void __launch_bounds__(WTHREADS, 1)
    attn_wide_kernel(const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __nv_bfloat16* __restrict__ q,
                     const float* __restrict__ vscale,
                     const int* __restrict__ mask, void* __restrict__ out,
                     int out_f32, int N, int M, int H, int bkv,
                     float scale2) {
  using L = Layout<D, INT8>;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = qs + L::Q_BYTES;
  int* masks = reinterpret_cast<int*>(ring + S * L::STAGE_BYTES);
  uint8_t* pbuf = reinterpret_cast<uint8_t*>(masks) + 4 * L::MASK_BYTES;
  float* xch = reinterpret_cast<float*>(pbuf + 2 * L::P_BYTES);
  const uint32_t bars = smem_u32(xch + L::XCH_FLOATS);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * BQW;
  const int C = H * D;
  const bool masked = mask != nullptr;
  const int nt = (M + BKV - 1) / BKV;  // kv tiles
  const int nb = STREAM ? bkv / BKV : nt;  // tiles a kv block
  const int steps = 2 * nt;                // every block walked twice
  // step -> its kv tile's first row, and whether it is pass 2
  auto kv_of = [&](int step) {
    return ((step / (2 * nb)) * nb + (step % (2 * nb)) % nb) * BKV;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the TMA thread's arrival, and the mask copies of the producer warp
      mbar_init(full(s), masked ? 1 + 32 : 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: its first warp keeps the ring full, one thread issuing
    // the TMA loads of k and v, the warp copying the kv mask (4-byte
    // cp.async, zero past M) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = threadIdx.x - CONSUMERS;
    if (lane >= 32) return;
    for (int step = 0; step < steps; ++step) {
      const int s = step % S;
      const int kv0 = kv_of(step);
      const bool with_v = step % (2 * nb) >= nb;
      mbar_wait(empty(s), ((step / S) & 1) ^ 1);
      if (masked) {
#pragma unroll
        for (int i = 0; i < BKV / 32; ++i) {
          const int n = kv0 + lane + 32 * i;
          cp_async4(smem_u32(masks + s * BKV + lane + 32 * i),
                    mask + static_cast<size_t>(b) * M + (n < M ? n : 0),
                    n < M ? 4 : 0);
        }
        cp_async_arrive(full(s));
      }
      if (lane == 0) {
        const uint32_t slot = smem_u32(ring + s * L::STAGE_BYTES);
        mbar_expect_tx(full(s), L::K_BYTES + (with_v ? L::V_BYTES : 0));
#pragma unroll
        for (int j = 0; j < D / 64; ++j)
          tma_load_3d(slot + j * L::KBOX, &map_k, full(s), h * D + 64 * j,
                      kv0, b);
        if (with_v) {
          if constexpr (INT8) {
            tma_load(slot + L::K_BYTES, &map_v, full(s), kv0, (b * H + h) * D);
          } else {
#pragma unroll
            for (int j = 0; j < D / 32; ++j)
              tma_load_3d(slot + L::K_BYTES + j * L::VBOX, &map_v, full(s),
                          h * D + 32 * j, kv0, b);
          }
        }
      }
    }
    if (masked) cp_async_wait<0>();
    return;
  }

  // ---- consumers: warpgroup wg takes kv columns 32wg .. 32wg+31 of each
  // tile's scores and output columns DH*wg .. DH*wg+DH-1 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int ct = threadIdx.x;
  const int wg = ct >> 7;
  const int g = (ct & 31) >> 2;
  const int t4 = ct & 3;
  const int row0 = ((ct >> 5) & 3) * 16 + g;  // rows row0, row0 + 8
  const bool leader = (ct & 31) == 0;
  load_q<D>(qs, q, ct, b, h, q0, N, C, scale2);
  fence_proxy_async();
  named_sync(CONSUMER_BAR, CONSUMERS);

  // exchange one statistic pair per row with the other warpgroup through
  // xch[use]: returns the two warpgroups' (a, b) in warpgroup order
  auto exchange = [&](int use, const float (&a)[2], const float (&bb)[2],
                      float (&a0)[2], float (&a1)[2], float (&b0)[2],
                      float (&b1)[2]) {
    float* x = xch + use * (2 * BQW * 2);
    if (t4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + 8 * hh;
        x[(wg * BQW + r) * 2] = a[hh];
        x[(wg * BQW + r) * 2 + 1] = bb[hh];
      }
    }
    named_sync(CONSUMER_BAR, CONSUMERS);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + 8 * hh;
      a0[hh] = x[r * 2];
      b0[hh] = x[r * 2 + 1];
      a1[hh] = x[(BQW + r) * 2];
      b1[hh] = x[(BQW + r) * 2 + 1];
    }
  };

  const uint32_t qa = smem_u32(qs);
  float m_run[2] = {-INFINITY, -INFINITY};
  float r_run[2] = {0.0f, 0.0f};
  float inv_r[2] = {0.0f, 0.0f};
  float bm[2] = {-INFINITY, -INFINITY};            // K6: the block's max
  float m_new[2], m_safe[2], corr[2], rs[2];       // K6
  // f32 sums: the bf16 PV's (written first by the walk's first PV, so
  // that no instruction but a wgmma defines them before the end: ptxas
  // serializes every wgmma otherwise) and K6's int8 PV's
  float acc[L::NO];
  if constexpr (STREAM && INT8) {
#pragma unroll
    for (int i = 0; i < L::NO; ++i) acc[i] = 0.0f;
  }
  int pvi[INT8 ? L::NO : 1];  // int8 PV: exact int32 sums (K3: the whole
                              // range; K6: a kv block)

  for (int step = 0; step < steps; ++step) {
    const int s = step % S;
    uint8_t* slot = ring + s * L::STAGE_BYTES;
    const int kv0 = kv_of(step);
    const int w = step % (2 * nb);  // place in the kv block's two walks
    mbar_wait(full(s), (step / S) & 1);
    fence_proxy_async();
    float sc[16];
    qk_scores<L::CHAINS, INT8 ? 3 : L::CHAINS>(
        sc, qa, smem_u32(slot) + wg * HALF * 128, [&] {
      if (step > 0 && leader) mbar_arrive(empty((step - 1) % S));
    });
    if (masked || kv0 + BKV > M) {
      const int* mk = masks + s * BKV;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wg * HALF + j * 8 + t4 * 2 + e;
          if (kv0 + col >= M || (masked && mk[col] == 0)) {
            sc[4 * j + e] = -INFINITY;
            sc[4 * j + 2 + e] = -INFINITY;
          }
        }
    }
    if (w < nb) {
      // ---- pass 1 ----
      if constexpr (STREAM) {
        if (w == 0) bm[0] = bm[1] = -INFINITY;
#pragma unroll
        for (int i = 0; i < 16; ++i)
          bm[(i >> 1) & 1] = fmaxf(bm[(i >> 1) & 1], sc[i]);
        if (w == nb - 1) {
          // the block max over both warpgroups' columns
          float mx[2] = {quad_max(bm[0]), quad_max(bm[1])};
          float m0[2], m1[2], u0[2], u1[2];
          exchange(0, mx, mx, m0, m1, u0, u1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            m_new[hh] = fmaxf(m_run[hh], fmaxf(m0[hh], m1[hh]));
            m_safe[hh] = m_new[hh] == -INFINITY ? 0.0f : m_new[hh];
            corr[hh] = exp2f(m_run[hh] - m_safe[hh]);
            rs[hh] = 0.0f;
          }
          if constexpr (!INT8) {
            if (step > nb) {  // (the first block's PV writes acc anew)
              wgmma_wait<0>();  // (done already: the last block's PV)
              fence_regs(acc);
#pragma unroll
              for (int i = 0; i < L::NO; ++i) acc[i] *= corr[(i >> 1) & 1];
            }
          }
        }
      } else {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float tm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tm = fmaxf(tm, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
          if constexpr (INT8) {
            m_run[hh] = fmaxf(m_run[hh], tm);
          } else {
            const float mn = fmaxf(m_run[hh], quad_max(tm));
            float part = 0.0f;
            if (mn != -INFINITY) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                part += exp2f(sc[4 * j + 2 * hh] - mn) +
                        exp2f(sc[4 * j + 2 * hh + 1] - mn);
            }
            part = quad_sum(part);
            if (mn != -INFINITY) {
              r_run[hh] = r_run[hh] * exp2f(m_run[hh] - mn) + part;
              m_run[hh] = mn;
            }
          }
        }
        if (w == nb - 1) {
          // the row max (and bf16 PV: sum) over both warpgroups' columns:
          // two online partials combined
          float mx[2], m0[2], m1[2], r0[2], r1[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            mx[hh] = INT8 ? quad_max(m_run[hh]) : m_run[hh];
          exchange(0, mx, r_run, m0, m1, r0, r1);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float m = fmaxf(m0[hh], m1[hh]);
            m_run[hh] = m;
            if constexpr (!INT8) {
              const float r =
                  (m0[hh] == -INFINITY ? 0.0f : r0[hh] * exp2f(m0[hh] - m)) +
                  (m1[hh] == -INFINITY ? 0.0f : r1[hh] * exp2f(m1[hh] - m));
              inv_r[hh] = 1.0f / r;
            }
          }
        }
      }
      continue;
    }
    // ---- pass 2: this warpgroup's probabilities (or codes) of its 32 kv
    // columns into the shared tile, then the PV of its output columns over
    // all 64 kv rows ----
    uint8_t* pb = pbuf + (step & 1) * L::P_BYTES;
    if constexpr (INT8) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        sc[i] = exp2f(sc[i] - (STREAM ? m_safe : m_run)[(i >> 1) & 1]);
        if constexpr (STREAM)
          rs[(i >> 1) & 1] += sc[i];
        else
          r_run[(i >> 1) & 1] += sc[i];
      }
      // the k32 fragment order of pack_codes (kv_perm): bytes k = 4*t4 ..
      // of 16-byte chunk 2wg (+1) hold kv columns {2t4, 2t4+1, 8+2t4,
      // 9+2t4} (+16) of this warpgroup's 32
      uint8_t* base = pb + row0 * 16 + 4 * t4;
      const int c0 = 2 * wg * (BQW * 16);
      *reinterpret_cast<uint32_t*>(base + c0) =
          codes4(sc[0], sc[1], sc[4], sc[5]);
      *reinterpret_cast<uint32_t*>(base + c0 + 8 * 16) =
          codes4(sc[2], sc[3], sc[6], sc[7]);
      *reinterpret_cast<uint32_t*>(base + c0 + BQW * 16) =
          codes4(sc[8], sc[9], sc[12], sc[13]);
      *reinterpret_cast<uint32_t*>(base + c0 + BQW * 16 + 8 * 16) =
          codes4(sc[10], sc[11], sc[14], sc[15]);
    } else {
      uint8_t* base = pb + row0 * 16 + 4 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          if constexpr (STREAM) {
            p[e] = exp2f(sc[4 * j + e] - m_safe[hh]);
            rs[hh] += p[e];
          } else {
            p[e] = exp2f(sc[4 * j + e] - m_run[hh]) * inv_r[hh];
          }
        }
        // k = 32wg + 8j + 2t4: 16-byte chunk 4wg + j
        uint8_t* at = base + (4 * wg + j) * (BQW * 16);
        *reinterpret_cast<uint32_t*>(at) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(at + 8 * 16) = pack_bf16(p[2], p[3]);
      }
    }
    fence_proxy_async();
    named_sync(CONSUMER_BAR, CONSUMERS);
    const uint32_t pa = smem_u32(pb);
    const uint32_t va = smem_u32(slot + L::K_BYTES);
    wgmma_fence();
    // A: the shared tile, K-major without swizzle; B: this warpgroup's
    // columns of v (MN-major, boxes of 32 columns at VBOX, 8 kv rows at 512
    // bytes) or of the v^T codes (K-major, 8 d rows at 512 bytes; a k32
    // step is 32 bytes into the row), 64-byte swizzle
    if constexpr (INT8) {
      const bool first = STREAM ? w == nb : step == nt;
#pragma unroll
      for (int ch = 0; ch < BKV / 32; ++ch)
        wgmma_ss_s8(pvi, make_desc(pa + 2 * ch * (BQW * 16), BQW * 16, ROW8),
                    sw_desc(va + wg * L::DH * 64 + ch * 32, 16, 512, 2),
                    ch > 0 || !first ? 1 : 0);
    } else {
      const bool first = step == nb;  // the walk's first PV
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_ss_bf16_tb(
            acc, make_desc(pa + 2 * kk * (BQW * 16), BQW * 16, ROW8),
            sw_desc(va + (wg * L::DH / 32) * L::VBOX + kk * 16 * 64, L::VBOX,
                    512, 2),
            kk > 0 || !first ? 1 : 0);
    }
    wgmma_commit();
    if constexpr (STREAM) {
      if (w == 2 * nb - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          r_run[hh] = r_run[hh] * corr[hh] + quad_sum(rs[hh]);
          m_run[hh] = m_new[hh];
        }
        if constexpr (INT8) {
          wgmma_wait<0>();
          fence_regs(pvi);
          const float* vsr =
              vscale + static_cast<size_t>(b) * C + h * D + wg * L::DH;
#pragma unroll
          for (int i = 0; i < L::NO; ++i) {
            const int d = 8 * (i >> 2) + 2 * t4 + (i & 1);
            const float vsd =
                vsr[d] * static_cast<float>(1.0 / (127.0 * 127.0));
            acc[i] = acc[i] * corr[(i >> 1) & 1] +
                     static_cast<float>(pvi[i]) * vsd;
          }
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (INT8) fence_regs(pvi);

  // the row sums of both warpgroups (K3 bf16 PV has its 1/r from pass 1)
  if constexpr (STREAM || INT8) {
    float rr[2], r0[2], r1[2], u0[2], u1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rr[hh] = STREAM ? r_run[hh] : quad_sum(r_run[hh]);
    exchange(1, rr, rr, r0, r1, u0, u1);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float r = r0[hh] + r1[hh];
      inv_r[hh] = STREAM ? 1.0f / fmaxf(r, 1e-30f)
                         : static_cast<float>(1.0 / (127.0 * 127.0)) / r;
    }
  } else {
    named_sync(CONSUMER_BAR, CONSUMERS);  // every wgmma is done with the ring
  }

  auto value = [&](int i) -> float {
    const int hh = (i >> 1) & 1;
    if constexpr (STREAM) {
      return acc[i] * inv_r[hh];
    } else if constexpr (INT8) {
      const int d = wg * L::DH + 8 * (i >> 2) + 2 * t4 + (i & 1);
      return (static_cast<float>(pvi[i]) * inv_r[hh]) *
             vscale[static_cast<size_t>(b) * C + h * D + d];
    } else {
      return acc[i];
    }
  };
  // stage the [64, D] tile in the ring (f32 or bf16), then 16-byte stores
  auto store = [&](auto* o) {
    using OutT = std::remove_pointer_t<decltype(o)>;
    OutT* st = reinterpret_cast<OutT*>(ring);
#pragma unroll
    for (int i = 0; i < L::NO; i += 2) {
      const int col = wg * L::DH + 8 * (i >> 2) + 2 * t4;
      const int row = row0 + 8 * ((i >> 1) & 1);
      if constexpr (sizeof(OutT) == 2) {
        *reinterpret_cast<uint32_t*>(st + row * D + col) =
            pack_bf16(value(i), value(i + 1));
      } else {
        *reinterpret_cast<float2*>(st + row * D + col) =
            make_float2(value(i), value(i + 1));
      }
    }
    named_sync(CONSUMER_BAR, CONSUMERS);
    constexpr int CPR = D * static_cast<int>(sizeof(OutT)) / 16;  // per row
    for (int idx = ct; idx < BQW * CPR; idx += CONSUMERS) {
      const int r = idx / CPR;
      const int c = idx % CPR;
      const int n = q0 + r;
      if (n >= N) continue;
      *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(
          o + (static_cast<size_t>(b) * N + n) * C + h * D) + c * 16) =
          *reinterpret_cast<const uint4*>(ring + r * D * sizeof(OutT) +
                                          c * 16);
    }
  };
  if (!STREAM && out_f32)
    store(static_cast<float*>(out));
  else
    store(static_cast<__nv_bfloat16*>(out));
}

// the map of a [B, M, C] bf16 tensor in boxes of `cols` columns x 64 rows
inline bool encode_kv_map(CUtensorMap* map, const void* base, int B, int M,
                          int C, int cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(C),
                              static_cast<cuuint64_t>(M),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(M) * C * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols), BKV, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of the v^T codes [rows, Mp] int8 in boxes of 64 kv bytes x D rows
inline bool encode_vt_map(CUtensorMap* map, const void* base, int rows,
                          int Mp, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Mp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Mp)};
  const cuuint32_t box[2] = {BKV, static_cast<cuuint32_t>(D)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launch the wide kernel over grid (N/64, H, B); K3 passes bkv = 0. v is
// bf16 [B, M, H*D] or (INT8) the v^T codes [B, H, D, Mp], Mp = M rounded
// up to 64.
template <int D, bool INT8, bool STREAM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* vs, const int* mask, void* out, int out_f32,
                   int B, int N, int M, int H, int bkv, float scale2,
                   cudaStream_t st) {
  using L = Layout<D, INT8>;
  auto kernel = attn_wide_kernel<D, INT8, STREAM>;
  const int C = H * D;
  const int Mp = (M + BKV - 1) / BKV * BKV;
  CUtensorMap map_k, map_v;
  if (!encode_kv_map(&map_k, k, B, M, C, 64, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !(INT8 ? encode_vt_map(&map_v, v, B * H * D, Mp, D)
             : encode_kv_map(&map_v, v, B, M, C, 32,
                             CU_TENSOR_MAP_SWIZZLE_64B)))
    return cudaErrorInvalidValue;
  static cudaError_t prepared = cudaErrorNotReady;
  if (prepared == cudaErrorNotReady) {
    cudaFuncAttributes fa;
    prepared = cudaFuncGetAttributes(&fa, kernel);
    // setmaxnreg only moves registers within the block's launch
    // allocation, which must hold the consumers' and producer's shares
    if (prepared == cudaSuccess && fa.numRegs < LAUNCH_REGS)
      prepared = cudaErrorInvalidDeviceFunction;
    if (prepared == cudaSuccess) prepared = set_smem(kernel, L::SMEM_BYTES);
  }
  if (prepared != cudaSuccess) return prepared;
  dim3 grid((N + BQW - 1) / BQW, H, B);
  kernel<<<grid, WTHREADS, L::SMEM_BYTES, st>>>(
      map_k, map_v, static_cast<const __nv_bfloat16*>(q), vs, mask, out,
      out_f32, N, M, H, bkv, scale2);
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace attn
}  // namespace vq
