// The int8 x int8 -> int32 GEMM core shared by K2 (int8_gemm.cu) and K7b
// (int_matmul.cu): out[M, N] = epilogue(A[M, K] . W[K, N]).
//
// The weight arrives K-major: the codes of W[K, N] lie in memory as W^T
// [N, K] (QuantLinear.w_int is a [K, N] view of [N, K] storage). The s8
// wgmma reads both operands K-major from shared memory (only 16-bit types
// may be transposed) and TMA moves bytes without transposing them, so this
// layout is the one both take as it is.
//
// What bounds it on this card: the int8 tensor cores at the main path's
// shapes (M = 32768, K and N in 1152..4608: 2*M*N*K operations against
// M*K + K*N + 2*M*N bytes, hundreds of operations a byte).
//
// Design (`tma_gemm_kernel`, the path of every aligned shape):
// - A persistent grid of one block per SM walks the output tiles of BM x BN
//   (BM = 128; BN = 192, or 128 where the epilogue holds a second
//   accumulator), so the producer's loads of the next tile overlap this
//   tile's epilogue.
// - Three warpgroups: two consumers of 64 rows each, one producer. One
//   producer thread issues cp.async.bulk.tensor loads of A [BM, 128] and
//   W^T [BN, 128] k-tiles (128 bytes of k: one 128-byte swizzle row) into a
//   ring of STAGES slots, each guarded by a full and an empty mbarrier.
//   setmaxnreg gives the consumers the producer's registers.
// - The consumers run wgmma m64nBNk32 s32.s8.s8 on both operands in shared
//   memory (128-byte swizzle descriptors, the k32 step advancing the start
//   address by 32 bytes), int32 sums in registers, exact. Tile kt's wgmmas
//   stay in flight while the consumer waits for tile kt+1; a slot is
//   released once the wgmmas that read it have completed.
// - Ragged M and N and a K tail (K % 16 == 0) are exact: TMA zero-fills
//   outside the tensor, and zero codes add nothing.
// - The epilogue (a functor of the including kernel: `Epi`) maps each int32
//   sum (and, with Epi::GW, the f32 accumulator of the group-wise mode) to
//   the output type in the kernel's own operation order. Its row and column
//   parameters are read into registers and shared memory before the main
//   loop; the tile is staged per warpgroup in 128-byte-swizzled boxes and
//   leaves by TMA stores that overlap the next tile's main loop (element
//   stores where the output rows fit no tensor map: N * size % 16 != 0).
//   With a residual (Epi::RES, K2's `res + gate * out`), the residual tile
//   arrives by TMA in those staging boxes while the main loop runs (the
//   output's layout: bf16) and each value is written where its residual
//   was read.
// - What bounds it now: the epilogue does not overlap the tensor cores (both
//   consumer warpgroups finish a tile together), which costs most where K
//   is short (K = 1152: nine k-tiles a tile), and the ring's depth (with a
//   slot fewer the loop is markedly slower). A second accumulator set
//   spills at BN = 192, BN = 128 tiles slowed the main loop, and the two
//   warpgroups taking turns on tiles of 64 rows (ping-pong: each alone on
//   the tensor cores, 1.6x the loads) made every case slower.
// - GW folds a k-group that ends at a k-tile's start before that k-tile's
//   wgmmas, so such k-tiles run the plain body; only a k-tile with a group
//   boundary inside it (K / G % 128 != 0) takes a stepwise body.
// - The accumulator fragment of wgmma m64nN: register 4*nt + e of the
//   thread with lane quad g = lane/4, t4 = lane%4, in warp w of its
//   warpgroup holds row 16*w + g + 8*(e >> 1), column 8*nt + 2*t4 + (e & 1)
//   (`acc_row`, `acc_col`; tests/test_torch_gemm.py checks it covers the
//   tile once).
//
// `edge_gemm_kernel` takes what TMA cannot: K not a multiple of 16 (a row
// stride TMA refuses) or a base that is not 16-byte aligned. 128x128 tiles,
// every byte loaded on its own (zero past M, N and K) from A and the
// K-major W^T alike, mma.sync m16n8k32 s8.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "tma.cuh"

namespace vq {
namespace i8mma {

constexpr int BM = 128;       // rows per tile: two consumer warpgroups of 64
constexpr int BK = 128;       // k bytes per ring slot: one 128-byte swizzle row
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int SMEM_LIMIT = 232448;
constexpr int CONSUMER_REGS = 232;  // setmaxnreg: 2 x 128 x 232 +
constexpr int PRODUCER_REGS = 40;   // 128 x 40 = 384 x 168 registers
constexpr int LAUNCH_REGS = 168;    // per thread at launch (384 threads)

template <int BN, typename Out, bool RES = false>
struct Layout {
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK;
  // output staging, per consumer warpgroup 64 rows x BN columns as boxes
  // of 64 rows x 128 bytes in the 128-byte swizzle: the TMA store's source
  // layout, and conflict-free for the fragment's 4- and 8-byte writes
  static constexpr int BOXC = 128 / static_cast<int>(sizeof(Out));
  static constexpr int BOXES = BN / BOXC;
  static constexpr int BOX_BYTES = 64 * 128;
  static constexpr int STG_BYTES = 2 * BOXES * BOX_BYTES;
  static_assert(BN % BOXC == 0, "BN must fill whole output boxes");
  // each consumer warpgroup's copy of the tile's per-column epilogue
  // parameters (Epi::Col, at most 16 bytes a column)
  static constexpr int COL_BYTES = 2 * BN * 16;
  // RES: each consumer warpgroup's gate row of the tile, f32 a column
  static constexpr int GATE_BYTES = RES ? 2 * BN * 4 : 0;
  static constexpr int BAR_BYTES = 128;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - COL_BYTES - GATE_BYTES -
                              BAR_BYTES - STG_BYTES) /
                             STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // + 1024: the dynamic shared memory base is aligned up to 1024 bytes
  // (the 128-byte swizzle atom)
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + STG_BYTES +
                                    COL_BYTES + GATE_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2, "ring too shallow");
  static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0,
                "swizzled tiles must stay 1024-byte aligned");
};

// ---- TMA and wgmma primitives (the mbarriers are in common.cuh, the
// tensor-map encoder and the TMA load in tma.cuh) --------

// shared -> global tile store of one box; completion tracked by bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col0), "r"(row0)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// K-major operand of 8-row x 128-byte swizzled core groups: stride between
// 8-row groups 1024 bytes; the leading offset is unused by this layout
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= a . b^T over k32, both from shared memory; scale_d = 0 overwrites
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a,
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
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[96], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, "
      "%96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}
// accumulator register i of a thread: its row in the warpgroup's 64, and
// its column in the tile
__device__ __forceinline__ int acc_row(int warp, int g, int i) {
  return 16 * warp + g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int t4, int i) {
  return 8 * (i >> 2) + 2 * t4 + (i & 1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
  __nv_bfloat162 v;
  v.x = a;
  v.y = b;
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// GW: fold the finished k-group grp into the f32 accumulator,
// facc + float(acc) * xs[row, grp], in the plain version's order
template <typename Epi, int R>
__device__ __forceinline__ void fold_group(const Epi& epi, float (&facc)[R],
                                           const int (&acc)[R], int r0,
                                           int grp) {
  const float s0 = epi.group_scale(r0, grp);
  const float s1 = epi.group_scale(r0 + 8, grp);
#pragma unroll
  for (int i = 0; i < R; ++i)
    facc[i] = facc[i] + static_cast<float>(acc[i]) * ((i & 2) ? s1 : s0);
}

// ---- the residual (+ gate) epilogue --------------------------------------
//
// K2's and K5's `o = res + gate * out` (fused_matmul.py:383-390, :192-205):
// after the dequant and the bias, in f32, o = o * gate[row / rows_per_gate,
// col] where there is a gate, then o = o + res[row, col], then the
// epilogue's one cast to the output type. res [M, N] and gate [G, N] are
// bf16 (the model's residual stream and adaLN gate). An epilogue with RES
// holds one as `rg`; the kernels read a lane's two columns of a row as one
// 4-byte load (a quad's four lanes: 16 contiguous bytes), the gate's G rows
// from L2. It costs one more [M, N] bf16 read and saves the raw output's
// write and read by a separate add.
struct ResGate {
  const __nv_bfloat16* res;   // [M, N], row-major
  const __nv_bfloat16* gate;  // [G, N] or null (residual only)
  int rows_per_gate;          // M / G
  // the gate at columns col, col + 1 of row (row < M, col < N, col even)
  __device__ __forceinline__ float2 gate2(int row, int col, int N) const {
    return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
        gate + static_cast<size_t>(row / rows_per_gate) * N + col)));
  }
  // res and gate at columns col, col + 1 of row, as gate2 takes them
  __device__ __forceinline__ void load2(int row, int col, int N, float2& r,
                                        float2& g) const {
    r = __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(
        res + static_cast<size_t>(row) * N + col)));
    g = gate != nullptr ? gate2(row, col, N) : make_float2(1.0f, 1.0f);
  }
  __device__ __forceinline__ float apply(float o, float r, float g) const {
    if (gate != nullptr) o = o * g;
    return o + r;
  }
};

// ---- the symmetric epilogue ----------------------------------------------

__device__ __forceinline__ float gelu_tanh(float o) {
  // 0.5 * o * (1 + tanh(sqrt(2/pi) * (o + 0.044715 * o^3))), o^3 = (o*o)*o
  const float o3 = o * o * o;
  return 0.5f * o * (1.0f + tanhf(0.7978845608028654f * (o + 0.044715f * o3)));
}

// K2's sym x sym epilogues (int8_gemm.cu: plain, gw_x, the emission's
// GELU), the plain one also K5's (dynq_gemm.cu). OUT_KIND: 0 = bf16 out,
// 1 = f32 out, 2 = f32 gelu(out) (emission scratch). RES: the residual
// (+ gate) epilogue after the bias (not with the emission).
template <bool GW_, int OUT_KIND, bool RES_ = false>
struct int8_gemm_epilogue {
  using Out = typename std::conditional<OUT_KIND == 0, __nv_bfloat16,
                                        float>::type;
  static constexpr bool GW = GW_;
  static constexpr bool RES = RES_;
  static_assert(!(RES && OUT_KIND == 2), "the emission takes no residual");
  static constexpr int BN = GW ? 128 : 192;
  struct Row {
    float xs;  // the row's scale (G == 1)
  };
  const float* xs;
  int G;
  const float* ws;
  const float* bias;
  void* out;
  int M, N;
  ResGate rg;  // RES only

  __device__ __forceinline__ Row row(int r) const {
    return {(GW || r >= M) ? 0.0f : xs[r]};
  }
  struct alignas(8) Col {
    float ws, b;  // b: the bias, 0 without one (never added then)
  };
  __device__ __forceinline__ Col col(int c) const {
    if (c >= N) return {0.0f, 0.0f};
    return {ws[c], bias != nullptr ? bias[c] : 0.0f};
  }
  __device__ __forceinline__ float group_scale(int r, int grp) const {
    return r < M ? xs[static_cast<size_t>(r) * G + grp] : 0.0f;
  }
  // res, gate: the residual and gate of this entry (RES only)
  __device__ __forceinline__ Out value(int acc, float facc, const Row& r,
                                       const Col& c, float res = 0.0f,
                                       float gate = 1.0f) const {
    float o;
    if constexpr (GW) {
      o = facc * c.ws;
    } else {
      o = static_cast<float>(acc) * (r.xs * c.ws);
    }
    if (bias != nullptr) o = o + c.b;
    if constexpr (RES) o = rg.apply(o, res, gate);
    if constexpr (OUT_KIND == 0) {
      return __float2bfloat16_rn(o);
    } else if constexpr (OUT_KIND == 1) {
      return o;
    } else {
      return gelu_tanh(o);
    }
  }
};

// ---- the zero-point-corrected epilogue ------------------------------------
//
// K7b's epilogue and K2's zero-point modes, one struct. Per row: the act
// scale, zero point, code sum and (float)K * zero point; per column: the
// weight scale, zero point, code sum and the bias. A null zero-point, sum
// or bias table reads as zeros, as the JAX wrapper fills a missing one
// (fused_matmul.py:467-477). Every step rounds in f32 in this order
// (-fmad=false):
//   asym acts: c = float(acc) - xz*wcs - wz*xr + kx*wz;  o = (c*xs)*ws
//   SYM_X    : o = (float(acc) - wz*xr) * (xs*ws)  (K2's sym acts x asym
//              weights, fused_matmul.py:357)
// then the bias. BIAS_AFTER_CAST (K7b): a bf16 output rounds o, adds the
// bias rounded to bf16 and rounds again. Otherwise (K2, :363-364) the f32
// bias is added before the one cast. An f32 output adds it in f32. RES
// (K2 and K5): the residual (+ gate) epilogue after the bias, before the
// cast. GELU (K2's emission with zero points, fused_matmul.py:352-371):
// f32 gelu_tanh(o) after the bias, the emission's scratch.
template <bool F32_OUT, bool BIAS_AFTER_CAST, bool SYM_X, bool RES_ = false,
          bool GELU = false>
struct ZpEpilogue {
  using Out = typename std::conditional<F32_OUT, float, __nv_bfloat16>::type;
  static constexpr bool GW = false;
  static constexpr bool RES = RES_;
  static_assert(!(RES && BIAS_AFTER_CAST), "K7b takes no residual");
  static_assert(!GELU || (F32_OUT && !RES && !BIAS_AFTER_CAST),
                "the GELU scratch is K2's f32 emission, without a residual");
  static constexpr int BN = 192;
  const float* xs;
  const float* xzp;
  const float* xrs;
  const float* ws;
  const float* wzp;
  const float* wcs;
  const float* bias;
  void* out;
  int M, N;
  float kf;    // the true K
  ResGate rg;  // RES only

  struct alignas(16) Row {
    float xs, xz, xr, kx;  // kx = (float)K * xz, the JAX order's product
  };
  struct alignas(16) Col {
    float ws, wz, wcs, b;  // b: 0 without a bias (never added then)
  };
  __device__ __forceinline__ Row row(int r) const {
    if (r >= M) return {0.0f, 0.0f, 0.0f, 0.0f};
    const float z = xzp != nullptr ? xzp[r] : 0.0f;
    return {xs[r], z, xrs != nullptr ? xrs[r] : 0.0f, kf * z};
  }
  __device__ __forceinline__ Col col(int c) const {
    if (c >= N) return {0.0f, 0.0f, 0.0f, 0.0f};
    float b = 0.0f;
    if (bias != nullptr)
      b = (BIAS_AFTER_CAST && !F32_OUT)
              ? __bfloat162float(__float2bfloat16_rn(bias[c])) : bias[c];
    return {ws[c], wzp != nullptr ? wzp[c] : 0.0f,
            wcs != nullptr ? wcs[c] : 0.0f, b};
  }
  __device__ __forceinline__ Out value(int acc, float, const Row& r,
                                       const Col& c, float res = 0.0f,
                                       float gate = 1.0f) const {
    float o;
    if constexpr (SYM_X) {
      o = (static_cast<float>(acc) - c.wz * r.xr) * (r.xs * c.ws);
    } else {
      float v = static_cast<float>(acc) - r.xz * c.wcs;
      v = v - c.wz * r.xr;
      v = v + r.kx * c.wz;
      o = v * r.xs * c.ws;
    }
    if constexpr (BIAS_AFTER_CAST && !F32_OUT) {
      __nv_bfloat16 v = __float2bfloat16_rn(o);
      if (bias != nullptr)
        v = __float2bfloat16_rn(__bfloat162float(v) + c.b);
      return v;
    } else {
      if (bias != nullptr) o = o + c.b;
      if constexpr (RES) o = rg.apply(o, res, gate);
      if constexpr (GELU) {
        return gelu_tanh(o);
      } else if constexpr (F32_OUT) {
        return o;
      } else {
        return __float2bfloat16_rn(o);
      }
    }
  }
};

// ---- the TMA + wgmma kernel ----------------------------------------------
//
// Epi provides: `Out` (bf16 or float), `BN`, `GW` (group-wise activation
// scales: an f32 accumulator folded at every k-group boundary), fields
// `out`, `M`, `N`, a per-row context `Row row(int r)` (r may be >= M),
// a per-column context `Col col(int c)` (c may be >= N),
// `float group_scale(int r, int grp)` (GW),
// `Out value(int acc, float facc, const Row&, const Col&, float res,
// float gate)` and `RES` (then `ResGate rg`, a bf16 output and map_res,
// the residual's map in the output's boxes: each consumer warpgroup's
// residual tile arrives by TMA in its staging boxes while the main loop
// runs, and its gate row in shared memory; the epilogue reads each
// entry's residual where it then writes the output, and hands both to
// value; a warpgroup whose 64 rows straddle two gate rows reads the gate
// from L2).
// kg: the k-group width (GW; a multiple of 32). tma_out: map_out is the
// output's map (rows of 16-byte multiples at a 16-byte aligned base) and
// the tiles leave by TMA stores; else by element stores.
template <typename Epi>
__global__ void __launch_bounds__(THREADS, 1)
    tma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_out,
                    const __grid_constant__ CUtensorMap map_res, const Epi epi,
                    int K, int kg, int tma_out) {
  using Out = typename Epi::Out;
  constexpr int BN = Epi::BN;
  constexpr int R = BN / 2;  // accumulator registers a thread
  using L = Layout<BN, Out, Epi::RES>;
  static_assert(!Epi::RES || sizeof(Out) == 2,
                "the residual tile is staged in the bf16 output's boxes");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t ring = smem_u32(smem);
  uint8_t* col_base = smem + L::STAGES * L::STAGE_BYTES + L::STG_BYTES;
  float* gate_base = reinterpret_cast<float*>(col_base + L::COL_BYTES);
  const uint32_t bars = smem_u32(col_base + L::COL_BYTES + L::GATE_BYTES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (L::STAGES + s); };
  // RES: consumer warpgroup w's residual tile has arrived
  auto res_bar = [&](int w) { return bars + 8 * (2 * L::STAGES + w); };
  const int M = epi.M;
  const int N = epi.N;
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    if constexpr (Epi::RES) {
      mbar_init(res_bar(0), 1);
      mbar_init(res_bar(1), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM;
        const int n0 = tile % tiles_n * BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), L::STAGE_BYTES);
          const uint32_t slot = ring + stage * L::STAGE_BYTES;
          tma_load(slot, &map_a, full(stage), kt * BK, m0);
          tma_load(slot + L::A_BYTES, &map_w, full(stage), kt * BK, n0);
          if (++stage == L::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64*wg .. 64*wg+63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t4 = tid & 3;
    const bool leader = tid == 0;
    uint8_t* stg =
        smem + L::STAGES * L::STAGE_BYTES + wg * L::BOXES * L::BOX_BYTES;
    // the staging place of local row lr, column c (128-byte swizzle: the
    // 16-byte chunk index XOR the row's index in its 8-row group)
    auto stg_at = [&](int lr, int c) {
      const int byte = c * static_cast<int>(sizeof(Out));
      const int in = byte & 127;
      return reinterpret_cast<Out*>(
          stg + (byte >> 7) * L::BOX_BYTES + lr * 128 +
          ((((in >> 4) ^ (lr & 7)) << 4) | (in & 15)));
    };
    using Col = typename Epi::Col;
    static_assert(sizeof(Col) <= 16, "column parameters above 16 bytes");
    Col* cols = reinterpret_cast<Col*>(col_base) + wg * BN;
    float* gate_cols = gate_base + wg * BN;  // RES
    int stage = 0;
    uint32_t phase = 0;
    uint32_t res_phase = 0;  // RES
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * BM;
      const int n0 = tile % tiles_n * BN;
      const int r0 = m0 + 64 * wg + acc_row(warp, g, 0);  // and r0 + 8
      // the epilogue's row and column parameters, loaded now so their
      // latency hides behind the main loop (the previous tile's epilogue
      // has read cols: its second barrier)
      const typename Epi::Row row_lo = epi.row(r0);
      const typename Epi::Row row_hi = epi.row(r0 + 8);
      for (int c = tid; c < BN; c += 128) cols[c] = epi.col(n0 + c);
      // RES: this warpgroup's residual tile into its staging boxes (once
      // the previous tile's stores have read them) and, where its 64 rows
      // share one gate row, that row into shared memory
      bool gate_rows_one = true;
      if constexpr (Epi::RES) {
        const int wrow0 = m0 + 64 * wg;
        if (epi.rg.gate != nullptr) {
          const int rpg = epi.rg.rows_per_gate;
          const int grow = wrow0 / rpg;
          gate_rows_one = grow == min(wrow0 + 63, M - 1) / rpg;
          if (gate_rows_one)
            for (int c = tid; c < BN; c += 128)
              gate_cols[c] =
                  n0 + c < N ? __bfloat162float(epi.rg.gate[
                                   static_cast<size_t>(grow) * N + n0 + c])
                             : 0.0f;
        }
        if (leader) {
          bulk_wait_read();
          mbar_expect_tx(res_bar(wg), L::BOXES * L::BOX_BYTES);
          for (int b = 0; b < L::BOXES; ++b)
            tma_load(smem_u32(stg + b * L::BOX_BYTES), &map_res, res_bar(wg),
                     n0 + b * L::BOXC, wrow0);
        }
      }
      int acc[R];
      float facc[Epi::GW ? R : 1];
      if constexpr (Epi::GW) {
#pragma unroll
        for (int i = 0; i < R; ++i) facc[i] = 0.0f;
      }
      bool fresh = true;  // the next wgmma overwrites acc
      int prev = -1;      // the slot whose wgmmas may still be in flight
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        // GW: a k-group that ends where this k-tile starts is folded before
        // its first wgmma (once the previous k-tile's are done); one that
        // ends inside it (kg % BK != 0) takes the k-tile's stepwise body
        bool inner = false;
        if constexpr (Epi::GW) {
          if (k0 > 0 && k0 % kg == 0) {
            wgmma_wait<0>();
            fence_regs(acc);
            fold_group(epi, facc, acc, r0, k0 / kg - 1);
            fresh = true;
          }
          inner = k0 / kg != (min(k0 + BK, K) - 1) / kg;
        }
        mbar_wait(full(stage), phase);
        const uint32_t a = ring + stage * L::STAGE_BYTES + wg * 64 * BK;
        const uint32_t b = ring + stage * L::STAGE_BYTES + L::A_BYTES;
        wgmma_fence();
        if (!inner) {
#pragma unroll
          for (int s = 0; s < BK / 32; ++s) {
            if (k0 + s * 32 >= K) break;
            wgmma_s8(acc, sw128_desc(a + s * 32), sw128_desc(b + s * 32),
                     fresh ? 0 : 1);
            fresh = false;
          }
        } else if constexpr (Epi::GW) {
#pragma unroll
          for (int s = 0; s < BK / 32; ++s) {
            const int kk = k0 + s * 32;
            if (kk >= K) break;
            if (s > 0 && kk % kg == 0) {
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(acc);
              fold_group(epi, facc, acc, r0, kk / kg - 1);
              fresh = true;
              wgmma_fence();
            }
            wgmma_s8(acc, sw128_desc(a + s * 32), sw128_desc(b + s * 32),
                     fresh ? 0 : 1);
            fresh = false;
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous slot's wgmmas are done
        if (prev >= 0 && leader) mbar_arrive(empty(prev));
        prev = stage;
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (leader) mbar_arrive(empty(prev));
      if constexpr (Epi::GW) fold_group(epi, facc, acc, r0, (K - 1) / kg);

      // ---- epilogue: values into the staging boxes, then TMA stores
      if (leader && tma_out) bulk_wait_read();  // the last stores read stg
      named_sync(1 + wg, 128);  // ... and cols are written
      if constexpr (Epi::RES) {  // the residual tile is in stg
        mbar_wait(res_bar(wg), res_phase);
        res_phase ^= 1;
      }
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        // registers 4nt .. 4nt+3: columns c, c+1 of rows r0 and r0 + 8
        const int c = acc_col(t4, 4 * nt);
        const Col c0 = cols[c];
        const Col c1 = cols[c + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * nt + 2 * h;
          const typename Epi::Row& rw = h ? row_hi : row_lo;
          const float f0 = Epi::GW ? facc[Epi::GW ? i : 0] : 0.0f;
          const float f1 = Epi::GW ? facc[Epi::GW ? i + 1 : 0] : 0.0f;
          Out* at = stg_at(acc_row(warp, g, i), c);
          float2 res = make_float2(0.0f, 0.0f), gate = make_float2(1.0f, 1.0f);
          if constexpr (Epi::RES) {
            res = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(at));
            if (epi.rg.gate != nullptr) {
              if (gate_rows_one)
                gate = *reinterpret_cast<const float2*>(gate_cols + c);
              else if (r0 + 8 * h < M && n0 + c < N)
                gate = epi.rg.gate2(r0 + 8 * h, n0 + c, N);
            }
          }
          store2(at, epi.value(acc[i], f0, rw, c0, res.x, gate.x),
                 epi.value(acc[i + 1], f1, rw, c1, res.y, gate.y));
        }
      }
      fence_proxy_async();  // the staging writes, visible to TMA
      named_sync(1 + wg, 128);
      const int row0 = m0 + 64 * wg;
      if (tma_out) {
        if (leader) {
#pragma unroll
          for (int b = 0; b < L::BOXES; ++b)
            tma_store(&map_out, smem_u32(stg + b * L::BOX_BYTES),
                      n0 + b * L::BOXC, row0);
          bulk_commit();
        }
      } else {
        Out* out = static_cast<Out*>(epi.out);
        for (int idx = tid; idx < 64 * BN; idx += 128) {
          const int lr = idx / BN;
          const int c = idx % BN;
          if (row0 + lr < M && n0 + c < N)
            out[static_cast<size_t>(row0 + lr) * N + n0 + c] = *stg_at(lr, c);
        }
      }
    }
    if (leader && tma_out) bulk_wait();
  }
}

// ---- the byte-wise kernel ------------------------------------------------

constexpr int EDGE_TILE = 128;
constexpr int EDGE_BK = 64;
constexpr int EDGE_LDS = EDGE_BK + 16;  // padded shared row, bytes
constexpr int EDGE_THREADS = 256;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 128x128 tile a block (8 warps of 64x32); acc[mi][ni][e] of warp
// (wm = warp/4, wn = warp%4) is row wm*64 + mi*16 + g + 8*(e >= 2), column
// wn*32 + ni*8 + 2*t4 + (e & 1). Epi as above (GW not taken).
template <typename Epi>
__global__ void __launch_bounds__(EDGE_THREADS)
    edge_gemm_kernel(const int8_t* __restrict__ A,
                     const int8_t* __restrict__ Wt, const Epi epi, int K) {
  static_assert(!Epi::GW, "the byte-wise kernel has no group-wise mode");
  static_assert(!Epi::RES, "the byte-wise kernel has no residual epilogue");
  __shared__ __align__(16) int8_t as[EDGE_TILE * EDGE_LDS];
  __shared__ __align__(16) int8_t bs[EDGE_TILE * EDGE_LDS];
  const int M = epi.M;
  const int N = epi.N;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m0 = blockIdx.y * EDGE_TILE;
  const int n0 = blockIdx.x * EDGE_TILE;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int k0 = 0; k0 < K; k0 += EDGE_BK) {
    for (int idx = tid; idx < EDGE_TILE * EDGE_BK; idx += EDGE_THREADS) {
      const int r = idx / EDGE_BK;
      const int k = idx % EDGE_BK;
      const bool kin = k0 + k < K;
      as[r * EDGE_LDS + k] =
          (m0 + r < M && kin) ? A[static_cast<size_t>(m0 + r) * K + k0 + k]
                              : int8_t(0);
      bs[r * EDGE_LDS + k] =
          (n0 + r < N && kin) ? Wt[static_cast<size_t>(n0 + r) * K + k0 + k]
                              : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < EDGE_BK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* ap = as + (wm * 64 + mi * 16 + g) * EDGE_LDS + kk + t4 * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * EDGE_LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * EDGE_LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* bp = bs + (wn * 32 + ni * 8 + g) * EDGE_LDS + kk + t4 * 4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(bp);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }
  using Out = typename Epi::Out;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
      if (row >= M) continue;
      const typename Epi::Row rw = epi.row(row);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + t4 * 2 + (e & 1);
        if (col < N)
          static_cast<Out*>(epi.out)[static_cast<size_t>(row) * N + col] =
              epi.value(acc[mi][ni][e], 0.0f, rw, epi.col(col));
      }
    }
}

// ---- host side -----------------------------------------------------------

// the map of a row-major int8 [rows, K] matrix in boxes of [box_rows, BK]
// bytes, 128-byte swizzle, zero fill outside
inline bool encode_map(CUtensorMap* map, const void* base, int rows, int K,
                       int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the map of the row-major output [M, N] in boxes of 64 rows x 128 bytes
template <typename Out>
bool encode_out_map(CUtensorMap* map, void* out, int M, int N) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  constexpr int E = static_cast<int>(sizeof(Out));
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * E};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / E), 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, out, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA takes 16-byte aligned bases and row strides
inline bool tma_ok(const void* A, const void* Wt, int K) {
  return K % 16 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(Wt) % 16 == 0;
}

// the residual epilogue's tables as the entry points take them, checked:
// res [M, N] bf16 (4-byte aligned) or null (no residual epilogue), gate
// [G, N] bf16 (4-byte aligned) or null, rows_per_gate = M / G > 0 (the
// caller holds M % G == 0)
inline bool res_gate(const void* res, const void* gate, int rows_per_gate,
                     ResGate* rg) {
  *rg = {static_cast<const __nv_bfloat16*>(res),
         static_cast<const __nv_bfloat16*>(gate), rows_per_gate};
  return res == nullptr ||
         (reinterpret_cast<uintptr_t>(res) % 4 == 0 &&
          reinterpret_cast<uintptr_t>(gate) % 4 == 0 &&
          (gate == nullptr || rows_per_gate > 0));
}

// A [M, K] int8 row-major, Wt [N, K] int8 (the K-major weight); M, N in epi
template <typename Epi>
cudaError_t launch_tma(const int8_t* A, const int8_t* Wt, const Epi& epi,
                       int K, int kg, cudaStream_t st) {
  using L = Layout<Epi::BN, typename Epi::Out, Epi::RES>;
  auto kernel = tma_gemm_kernel<Epi>;
  static cudaError_t prepared = cudaErrorNotReady;
  if (prepared == cudaErrorNotReady) {
    cudaFuncAttributes fa;
    prepared = cudaFuncGetAttributes(&fa, kernel);
    // setmaxnreg only moves registers within the block's launch
    // allocation, which must hold the consumers' and producer's shares
    if (prepared == cudaSuccess && fa.numRegs < LAUNCH_REGS)
      prepared = cudaErrorInvalidDeviceFunction;
    if (prepared == cudaSuccess)
      prepared = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  }
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap map_a, map_w;
  if (!encode_map(&map_a, A, epi.M, K, BM) ||
      !encode_map(&map_w, Wt, epi.N, K, Epi::BN))
    return cudaErrorInvalidValue;
  using Out = typename Epi::Out;
  CUtensorMap map_out{};
  const int tma_out =
      (static_cast<size_t>(epi.N) * sizeof(Out)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(epi.out) % 16 == 0 &&
      encode_out_map<Out>(&map_out, epi.out, epi.M, epi.N);
  // RES: the residual in the output's boxes (the staging layout); it takes
  // the output's TMA stores and a 16-byte aligned residual
  CUtensorMap map_res = map_out;
  if constexpr (Epi::RES) {
    if (!tma_out || reinterpret_cast<uintptr_t>(epi.rg.res) % 16 != 0 ||
        !encode_out_map<Out>(&map_res, const_cast<__nv_bfloat16*>(epi.rg.res),
                             epi.M, epi.N))
      return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (epi.M + BM - 1) / BM * ((epi.N + Epi::BN - 1) / Epi::BN);
  kernel<<<tiles < sms ? tiles : sms, THREADS, L::SMEM_BYTES, st>>>(
      map_a, map_w, map_out, map_res, epi, K, kg, tma_out);
  return cudaGetLastError();
}

template <typename Epi>
cudaError_t launch_edge(const int8_t* A, const int8_t* Wt, const Epi& epi,
                        int K, cudaStream_t st) {
  dim3 grid((epi.N + EDGE_TILE - 1) / EDGE_TILE,
            (epi.M + EDGE_TILE - 1) / EDGE_TILE);
  edge_gemm_kernel<Epi><<<grid, EDGE_THREADS, 0, st>>>(A, Wt, epi, K);
  return cudaGetLastError();
}

}  // namespace i8mma
}  // namespace vq
