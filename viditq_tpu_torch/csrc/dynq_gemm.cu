// K5: quantize-in int8 matmul, one launch: out[M, N] = epilogue(q(x)[M, K]
// . W[K, N]), x bf16 or f32, the row codes made inside the GEMM.
//
// Replaces the TPU kernel `fused_dynq_int8_matmul` / `_dynq_mm_kernel`
// (viditq_tpu/kernels/fused_matmul.py:144-309). Per row: with a column
// scale (`has_csc`, :167-168: the layer's channel-balancing 1/cs), x *
// cs[k] in f32 first (RowQuant::balance, as K4 applies it); the statistic
// over the whole K, the codes of K4's
// quantizer (common.cuh RowQuant: the same IEEE divisions and
// round(x * (1/s)); quant_rows.cu), the code row sum where the epilogue
// needs it (asym acts, or sym acts on asym weights); then the int8 GEMM with
// exact int32 sums and K2's epilogues (int8_mma.cuh: int8_gemm_epilogue for
// sym x sym, ZpEpilogue for the zero-point modes), the f32 bias added before
// the cast; with a residual (+ gate), `o = res + gate * out` after the
// bias (int8_mma.cuh ResGate, :192-205; bf16 x and out, no column scale).
// So the output equals K4 then K2 bit for bit. The residual epilogue reads
// each lane's residual and gate pairs from global memory in the epilogue
// (no shared memory is left at K = 1152 to stage them, as K2 does): at
// q_linear's shape on an H100 it costs 0.22 ms a call (PERF.md); no model
// path of the port sends a residual to K5.
//
// Bound on the card: the bytes at kv_linear and, at q_linear ([32768, 1152]
// x [1152, 1152]), about evenly bytes (x in and out in bf16: 151 MB, 0.045
// ms) and the int8 tensor cores (87 GOP, 0.044 ms). What the design does:
// - The codes never reach HBM. A work unit is one M tile of BM = 128 rows
//   and a run of N tiles of BN = 192 columns. Its two consumer warpgroups
//   quantize their 64 rows each into shared memory once (a warp per row, 16
//   rows a warp, the next row's 16-byte loads in flight while this row is
//   packed; bf16 statistics two values an instruction), in the byte layout
//   TMA's 128-byte swizzle writes and the wgmma descriptor reads: k-tile kt
//   of 128 bytes at kt * BM * 128, row r at r * 128 in it, its 16-byte chunk
//   j at ((j ^ (r & 7)) * 16). The codes then stay resident while the unit
//   walks its N tiles, so x is read once (q_linear: one unit is all six N
//   tiles of an M tile).
// - W^T [N, K] arrives as in the core (int8_mma.cuh): one producer thread,
//   TMA k-tiles [192, 128] into a ring of 3 slots on full/empty mbarriers,
//   which it fills for the unit's first N tile while the consumers
//   quantize. A K or base that TMA refuses (K % 16 != 0) is loaded by the
//   whole producer warpgroup byte by byte into the same layout.
// - The consumers run wgmma m64n192k32 s32.s8.s8 as the core does and store
//   the epilogue's values from registers (no staging: the resident codes
//   leave no room for it at K = 1152), each lane one contiguous run of 8
//   columns after an exchange in its quad. x is loaded and the output
//   stored with evict-first hints (each is touched once), which keeps the
//   weight's k-tiles, read by every unit, in L2.
// - Shared memory holds 128 x K bytes of codes up to K = 1152 (nine
//   k-tiles; with the ring, the column parameters and the row tables,
//   230,016 of 232,448 bytes). Wider K (fc2's 4608, which JAX's K5 takes
//   with full-K blocks) runs the wide schedule, a simple one: a first sweep
//   of the M tile's rows for each row's statistic over the whole K
//   (`row_stats`), then for every N tile a k loop that quantizes each
//   128-byte k-tile with the known scale into one of two code slots
//   (`quantize_ktile`) and feeds the same wgmma, the row sums summed on the
//   way. Its codes, and so its output, are those of the resident schedule;
//   x is read once more an N tile (from L2 where it stays there).
// - Rows of x that are not 16-byte aligned (K = 1004 in bf16) and N % 16 !=
//   0 are padded by the wrapper (`ldx`; zero columns of W^T); the padding is
//   kept out of every row statistic and row sum (codes past K are zero).
// - Few M tiles (kv_linear: 240 rows, two tiles) would leave most SMs idle:
//   the wrapper splits each M tile's N tiles into `nsplit` runs, one unit
//   each (kv_linear: 12 runs of one tile), and each unit quantizes its M
//   tile again (from L2).
// - What bounds it (PERF.md): a unit's quantize does not overlap the
//   previous unit's wgmmas (a second code buffer does not fit at K =
//   1152): at q_linear the first wave of units reads x from HBM at once,
//   and at few rows (kv_linear) each unit's 16 rows a warp take longer than
//   its one N tile; the epilogue does not overlap the tensor cores and its
//   stores leave from registers. Measured on the card and not kept, none
//   faster at q_linear: an L2 prefetch of the next unit's rows; two or four
//   rows' loads in flight at once; codes rounded on the f32 pipe; 64-row
//   units with two code buffers, quantized by the producer warpgroup (each
//   consumer warpgroup on 96 columns); the codes in two global scratch
//   slabs a block, read by TMA as K2 reads A, quantized a unit ahead by the
//   producer warpgroup or by the consumers between their wgmmas (register
//   spills), with 192- or 128-column tiles.
//
// Build: the f32-x instantiations compile in a translation unit of their
// own (parts/dynq_gemm_f32.cu includes this file with VQ_K5_F32 set and
// defines `vq_k5_launch_f32`), in parallel with the bf16 ones here.
#include <cstring>

#include "int8_mma.cuh"

namespace {

using vq::i8mma::BK;
using vq::i8mma::BM;
using vq::i8mma::THREADS;

constexpr int BN = 192;        // output columns a tile
constexpr int STAGES = 3;      // W^T ring slots
constexpr int MAX_KT = 9;      // k-tiles of codes resident: K <= 1152
constexpr int CH = 16;         // elements a chunk: one 16-byte code store
constexpr int CPT = 3;         // chunks a lane: 32 * 3 * 16 >= K
constexpr int STAGE_BYTES = BN * BK;
constexpr int CODE_TILE = BM * BK;  // one k-tile of the M tile's codes
constexpr int COL_BYTES = 2 * BN * 16;
constexpr int ROW_BYTES = 3 * BM * 4;
constexpr int BAR_BYTES = 128;
static_assert(32 * CPT * CH >= MAX_KT * BK, "a lane's chunks cover a row");

// + 1024: the dynamic shared memory base is aligned up to 1024 bytes
constexpr int smem_bytes(int nkt) {
  return 1024 + nkt * CODE_TILE + STAGES * STAGE_BYTES + COL_BYTES +
         ROW_BYTES + BAR_BYTES;
}
static_assert(smem_bytes(MAX_KT) <= vq::i8mma::SMEM_LIMIT, "codes too wide");

// the place of code byte (row r, k) in the M tile's codes
__device__ __forceinline__ int code_at(int r, int k) {
  return (k >> 7) * CODE_TILE + r * BK + ((((k >> 4) & 7) ^ (r & 7)) << 4) +
         (k & 15);
}

// the epilogue's row tables point at the unit's rows in shared memory (its
// row(r) is then read with the row's index in the tile)
template <bool GW, int OUT_KIND, bool RES>
__device__ __forceinline__ void bind_rows(
    vq::i8mma::int8_gemm_epilogue<GW, OUT_KIND, RES>& e, const float* s,
    const float*, const float*) {
  e.xs = s;
}
template <bool F32_OUT, bool BIAS_AFTER_CAST, bool SYM_X, bool RES>
__device__ __forceinline__ void bind_rows(
    vq::i8mma::ZpEpilogue<F32_OUT, BIAS_AFTER_CAST, SYM_X, RES>& e,
    const float* s, const float* z, const float* r) {
  e.xs = s;
  e.xzp = SYM_X ? nullptr : z;
  e.xrs = r;
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// two adjacent outputs as raw bits (bf16: one word, f32: two)
template <typename Out>
using Pair = typename std::conditional<sizeof(Out) == 2, uint32_t, uint2>::type;

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return bits(a) | (bits(b) << 16);
}
__device__ __forceinline__ uint2 pack2(float a, float b) {
  return make_uint2(bits(a), bits(b));
}

__device__ __forceinline__ uint32_t shfl(uint32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ uint2 shfl(uint2 v, int src) {
  return make_uint2(__shfl_sync(0xffffffffu, v.x, src),
                    __shfl_sync(0xffffffffu, v.y, src));
}

// in[j] of quad lane t4: columns 2*t4, 2*t4 + 1 of 8-column block j; out[s]
// of lane t4: columns 2*s, 2*s + 1 of block t4. Round k: every lane sends
// its in[(t4 - k) & 3] and takes lane (t4 + k) & 3's (registers chosen by
// selects, never by a dynamic index)
template <typename P>
__device__ __forceinline__ void quad_transpose(const P (&in)[4], P (&out)[4],
                                               int t4, int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = in[j];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int send = (t4 - k) & 3;
    const P v = send == 0 ? in[0] : send == 1 ? in[1] : send == 2 ? in[2]
                                                                   : in[3];
    const int src = (t4 + k) & 3;
    const P r = shfl(v, (lane & ~3) | src);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = src == j ? r : out[j];
  }
}

// eight outputs, 16-byte aligned, streamed (st.global.cs: evict first, so
// the output does not push the weight's k-tiles out of L2)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const uint32_t (&q)[4]) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(q[0], q[1], q[2], q[3]));
}
__device__ __forceinline__ void store8(float* p, const uint2 (&q)[4]) {
  uint4* d = reinterpret_cast<uint4*>(p);
  __stcs(d, make_uint4(q[0].x, q[0].y, q[1].x, q[1].y));
  __stcs(d + 1, make_uint4(q[2].x, q[2].y, q[3].x, q[3].y));
}

// the raw 16-byte vectors of chunk c of a row (zeros past K or for a dead
// row), streamed (ld.global.cs: x is read once); rows are 16-byte aligned
template <typename T>
__device__ __forceinline__ void load_chunk(uint4 (&raw)[CH * sizeof(T) / 16],
                                           const T* xr, int c, int K,
                                           bool live) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPC = CH / VEC;
#pragma unroll
  for (int u = 0; u < VPC; ++u) {
    raw[u] = make_uint4(0u, 0u, 0u, 0u);
    if (live && c * CH + u * VEC < K)
      raw[u] = __ldcs(reinterpret_cast<const uint4*>(xr) + c * VPC + u);
  }
}

// One warp quantizes tile rows lr0 .. lr0 + n - 1 (global rows m0 + lr) into
// the codes and the row tables (scale, zero point, code sum); rows past M
// and k past K get zero codes. CS: each value times its column scale cs[k]
// first, the product formed twice, for the statistic and for the code (the
// same rounded product both times). A lane's columns are the same in every
// row: with bf16 x it loads their scales once (CPT * CH registers, free
// while the accumulators are not live); f32 x, whose rows take twice the
// registers, reads them from L1 at each use instead (no spills).
template <typename T, bool SYM, bool ROWSUM, bool CS>
__device__ __forceinline__ void quantize_rows(
    const T* __restrict__ x, const float* __restrict__ cs, uint8_t* codes,
    float* row_s, float* row_z, float* row_r, int m0, int lr0, int n, int M,
    int K, int ldx, int nkt, int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPC = CH / VEC;
  const int nchunk = (K + CH - 1) / CH;
  const int tchunk = nkt * (BK / CH);  // chunks the k-tiles hold
  // this lane's column scales, 0 past K (rows are 16-byte aligned, so
  // K % 4 == 0 and a float4 never crosses K)
  constexpr bool CS_REGS = CS && sizeof(T) == 2;
  float csr[CS_REGS ? CPT : 1][CS_REGS ? CH : 1];
  if constexpr (CS_REGS) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int e = 0; e < CH; e += 4) {
        const float4 s = vq::RowQuant::col_scales4(
            cs, (lane + 32 * i) * CH + e, K, true);
        csr[i][e] = s.x;
        csr[i][e + 1] = s.y;
        csr[i][e + 2] = s.z;
        csr[i][e + 3] = s.w;
      }
  }
  // element e of chunk i of a row, as the quantizer takes it
  const auto val = [&](const uint4 (&r)[CPT][VPC], int i, int e) {
    const float v = vq::elem<T>(r[i][e / VEC], e % VEC);
    if constexpr (CS_REGS) return vq::RowQuant::balance(v, csr[i][e]);
    if constexpr (CS) {
      const int col = (lane + 32 * i) * CH + e;
      return vq::RowQuant::balance(v, col < K ? __ldg(cs + col) : 0.0f);
    }
    return v;
  };
  uint4 next[CPT][VPC];
  auto load_row = [&](int lr) {
    const int row = m0 + lr;
    const T* xr = x + static_cast<size_t>(row) * ldx;
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      load_chunk<T>(next[i], xr, lane + 32 * i, K, row < M);
  };
  load_row(lr0);
  for (int j = 0; j < n; ++j) {
    const int lr = lr0 + j;
    const bool live = m0 + lr < M;
    uint4 raw[CPT][VPC];
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int u = 0; u < VPC; ++u) raw[i][u] = next[i][u];
    if (j + 1 < n) load_row(lr + 1);
    float lo = 0.0f;  // asym: min(x, 0)
    float hi = 0.0f;  // asym: max(x, 0); sym: absmax (0 padding moves neither)
    if constexpr (CS) {
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int e = 0; e < CH; ++e) {
          const float v = val(raw, i, e);
          if constexpr (SYM) {
            hi = fmaxf(hi, fabsf(v));
          } else {
            lo = fminf(lo, v);
            hi = fmaxf(hi, v);
          }
        }
    } else if constexpr (sizeof(T) == 2) {
      // two bf16 at a time: their max, min and |x| are exact, so the
      // statistic is the one of the f32 values (as K4 takes it)
      __nv_bfloat162 l2 = __float2bfloat162_rn(0.0f), h2 = l2;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int u = 0; u < VPC; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t wv = vq::word(raw[i][u], q);
            const __nv_bfloat162 v =
                *reinterpret_cast<const __nv_bfloat162*>(&wv);
            if constexpr (SYM) {
              h2 = __hmax2(h2, __habs2(v));
            } else {
              l2 = __hmin2(l2, v);
              h2 = __hmax2(h2, v);
            }
          }
      hi = fmaxf(__low2float(h2), __high2float(h2));
      lo = fminf(__low2float(l2), __high2float(l2));
    } else {
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int u = 0; u < VPC; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float v = vq::elem<T>(raw[i][u], e);
            if constexpr (SYM) {
              hi = fmaxf(hi, fabsf(v));
            } else {
              lo = fminf(lo, v);
              hi = fmaxf(hi, v);
            }
          }
    }
    hi = vq::warp_max(hi);
    if constexpr (!SYM) lo = vq::warp_min(lo);
    const vq::RowQuant rq =
        SYM ? vq::RowQuant::sym(hi) : vq::RowQuant::asym(lo, hi);
    int sum = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = lane + 32 * i;
      if (c >= tchunk) continue;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (live && c < nchunk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = val(raw, i, 4 * q + e);
          w[q] = rq.pack4<SYM>(f);
        }
        const int nv = min(CH, K - c * CH);  // codes of this chunk in the row
        if (nv < CH) {  // the row's ragged end: no code past K, none summed
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int b = nv - 4 * q;
            w[q] &= b >= 4 ? 0xffffffffu : b <= 0 ? 0u : (1u << (8 * b)) - 1u;
          }
        }
        if constexpr (ROWSUM) {
#pragma unroll
          for (int q = 0; q < 4; ++q) sum = vq::sum_s8x4(w[q], sum);
        }
      }
      *reinterpret_cast<uint4*>(codes + code_at(lr, c * CH)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    if constexpr (ROWSUM) sum = vq::warp_sum_int(sum);
    if (lane == 0) {
      row_s[lr] = rq.s;
      row_z[lr] = rq.zp;
      row_r[lr] = static_cast<float>(sum);
    }
  }
}

// Wide K (K > MAX_KT * BK: the M tile's codes do not fit in shared memory).
// First sweep: one warp takes tile rows lr0 .. lr0 + 15 and writes each
// row's scale and zero point from the statistic over the whole K (the same
// values and the same min/max as quantize_rows: x * cs[k] where CS, the
// range holding 0, so the 16-byte padding of a row past K moves nothing).
template <typename T, bool SYM, bool CS>
__device__ __forceinline__ void row_stats(const T* __restrict__ x,
                                          const float* __restrict__ cs,
                                          float* row_s, float* row_z, int m0,
                                          int lr0, int M, int K, int ldx,
                                          int lane) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPC = CH / VEC;
  const int nchunk = (K + CH - 1) / CH;
  for (int j = 0; j < 16; ++j) {
    const int lr = lr0 + j;
    const int row = m0 + lr;
    const T* xr = x + static_cast<size_t>(row) * ldx;
    float lo = 0.0f, hi = 0.0f;
    for (int c = lane; c < nchunk; c += 32) {
      uint4 raw[VPC];
      load_chunk<T>(raw, xr, c, K, row < M);
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        float v = vq::elem<T>(raw[e / VEC], e % VEC);
        if constexpr (CS) {
          const int col = c * CH + e;
          v = vq::RowQuant::balance(v, col < K ? __ldg(cs + col) : 0.0f);
        }
        if constexpr (SYM) {
          hi = fmaxf(hi, fabsf(v));
        } else {
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
    }
    hi = vq::warp_max(hi);
    if constexpr (!SYM) lo = vq::warp_min(lo);
    const vq::RowQuant rq =
        SYM ? vq::RowQuant::sym(hi) : vq::RowQuant::asym(lo, hi);
    if (lane == 0) {
      row_s[lr] = rq.s;
      row_z[lr] = rq.zp;
    }
  }
}

// Wide K, then per k-tile: one warp writes the codes of k-tile kt of tile
// rows lr0 .. lr0 + 15 into one code slot (the layout of code_at with k
// inside the tile), each lane chunk lane % 8 of rows lr0 + lane / 8 + 4i,
// with the row's known scale (inv = 1 / s, the quantizer's own division);
// codes past K and of dead rows are zero. rsum[i]: this lane's running
// code sum of its row i.
template <typename T, bool SYM, bool ROWSUM, bool CS>
__device__ __forceinline__ void quantize_ktile(
    const T* __restrict__ x, const float* __restrict__ cs, uint8_t* slot,
    const float* row_s, const float* row_z, int m0, int lr0, int M, int K,
    int ldx, int kt, int lane, int (&rsum)[4]) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPC = CH / VEC;
  const int jc = lane & 7;
  const int c = kt * (BK / CH) + jc;  // the chunk's index in the row
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int lr = lr0 + (lane >> 3) + 4 * i;
    const int row = m0 + lr;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < M && c * CH < K) {
      uint4 raw[VPC];
      load_chunk<T>(raw, x + static_cast<size_t>(row) * ldx, c, K, true);
      const float s = row_s[lr];
      const vq::RowQuant rq{s, 1.0f / s, row_z[lr]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int el = 4 * q + e;
          f[e] = vq::elem<T>(raw[el / VEC], el % VEC);
          if constexpr (CS) {
            const int col = c * CH + el;
            f[e] = vq::RowQuant::balance(f[e],
                                         col < K ? __ldg(cs + col) : 0.0f);
          }
        }
        w[q] = rq.pack4<SYM>(f);
      }
      const int nv = min(CH, K - c * CH);  // codes of this chunk in the row
      if (nv < CH) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int b = nv - 4 * q;
          w[q] &= b >= 4 ? 0xffffffffu : b <= 0 ? 0u : (1u << (8 * b)) - 1u;
        }
      }
      if constexpr (ROWSUM) {
#pragma unroll
        for (int q = 0; q < 4; ++q) rsum[i] = vq::sum_s8x4(w[q], rsum[i]);
      }
    }
    *reinterpret_cast<uint4*>(slot + code_at(lr, jc * CH)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A persistent block walks the units blockIdx.x, + gridDim.x, ...; unit u
// is M tile u / nsplit and its run u % nsplit of ceil(tiles_n / nsplit) N
// tiles. ROWSUM: the epilogue reads the code row sums. tma_w: map_w is
// W^T's map, else the producer warpgroup loads W^T. ldx: x's row stride
// (elements, 16-byte rows). WIDE (K > MAX_KT * BK): the row statistics
// first, then each N tile quantizes k-tile by k-tile into two code slots
// (x is read once for the statistic and once an N tile).
template <typename T, bool SYM, bool ROWSUM, bool CS, bool WIDE, typename Epi>
__global__ void __launch_bounds__(THREADS, 1)
    dynq_gemm_kernel(const T* __restrict__ x, const float* __restrict__ cs,
                     const __grid_constant__ CUtensorMap map_w,
                     const int8_t* __restrict__ wt, const Epi epi, int K,
                     int ldx, int nsplit, int tma_w) {
  using Out = typename Epi::Out;
  using namespace vq;
  using namespace vq::i8mma;
  constexpr int R = BN / 2;  // accumulator registers a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int M = epi.M;
  const int N = epi.N;
  const int nkt = (K + BK - 1) / BK;
  uint8_t* codes = smem;
  const uint32_t codes_u = smem_u32(codes);
  uint8_t* ring_p = codes + (WIDE ? 2 : nkt) * CODE_TILE;
  const uint32_t ring = smem_u32(ring_p);
  uint8_t* col_base = ring_p + STAGES * STAGE_BYTES;
  float* row_s = reinterpret_cast<float*>(col_base + COL_BYTES);
  float* row_z = row_s + BM;
  float* row_r = row_z + BM;
  const uint32_t bars = smem_u32(row_r + BM);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tiles_n = (N + BN - 1) / BN;
  const int run = (tiles_n + nsplit - 1) / nsplit;  // N tiles a unit
  const int units = (M + BM - 1) / BM * nsplit;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // ---- producer: W^T k-tiles into the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = threadIdx.x - 2 * 128;
    if (!tma_w || pt == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        const int part = unit % nsplit;
        const int tn_end = min((part + 1) * run, tiles_n);
        for (int tn = part * run; tn < tn_end; ++tn) {
          const int n0 = tn * BN;
          for (int kt = 0; kt < nkt; ++kt) {
            mbar_wait(empty(stage), phase ^ 1);
            if (tma_w) {
              mbar_expect_tx(full(stage), STAGE_BYTES);
              tma_load(ring + stage * STAGE_BYTES, &map_w, full(stage),
                       kt * BK, n0);
            } else {
              uint8_t* dst = ring_p + stage * STAGE_BYTES;
              for (int idx = pt; idx < STAGE_BYTES; idx += 128) {
                const int n = idx / BK;
                const int k = idx % BK;
                const int gk = kt * BK + k;
                dst[code_at(n, k)] =
                    (n0 + n < N && gk < K)
                        ? static_cast<uint8_t>(
                              wt[static_cast<size_t>(n0 + n) * K + gk])
                        : uint8_t(0);
              }
              fence_proxy_async();  // the writes, visible to wgmma
              named_sync(3, 128);
              if (pt == 0) mbar_arrive(full(stage));
            }
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows 64*wg .. 64*wg+63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t4 = lane & 3;
    const bool leader = tid == 0;
    using Col = typename Epi::Col;
    static_assert(sizeof(Col) <= 16, "column parameters above 16 bytes");
    Col* cols = reinterpret_cast<Col*>(col_base) + wg * BN;
    Out* out = static_cast<Out*>(epi.out);
    const int lr = 64 * wg + acc_row(warp, g, 0);  // and lr + 8
    int stage = 0;
    uint32_t phase = 0;
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      const int m0 = unit / nsplit * BM;
      const int part = unit % nsplit;
      // this warpgroup's rows of the unit's codes, or (WIDE) their scales
      // and zero points (its own wgmmas of the previous unit, the only
      // readers of them, have completed)
      if constexpr (WIDE)
        row_stats<T, SYM, CS>(x, cs, row_s, row_z, m0, 64 * wg + 16 * warp,
                              M, K, ldx, lane);
      else
        quantize_rows<T, SYM, ROWSUM, CS>(x, cs, codes, row_s, row_z, row_r,
                                          m0, 64 * wg + 16 * warp, 16, M, K,
                                          ldx, nkt, lane);
      fence_proxy_async();  // the codes, visible to wgmma
      named_sync(1 + wg, 128);
      typename Epi::Row row_lo, row_hi;
      // the epilogue's row parameters, read from the tile's row tables
      // (WIDE: once an N tile, after its k loop has summed the codes)
      const auto read_rows = [&]() {
        Epi e = epi;
        bind_rows(e, row_s, row_z, row_r);
        e.M = min(BM, M - m0);
        row_lo = e.row(lr);
        row_hi = e.row(lr + 8);
      };
      if constexpr (!WIDE) read_rows();
      const int tn_end = min((part + 1) * run, tiles_n);
      for (int tn = part * run; tn < tn_end; ++tn) {
        const int n0 = tn * BN;
        for (int c = tid; c < BN; c += 128) cols[c] = epi.col(n0 + c);
        int acc[R];
        int rsum[4] = {0, 0, 0, 0};  // WIDE: this lane's rows' code sums
        bool fresh = true;  // the next wgmma overwrites acc
        int prev = -1;      // the slot whose wgmmas may still be in flight
        for (int kt = 0; kt < nkt; ++kt) {
          const int k0 = kt * BK;
          uint32_t a = codes_u + kt * CODE_TILE + wg * 64 * BK;
          if constexpr (WIDE) {
            // slot kt & 1 was last read by k-tile kt - 2's wgmmas, done
            // at the wait below of iteration kt - 1
            quantize_ktile<T, SYM, ROWSUM, CS>(
                x, cs, codes + (kt & 1) * CODE_TILE, row_s, row_z, m0,
                64 * wg + 16 * warp, M, K, ldx, kt, lane, rsum);
            fence_proxy_async();
            named_sync(1 + wg, 128);
            a = codes_u + (kt & 1) * CODE_TILE + wg * 64 * BK;
          }
          mbar_wait(full(stage), phase);
          const uint32_t b = ring + stage * STAGE_BYTES;
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < BK / 32; ++s) {
            if (k0 + s * 32 >= K) break;
            wgmma_s8(acc, sw128_desc(a + s * 32), sw128_desc(b + s * 32),
                     fresh ? 0 : 1);
            fresh = false;
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous slot's wgmmas are done
          if (prev >= 0 && leader) mbar_arrive(empty(prev));
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (leader) mbar_arrive(empty(prev));
        (void)rsum;  // read only by the wide schedule's row sums
        if constexpr (WIDE && ROWSUM) {
          // the rows' code sums: lanes l, l ^ 1, .. l ^ 7 hold one row's
          // eight chunks of every k-tile
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            int v = rsum[i];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            v += __shfl_xor_sync(0xffffffffu, v, 4);
            if ((lane & 7) == 0)
              row_r[64 * wg + 16 * warp + (lane >> 3) + 4 * i] =
                  static_cast<float>(v);
          }
        }

        // ---- epilogue: values from registers to the output. A quad's four
        // lanes hold columns 2*t4, 2*t4 + 1 of each 8-column block; an
        // exchange in the quad (`quad_transpose`) gives lane t4 all eight
        // columns of block nt0 + t4, stored as one contiguous run (16 bytes
        // of bf16, 32 of f32) instead of four 2-column pieces
        named_sync(1 + wg, 128);  // cols (and WIDE's row sums) are written
        if constexpr (WIDE) read_rows();
#pragma unroll
        for (int nt0 = 0; nt0 < BN / 8; nt0 += 4) {
          Pair<Out> p[2][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            // registers 4nt .. 4nt+3: columns c, c+1 of rows lr and lr + 8
            const int nt = nt0 + j;
            const int c = acc_col(t4, 4 * nt);
            const Col c0 = cols[c];
            const Col c1 = cols[c + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * nt + 2 * h;
              const typename Epi::Row& rw = h ? row_hi : row_lo;
              float2 res = make_float2(0.0f, 0.0f);
              float2 gate = make_float2(1.0f, 1.0f);
              if constexpr (Epi::RES) {
                const int row = m0 + lr + 8 * h;
                if (row < M && n0 + c < N)
                  epi.rg.load2(row, n0 + c, N, res, gate);
              }
              p[h][j] = pack2(epi.value(acc[i], 0.0f, rw, c0, res.x, gate.x),
                              epi.value(acc[i + 1], 0.0f, rw, c1, res.y,
                                        gate.y));
            }
          }
          const int col = n0 + 8 * (nt0 + t4);  // N % 16 == 0: 8 in or out
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Pair<Out> q[4];
            quad_transpose(p[h], q, t4, lane);
            const int row = m0 + lr + 8 * h;
            if (row < M && col < N)
              store8(out + static_cast<size_t>(row) * N + col, q);
          }
        }
        named_sync(1 + wg, 128);  // ... and read, before the next tile's
      }
    }
  }
}

template <typename T, bool SYM, bool ROWSUM, bool CS, bool WIDE, typename Epi>
cudaError_t launch_wide(const T* x, const float* cs, const int8_t* wt,
                        const Epi& epi, int K, int ldx, int nsplit,
                        cudaStream_t st) {
  auto kernel = dynq_gemm_kernel<T, SYM, ROWSUM, CS, WIDE, Epi>;
  static cudaError_t prepared = cudaErrorNotReady;
  if (prepared == cudaErrorNotReady) {
    cudaFuncAttributes fa;
    prepared = cudaFuncGetAttributes(&fa, kernel);
    // setmaxnreg only moves registers within the block's launch
    // allocation, which must hold the consumers' and producer's shares
    if (prepared == cudaSuccess && fa.numRegs < vq::i8mma::LAUNCH_REGS)
      prepared = cudaErrorInvalidDeviceFunction;
    if (prepared == cudaSuccess)
      prepared = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem_bytes(MAX_KT));
  }
  if (prepared != cudaSuccess) return prepared;
  CUtensorMap map_w;
  const int tma_w = vq::i8mma::tma_ok(wt, wt, K) &&
                    vq::i8mma::encode_map(&map_w, wt, epi.N, K, BN);
  if (!tma_w) memset(&map_w, 0, sizeof(map_w));
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int units = (epi.M + BM - 1) / BM * nsplit;
  const int nkt = (K + BK - 1) / BK;
  kernel<<<units < sms ? units : sms, THREADS, smem_bytes(WIDE ? 2 : nkt),
           st>>>(x, cs, map_w, wt, epi, K, ldx, nsplit, tma_w);
  return cudaGetLastError();
}

// resident codes up to MAX_KT k-tiles, else the wide schedule
template <typename T, bool SYM, bool ROWSUM, bool CS, typename Epi>
cudaError_t launch_cs(const T* x, const float* cs, const int8_t* wt,
                      const Epi& epi, int K, int ldx, int nsplit,
                      cudaStream_t st) {
  if (K > MAX_KT * BK)
    return launch_wide<T, SYM, ROWSUM, CS, true>(x, cs, wt, epi, K, ldx,
                                                 nsplit, st);
  return launch_wide<T, SYM, ROWSUM, CS, false>(x, cs, wt, epi, K, ldx,
                                                nsplit, st);
}

// the instantiation with or without column scales (cs null: none); the
// residual epilogue takes none
template <typename T, bool SYM, bool ROWSUM, typename Epi>
cudaError_t launch(const T* x, const float* cs, const int8_t* wt,
                   const Epi& epi, int K, int ldx, int nsplit,
                   cudaStream_t st) {
  if constexpr (Epi::RES) {
    if (cs != nullptr) return cudaErrorInvalidValue;
    return launch_cs<T, SYM, ROWSUM, false>(x, cs, wt, epi, K, ldx, nsplit,
                                            st);
  } else {
    if (cs != nullptr)
      return launch_cs<T, SYM, ROWSUM, true>(x, cs, wt, epi, K, ldx, nsplit,
                                             st);
    return launch_cs<T, SYM, ROWSUM, false>(x, cs, wt, epi, K, ldx, nsplit,
                                            st);
  }
}

#ifndef VQ_K5_F32
// the residual epilogue's launches (bf16 x and out): mode as launch_mode's
cudaError_t launch_res(const __nv_bfloat16* x, const int8_t* wt,
                       const float* ws, const float* wzp, const float* wcs,
                       const float* b, void* out, int M, int N, int K,
                       int ldx, int mode, int nsplit,
                       const vq::i8mma::ResGate& rg, cudaStream_t st) {
  using vq::i8mma::int8_gemm_epilogue;
  using vq::i8mma::ZpEpilogue;
  using T = __nv_bfloat16;
  const float kf = static_cast<float>(K);
  if (mode == 0)
    return launch<T, true, false>(
        x, nullptr, wt,
        int8_gemm_epilogue<false, 0, true>{nullptr, 1, ws, b, out, M, N, rg},
        K, ldx, nsplit, st);
  if (mode == 1)
    return launch<T, true, true>(
        x, nullptr, wt,
        ZpEpilogue<false, false, true, true>{nullptr, nullptr, nullptr, ws,
                                             wzp, wcs, b, out, M, N, kf, rg},
        K, ldx, nsplit, st);
  return launch<T, false, true>(
      x, nullptr, wt,
      ZpEpilogue<false, false, false, true>{nullptr, nullptr, nullptr, ws, wzp,
                                            wcs, b, out, M, N, kf, rg},
      K, ldx, nsplit, st);
}

#endif  // VQ_K5_F32

// mode 0: sym acts x sym weights; 1: sym acts x asym weights; 2: asym acts
template <typename T>
cudaError_t launch_mode(const T* x, const float* cs, const int8_t* wt,
                        const float* ws, const float* wzp, const float* wcs,
                        const float* b,
                        void* out, int M, int N, int K, int ldx, int mode,
                        bool f32, int nsplit, cudaStream_t st) {
  using vq::i8mma::int8_gemm_epilogue;
  using vq::i8mma::ZpEpilogue;
  const float kf = static_cast<float>(K);
  if (mode == 0) {
    if (f32)
      return launch<T, true, false>(
          x, cs, wt,
          int8_gemm_epilogue<false, 1>{nullptr, 1, ws, b, out, M, N}, K,
          ldx, nsplit, st);
    return launch<T, true, false>(
        x, cs, wt,
        int8_gemm_epilogue<false, 0>{nullptr, 1, ws, b, out, M, N}, K,
        ldx, nsplit, st);
  }
  if (mode == 1) {
    if (f32)
      return launch<T, true, true>(x, cs, wt,
                             ZpEpilogue<true, false, true>{
                                 nullptr, nullptr, nullptr, ws, wzp, wcs, b,
                                 out, M, N, kf},
                             K, ldx, nsplit, st);
    return launch<T, true, true>(x, cs, wt,
                           ZpEpilogue<false, false, true>{
                               nullptr, nullptr, nullptr, ws, wzp, wcs, b,
                               out, M, N, kf},
                           K, ldx, nsplit, st);
  }
  if (f32)
    return launch<T, false, true>(x, cs, wt,
                            ZpEpilogue<true, false, false>{
                                nullptr, nullptr, nullptr, ws, wzp, wcs, b,
                                out, M, N, kf},
                            K, ldx, nsplit, st);
  return launch<T, false, true>(x, cs, wt,
                          ZpEpilogue<false, false, false>{
                              nullptr, nullptr, nullptr, ws, wzp, wcs, b, out,
                              M, N, kf},
                          K, ldx, nsplit, st);
}

}  // namespace

// launch_mode on f32 x: defined in parts/dynq_gemm_f32.cu
cudaError_t vq_k5_launch_f32(const float* x, const float* cs,
                             const int8_t* wt, const float* ws,
                             const float* wzp, const float* wcs,
                             const float* b, void* out, int M, int N, int K,
                             int ldx, int mode, bool f32, int nsplit,
                             cudaStream_t st)
#ifdef VQ_K5_F32
{
  return launch_mode(x, cs, wt, ws, wzp, wcs, b, out, M, N, K, ldx, mode,
                     f32, nsplit, st);
}
#else
    ;

// x [M, K] (bf16 when is_bf16, else f32), cs [K] f32 (the column scales x
// is multiplied by before the quantize) or null, Wt [N, K] int8 (the
// K-major weight), ws [N] f32, wzp [N] f32 or null (sym weights), wcs [N]
// f32 (asym acts) or null, bias [N] f32 or null; out [M, N] f32 when
// f32_out, else bf16. sym_x: sym act codes (else asym with zero points).
// nsplit: runs of N tiles an M tile's work is split into (>= 1). res [M, N]
// bf16 or null: the residual epilogue, with gate [G, N] bf16 or null and
// rows_per_gate = M / G (bf16 x and out, no cs). ldx: x's row stride in
// elements (>= K; the rows and cs 16-byte aligned, cs ldx long: the
// wrapper pads x's rows past K, and cs, with zeros). Takes any K > 0 (the
// codes resident up to 1152, the wide schedule above) and N % 16 == 0 (the
// wrapper pads N); any M.
VQ_EXPORT int vq_dynq_gemm(const void* x, const void* cs, const void* Wt,
                           const void* ws, const void* wzp, const void* wcs,
                           const void* bias, void* out, int M, int N, int K,
                           int ldx, int is_bf16, int sym_x, int f32_out,
                           int nsplit, const void* res, const void* gate,
                           int rows_per_gate, void* stream) {
  const size_t row_bytes = static_cast<size_t>(ldx) * (is_bf16 ? 2 : 4);
  vq::i8mma::ResGate rg;
  if (K <= 0 || ldx < K || N <= 0 || N % 16 != 0 || nsplit < 1 ||
      (!sym_x && wcs == nullptr) || row_bytes % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cs) % 16 != 0 ||
      !vq::i8mma::res_gate(res, gate, rows_per_gate, &rg) ||
      (res != nullptr && (!is_bf16 || f32_out || cs != nullptr)))
    return cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const int mode = !sym_x ? 2 : wzp != nullptr ? 1 : 0;
  const auto p = [](const void* v) { return static_cast<const float*>(v); };
  const int8_t* w = static_cast<const int8_t*>(Wt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (res != nullptr)
    return static_cast<int>(launch_res(
        static_cast<const __nv_bfloat16*>(x), w, p(ws), p(wzp), p(wcs),
        p(bias), out, M, N, K, ldx, mode, nsplit, rg, st));
  const cudaError_t e =
      is_bf16 ? launch_mode(static_cast<const __nv_bfloat16*>(x), p(cs), w,
                            p(ws), p(wzp), p(wcs), p(bias), out, M, N, K, ldx,
                            mode, f32_out != 0, nsplit, st)
              : vq_k5_launch_f32(static_cast<const float*>(x), p(cs), w,
                                 p(ws), p(wzp), p(wcs), p(bias), out, M, N,
                                 K, ldx, mode, f32_out != 0, nsplit, st);
  return static_cast<int>(e);
}
#endif  // VQ_K5_F32
