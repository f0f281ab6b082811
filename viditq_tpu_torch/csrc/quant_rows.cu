// K4: per-row dynamic int8 quantize, symmetric or asymmetric, optionally
// after a tanh-GELU and a column scale.
//
// Replaces the TPU kernel `quantize_rows_fused` / `_quant_rows_kernel`
// (viditq_tpu/kernels/fused_matmul.py:581-653). Per row of x [M, K]:
//   y = gelu ? 0.5*x*(1 + tanh(sqrt(2/pi)*(x + 0.044715*((x*x)*x)))) : x
//   y = y * cs[k] where a column scale is given (the consuming layer's
//       channel-balancing 1/cs, after the GELU: RowQuant::balance)
//   then the row quantizer of `_quantize_rows_f32` (common.cuh RowQuant:
//   sym, or asym with its zero point), and the code row sum where asked
//   for (asym codes, or sym codes feeding asym weights).
// The GELU is computed in f32 from the input's value, in the plain
// version's operation order (-fmad=false keeps each product rounded;
// tanhf is the IEEE-accurate library function).
//
// Bound on the card: memory (read 2 bytes, write 1 byte per element, a few
// floats per row); the GELU mode also spends some 40 f32 instructions an
// element (tanhf, which most warps take down both of its branches, the
// GELU's own products, the quantize). Design: a row belongs to W warps
// (W = 1 at K = 1152, 3 at the fc1 -> fc2 handoff's K = 4608), and a thread
// owns CPT chunks of 16 consecutive elements (chunk t + 32*W*i), read as
// 16-byte vectors, so its 16 codes leave in one 16-byte store. The row is
// read once and held in registers as f32 (the GELU's output, taken once per
// element) from the range pass to the code pass; min/max and the code sum
// reduce by shuffles and, across a row's warps, through a few words of
// shared memory. Codes are packed four to a word by cvt.pack.sat and summed
// by dp4a. A row longer than 8 warps hold (K > 12288) is read in passes,
// twice (the GELU then computed twice); rows that are not 16-byte aligned
// are read element by element. Measured on the card and not kept, each no
// faster at the GELU shape (PERF.md): the GELU from a shared-memory table
// of the bf16 values, persistent blocks, a prefetch of each warp's next
// row, rounding the codes on the f32 pipe instead of by cvt.
#include "common.cuh"

namespace {

constexpr int CH = 16;        // elements a chunk: one 16-byte code store
constexpr int CPT = 3;        // chunks a thread holds
constexpr int MAX_WARPS = 8;  // a block's warps (and a row's at most)

__device__ __forceinline__ float gelu_tanh(float o) {
  const float o3 = o * o * o;
  return 0.5f * o * (1.0f + tanhf(0.7978845608028654f * (o + 0.044715f * o3)));
}

// W warps a row (blockDim.x = 32 * W * rows a block); vec: rows and x
// 16-byte aligned (K * sizeof(T) % 16 == 0), else element loads and byte
// stores; RESIDENT: the row fits the block's registers (one read); CS:
// cs holds column scales, read (from L1 after the first row) and applied
// after the GELU. Measured on the card and not kept: their loads issued
// beside the row's (the registers they hold cost more than their latency).
template <typename T, bool SYM, bool GELU, bool RESIDENT, bool CS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ cs,
                      int8_t* __restrict__ q, float* __restrict__ qs,
                      float* __restrict__ zp, float* __restrict__ rowsum,
                      int M, int K, int W, bool vec) {
  constexpr int VEC = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int VPC = CH / VEC;        // vectors of a chunk
  __shared__ float red_lo[MAX_WARPS], red_hi[MAX_WARPS];
  __shared__ int red_sum[MAX_WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = warp - warp % W;  // the row's first warp in the block
  const int row = blockIdx.x * (blockDim.x / (32 * W)) + warp / W;
  const int t = (warp - first) * 32 + lane;  // thread in the row
  const int nt = 32 * W;                      // threads a row
  const bool live = row < M;  // no early return: the block synchronizes
  const int nchunk = (K + CH - 1) / CH;
  const T* xr = x + static_cast<size_t>(row) * K;
  int8_t* qr = q + static_cast<size_t>(row) * K;
  float v[CPT][CH];  // the row's values (after the GELU), 0 past K

  auto load = [&](int base) {
    if (vec) {
      uint4 raw[CPT][VPC];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = base + t + nt * i;
#pragma unroll
        for (int u = 0; u < VPC; ++u) {
          raw[i][u] = make_uint4(0u, 0u, 0u, 0u);
          if (live && c < nchunk && (c * VPC + u) * VEC < K)
            raw[i][u] = reinterpret_cast<const uint4*>(xr)[c * VPC + u];
        }
      }
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int u = 0; u < VPC; ++u)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            v[i][u * VEC + e] = vq::elem<T>(raw[i][u], e);
    } else {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = base + t + nt * i;
#pragma unroll
        for (int e = 0; e < CH; ++e)
          v[i][e] = live && c < nchunk && c * CH + e < K
                        ? vq::to_f32(xr[c * CH + e])
                        : 0.0f;
      }
    }
    if constexpr (GELU) {  // gelu(0) = 0: the padding stays 0
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int e = 0; e < CH; ++e) v[i][e] = gelu_tanh(v[i][e]);
    }
    if constexpr (CS) {  // the consumer's 1/cs, after the GELU (0 past K)
#pragma unroll
      for (int i = 0; i < CPT; ++i)
#pragma unroll
        for (int e = 0; e < CH; e += 4) {
          const float4 s = vq::RowQuant::col_scales4(
              cs, (base + t + nt * i) * CH + e, K, vec);
          v[i][e] = vq::RowQuant::balance(v[i][e], s.x);
          v[i][e + 1] = vq::RowQuant::balance(v[i][e + 1], s.y);
          v[i][e + 2] = vq::RowQuant::balance(v[i][e + 2], s.z);
          v[i][e + 3] = vq::RowQuant::balance(v[i][e + 3], s.w);
        }
    }
  };
  float lo = 0.0f;  // asym: min(y, 0)
  float hi = 0.0f;  // asym: max(y, 0); sym: absmax (0 padding moves neither)
  auto scan = [&]() {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int e = 0; e < CH; ++e) {
        if constexpr (SYM) {
          hi = fmaxf(hi, fabsf(v[i][e]));
        } else {
          lo = fminf(lo, v[i][e]);
          hi = fmaxf(hi, v[i][e]);
        }
      }
  };
  const int step = nt * CPT;  // chunks a pass
  if constexpr (RESIDENT) {
    load(0);
    scan();
  } else {
    for (int base = 0; base < nchunk; base += step) {
      load(base);
      scan();
    }
  }
  hi = vq::warp_max(hi);
  if constexpr (!SYM) lo = vq::warp_min(lo);
  if (W > 1) {  // across the row's warps (W is uniform: so is the barrier)
    if (lane == 0) {
      red_lo[warp] = lo;
      red_hi[warp] = hi;
    }
    __syncthreads();
    for (int j = 0; j < W; ++j) {
      lo = fminf(lo, red_lo[first + j]);
      hi = fmaxf(hi, red_hi[first + j]);
    }
  }
  const vq::RowQuant rq =
      SYM ? vq::RowQuant::sym(hi) : vq::RowQuant::asym(lo, hi);

  int sum = 0;
  auto emit = [&](int base) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = base + t + nt * i;
      if (!live || c >= nchunk) continue;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = rq.pack4<SYM>(&v[i][4 * j]);
      const int nv = min(CH, K - c * CH);  // codes of this chunk in the row
      if (nv < CH) {  // the row's ragged end: no code past K, none summed
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int b = nv - 4 * j;
          w[j] &= b >= 4 ? 0xffffffffu : b <= 0 ? 0u : (1u << (8 * b)) - 1u;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sum = vq::sum_s8x4(w[j], sum);
      int8_t* dst = qr + c * CH;
      if (vec && nv == CH && K % CH == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      } else if (vec) {  // K % 16 != 0: a store per 16-byte vector of x
#pragma unroll
        for (int u = 0; u < VPC; ++u) {
          if (u * VEC >= nv) continue;
          if constexpr (VEC == 8)
            *reinterpret_cast<uint2*>(dst + u * 8) =
                make_uint2(w[2 * u], w[2 * u + 1]);
          else
            *reinterpret_cast<uint32_t*>(dst + u * 4) = w[u];
        }
      } else {
        for (int e = 0; e < nv; ++e)
          dst[e] = static_cast<int8_t>((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
      }
    }
  };
  if constexpr (RESIDENT) {
    emit(0);
  } else {
    for (int base = 0; base < nchunk; base += step) {
      load(base);
      emit(base);
    }
  }
  if (rowsum != nullptr) {
    sum = vq::warp_sum_int(sum);
    if (W > 1) {
      if (lane == 0) red_sum[warp] = sum;
      __syncthreads();
      sum = 0;
      for (int j = 0; j < W; ++j) sum += red_sum[first + j];
    }
  }
  if (t != 0 || !live) return;
  qs[row] = rq.s;
  if (!SYM) zp[row] = rq.zp;
  if (rowsum != nullptr) rowsum[row] = static_cast<float>(sum);
}

template <typename T, bool SYM, bool GELU, bool CS>
void launch_cs(const T* x, const float* cs, int8_t* q, float* qs, float* zp,
               float* rowsum, int M, int K, cudaStream_t st) {
  const int nchunk = (K + CH - 1) / CH;
  const int W = min(MAX_WARPS, (nchunk + 32 * CPT - 1) / (32 * CPT));
  const int rows = MAX_WARPS / W;  // rows a block
  const int blocks = (M + rows - 1) / rows;
  // vec: 16-byte loads of x (and of cs, whose base is 16-byte aligned:
  // K % 4 == 0 follows)
  const bool vec = (K * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (nchunk <= 32 * W * CPT)
    quant_rows_kernel<T, SYM, GELU, true, CS>
        <<<blocks, 32 * W * rows, 0, st>>>(x, cs, q, qs, zp, rowsum, M, K, W,
                                           vec);
  else
    quant_rows_kernel<T, SYM, GELU, false, CS>
        <<<blocks, 32 * W * rows, 0, st>>>(x, cs, q, qs, zp, rowsum, M, K, W,
                                           vec);
}

template <typename T, bool SYM, bool GELU>
void launch_mode(const T* x, const float* cs, int8_t* q, float* qs, float* zp,
                 float* rowsum, int M, int K, cudaStream_t st) {
  if (cs != nullptr)
    launch_cs<T, SYM, GELU, true>(x, cs, q, qs, zp, rowsum, M, K, st);
  else
    launch_cs<T, SYM, GELU, false>(x, cs, q, qs, zp, rowsum, M, K, st);
}

template <typename T>
void launch(const void* x, const float* cs, void* q, void* qs, void* zp,
            void* rowsum, int M, int K, int gelu, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(qs);
  float* z = static_cast<float*>(zp);
  float* r = static_cast<float*>(rowsum);
  if (z == nullptr && gelu)
    launch_mode<T, true, true>(xt, cs, qt, s, z, r, M, K, st);
  else if (z == nullptr)
    launch_mode<T, true, false>(xt, cs, qt, s, z, r, M, K, st);
  else if (gelu)
    launch_mode<T, false, true>(xt, cs, qt, s, z, r, M, K, st);
  else
    launch_mode<T, false, false>(xt, cs, qt, s, z, r, M, K, st);
}

}  // namespace

// x [M, K] (bf16 when is_bf16, else float32); cs [K] f32 (16-byte aligned)
// or null: the column scale applied after the GELU; q [M, K] int8; qs [M]
// float32. zp [M] f32 selects the asymmetric quantizer (null: symmetric);
// rowsum [M] f32 or null (not written); gelu: tanh-GELU before the
// quantize.
VQ_EXPORT int vq_quant_rows(const void* x, const void* cs, void* q, void* qs,
                            void* zp, void* rowsum, int M, int K, int gelu,
                            int is_bf16, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(cs) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cs);
  if (is_bf16)
    launch<__nv_bfloat16>(x, c, q, qs, zp, rowsum, M, K, gelu, st);
  else
    launch<float>(x, c, q, qs, zp, rowsum, M, K, gelu, st);
  return static_cast<int>(cudaGetLastError());
}
