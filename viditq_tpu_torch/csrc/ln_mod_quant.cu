// K1: fused non-affine LayerNorm + t2i modulate + per-row int8 quantize,
// symmetric or asymmetric.
//
// Replaces the TPU kernel `ln_modulate_quantize` / `_ln_mod_quant_kernel`
// (viditq_tpu/kernels/fused_matmul.py:656-719). Per row of x [B*N, C]:
//   mean = sum(x)/C; var = sum((x-mean)^2)/C; y = (x-mean) * 1/sqrt(var+eps)
//   y = y * (1 + scale[b]) + shift[b]
//   sym : s = max(absmax(y)/127, 1e-6); codes = clip(round(y * (1/s)))
//   asym: lo = min(y, 0), hi = max(y, 0); s = max((hi - lo)/255, 1e-6);
//         inv = 1/s; zp = round(-lo * inv) - 128;
//         codes = clip(round(y * inv) + zp, -128, 127)
//   rowsum = sum of the codes (asym, or when asked for: asym consumer
//   weights), an exact integer sum stored as f32
// (`_quantize_rows_f32`, fused_matmul.py:118-137; every division a true
// IEEE division). The LN keeps the two-pass form (the mean, then the sum
// of squared deviations from it). The row's min, max and code sum are
// exact in any order; only the LN mean and variance sum in another order
// than the plain version.
//
// Bound on the card: memory. It reads C bf16 values and writes C int8 codes
// plus up to three floats per row (3 bytes/element); the arithmetic is
// some 20 instructions an element. Design: one warp per row, eight rows a
// block; a lane owns quads of 4 consecutive channels (quad lane + 32*i). At
// the models' width, C = 1152, a quad is one 8-byte vector (bf16; 16 bytes
// for f32), every lane holds 9 whole quads and checks none against the
// row's end. The row is read once: the mean (four partial sums a lane), the
// squared deviations, y, its range and the codes all come from the same 36
// f32 registers, y computed once. shift and scale are read per row as the
// same vectors (L1 hits: a batch's two rows of C serve every row of the
// batch), so a block may span a batch boundary. Codes leave as 4-byte
// stores, packed by cvt.pack.sat and summed by dp4a. Every other width
// takes the general form: element loads and byte stores, and a row wider
// than 32 * 9 quads (C > 1152) read in passes, once for each of mean,
// variance, range and codes.
#include "common.cuh"

namespace {

constexpr int QPL = 9;    // quads a lane holds (C <= 1152 in one read)
constexpr int WARPS = 8;  // rows a block

// 4 consecutive elements of T from p (aligned to 4 * sizeof(T)) as float
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  f[0] = vq::bf16_half(r.x, 0);
  f[1] = vq::bf16_half(r.x, 1);
  f[2] = vq::bf16_half(r.y, 0);
  f[3] = vq::bf16_half(r.y, 1);
}
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  f[0] = r.x;
  f[1] = r.y;
  f[2] = r.z;
  f[3] = r.w;
}

// EXACT: C == 32 * QPL * 4 and x, shift and scale aligned to 4 * sizeof(T):
// every quad lies whole in the row (one vector load, one 4-byte code store,
// no check); else any C, element loads and byte stores, and RESIDENT: C <=
// 32 * QPL * 4 (one read). The bound of one block an SM leaves ptxas free to
// take the registers it needs: without it, ptxas held some instantiations
// to 80 registers and spilled.
template <typename T, bool SYM, bool EXACT, bool RESIDENT>
__global__ void __launch_bounds__(WARPS * 32, 1)
    ln_mod_quant_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                        const T* __restrict__ scale, int8_t* __restrict__ q,
                        float* __restrict__ qs, float* __restrict__ zp,
                        float* __restrict__ rowsum, int rows,
                        int rows_per_batch, int C, float eps) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / rows_per_batch;
  const T* xr = x + static_cast<size_t>(row) * C;
  const T* sh = shift + static_cast<size_t>(b) * C;
  const T* sc = scale + static_cast<size_t>(b) * C;
  int8_t* qr = q + static_cast<size_t>(row) * C;
  const int nquad = (C + 3) / 4;
  const int step = 32 * QPL;  // quads a pass
  float v[QPL][4];            // x, then x - mean, then y; 0 past C

  // element e of quad qd lies in the row
  auto valid = [&](int qd, int e) { return EXACT || 4 * qd + e < C; };
  // quad qd of a row of C values (zeros past C)
  auto load_quad = [&](const T* p, int qd, float (&f)[4]) {
    if constexpr (EXACT) {
      load4(p + 4 * qd, f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = valid(qd, e) ? vq::to_f32(p[4 * qd + e]) : 0.0f;
    }
  };
  auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < QPL; ++i) load_quad(xr, base + lane + 32 * i, v[i]);
  };
  float acc[4];  // four partial sums a lane (a sum per position in a quad)
  auto total = [&]() {
    const float s = vq::warp_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = 0.0f;
    return s;
  };
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = 0.0f;

  // the mean (zeros past C add nothing)
  auto add = [&]() {
#pragma unroll
    for (int i = 0; i < QPL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += v[i][e];
  };
  if constexpr (RESIDENT) {
    load(0);
    add();
  } else {
    for (int base = 0; base < nquad; base += step) {
      load(base);
      add();
    }
  }
  const float mean = total() / static_cast<float>(C);

  // v = x - mean (0 past C), and the sum of its squares
  auto center = [&](int base, bool square) {
#pragma unroll
    for (int i = 0; i < QPL; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = valid(base + lane + 32 * i, e) ? v[i][e] - mean : 0.0f;
        v[i][e] = d;
        if (square) acc[e] += d * d;
      }
  };
  if constexpr (RESIDENT) {
    center(0, true);
  } else {
    for (int base = 0; base < nquad; base += step) {
      load(base);
      center(base, true);
    }
  }
  const float var = total() / static_cast<float>(C);
  const float inv_std = 1.0f / sqrtf(var + eps);

  // v = y = (x - mean) * inv_std * (1 + scale) + shift, and its range (past
  // C, v, scale and shift are 0: so is y)
  float lo = 0.0f;  // asym: min(y, 0)
  float hi = 0.0f;  // asym: max(y, 0); sym: absmax
  auto modulate = [&](int base) {
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      const int qd = base + lane + 32 * i;
      float a[4], c[4];
      load_quad(sc, qd, a);
      load_quad(sh, qd, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = v[i][e] * inv_std;
        v[i][e] = y * (1.0f + a[e]) + c[e];
        if constexpr (SYM) {
          hi = fmaxf(hi, fabsf(v[i][e]));
        } else {
          lo = fminf(lo, v[i][e]);
          hi = fmaxf(hi, v[i][e]);
        }
      }
    }
  };
  if constexpr (RESIDENT) {
    modulate(0);
  } else {
    for (int base = 0; base < nquad; base += step) {
      load(base);
      center(base, false);
      modulate(base);
    }
  }
  const vq::RowQuant rq = SYM ? vq::RowQuant::sym(vq::warp_max(hi))
                              : vq::RowQuant::asym(vq::warp_min(lo),
                                                   vq::warp_max(hi));

  int sum = 0;
  auto emit = [&](int base) {
#pragma unroll
    for (int i = 0; i < QPL; ++i) {
      const int qd = base + lane + 32 * i;
      if (!EXACT && qd >= nquad) continue;
      uint32_t w = rq.pack4<SYM>(v[i]);
      if constexpr (EXACT) {
        sum = vq::sum_s8x4(w, sum);
        *reinterpret_cast<uint32_t*>(qr + 4 * qd) = w;
      } else {
        const int n = min(4, C - 4 * qd);
        if (n < 4) w &= (1u << (8 * n)) - 1u;  // no code past C summed
        sum = vq::sum_s8x4(w, sum);
        for (int e = 0; e < n; ++e)
          qr[4 * qd + e] = static_cast<int8_t>((w >> (8 * e)) & 0xffu);
      }
    }
  };
  if constexpr (RESIDENT) {
    emit(0);
  } else {
    for (int base = 0; base < nquad; base += step) {
      load(base);
      center(base, false);
      modulate(base);
      emit(base);
    }
  }
  rq.store<SYM>(row, lane, sum, qs, zp, rowsum);
}

template <typename T, bool SYM>
void launch_mode(const T* x, const T* sh, const T* sc, int8_t* q, float* qs,
                 float* zp, float* rowsum, int rows, int N, int C, bool exact,
                 float eps, cudaStream_t st) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  if (exact)
    ln_mod_quant_kernel<T, SYM, true, true><<<blocks, WARPS * 32, 0, st>>>(
        x, sh, sc, q, qs, zp, rowsum, rows, N, C, eps);
  else if (C <= 32 * QPL * 4)
    ln_mod_quant_kernel<T, SYM, false, true><<<blocks, WARPS * 32, 0, st>>>(
        x, sh, sc, q, qs, zp, rowsum, rows, N, C, eps);
  else
    ln_mod_quant_kernel<T, SYM, false, false><<<blocks, WARPS * 32, 0, st>>>(
        x, sh, sc, q, qs, zp, rowsum, rows, N, C, eps);
}

template <typename T>
void launch(const void* x, const void* shift, const void* scale, void* q,
            void* qs, void* zp, void* rowsum, int B, int N, int C, float eps,
            cudaStream_t st) {
  const int rows = B * N;
  const T* xt = static_cast<const T*>(x);
  const T* sh = static_cast<const T*>(shift);
  const T* sc = static_cast<const T*>(scale);
  int8_t* qt = static_cast<int8_t*>(q);
  float* s = static_cast<float*>(qs);
  float* z = static_cast<float*>(zp);
  float* r = static_cast<float*>(rowsum);
  const uintptr_t align = 4 * sizeof(T);
  const bool exact = C == 32 * QPL * 4 &&
                     reinterpret_cast<uintptr_t>(x) % align == 0 &&
                     reinterpret_cast<uintptr_t>(shift) % align == 0 &&
                     reinterpret_cast<uintptr_t>(scale) % align == 0;
  if (z == nullptr)
    launch_mode<T, true>(xt, sh, sc, qt, s, z, r, rows, N, C, exact, eps, st);
  else
    launch_mode<T, false>(xt, sh, sc, qt, s, z, r, rows, N, C, exact, eps,
                          st);
}

}  // namespace

// x [B, N, C], shift/scale [B, 1, C] (bf16 when is_bf16, else float32);
// q [B*N, C] int8, qs [B*N] float32. zp [B*N] f32 selects the asymmetric
// quantizer (null: symmetric); rowsum [B*N] f32 or null (not written).
VQ_EXPORT int vq_ln_mod_quant(const void* x, const void* shift,
                              const void* scale, void* q, void* qs, void* zp,
                              void* rowsum, int B, int N, int C, float eps,
                              int is_bf16, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, shift, scale, q, qs, zp, rowsum, B, N, C, eps,
                          st);
  else
    launch<float>(x, shift, scale, q, qs, zp, rowsum, B, N, C, eps, st);
  return static_cast<int>(cudaGetLastError());
}
