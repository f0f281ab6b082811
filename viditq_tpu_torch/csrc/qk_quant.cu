// K8: the per-(token, head) symmetric int8 quantize-dequantize of q and k
// (the attention's act_quantizer_{q,k}, the attn8 plan's `attn_act`), one
// launch for both tensors.
//
// Replaces `_fake_quant_tokens_headwise` (viditq_tpu/kernels/attention.py:
// 481-490), the pass the JAX package runs on q and k before every attention
// mode when int8_qk (:625-627). Per row of D values (one token's one head,
// contiguous in the [B, N, H, D] layout):
//   sc = max(max_d |t|, 1e-6);  dq = round(t * (127 / sc)) * (sc / 127)
// in f32, both divisions true IEEE divisions (computed once a row), the
// round half to even, dq cast back to bf16.
//
// Bound on the card: bytes (each element read and written once, 4 bytes an
// element in bf16: q and k at the spatial site, 2 x [32, 1024, 16, 72],
// 302 MB, 0.090 ms at 3.35 TB/s). What the design does: a block of ROWS
// threads takes ROWS rows of one tensor (q's blocks first, then k's); the
// rows' bytes are contiguous, so they are staged through shared memory by
// 16-byte loads of neighbouring threads on neighbouring addresses, each
// thread then quantizes its own row in place (the absmax over bf16 pairs,
// exact) and the block stores the rows back the same way. The staging,
// 18 KB a block at D = 72, leaves room for 12 blocks an SM; heads above
// 192 take blocks of 32 rows.
#include "common.cuh"

namespace {

constexpr int ROWS = 128;   // rows (threads) a block up to NARROW_D
constexpr int NARROW_D = 192;  // ROWS * D * 2 bytes of staging: <= 48 KB
constexpr int WIDE_ROWS = 32;  // rows a block above it (128 KB at D = 2048)
constexpr int MAX_D = 2048;    // H * D <= 2048, the attention's own gate

__device__ __forceinline__ uint32_t pair_word(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(ROWS)
    qk_quant_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    __nv_bfloat16* __restrict__ qo,
                    __nv_bfloat16* __restrict__ ko, int rows_q, int rows_k,
                    int D, int blocks_q) {
  extern __shared__ uint4 stage[];  // R rows of D / 8 chunks
  const int R = blockDim.x;         // rows a block, one a thread
  const bool is_q = static_cast<int>(blockIdx.x) < blocks_q;
  const int blk = is_q ? blockIdx.x : blockIdx.x - blocks_q;
  const int rows = is_q ? rows_q : rows_k;
  const uint4* src = reinterpret_cast<const uint4*>(is_q ? q : k);
  uint4* dst = reinterpret_cast<uint4*>(is_q ? qo : ko);
  const int cpr = D / 8;  // 16-byte chunks a row
  const int row0 = blk * R;
  const int n = min(R, rows - row0);
  const size_t base = static_cast<size_t>(row0) * cpr;
  for (int j = threadIdx.x; j < n * cpr; j += R) stage[j] = src[base + j];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < n) {
    uint4* row = stage + threadIdx.x * cpr;
    __nv_bfloat162 m2 = __float2bfloat162_rn(0.0f);
    for (int c = 0; c < cpr; ++c) {
      const uint4 v = row[c];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t wv = vq::word(v, w);
        const __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&wv);
        m2 = __hmax2(m2, __habs2(t));
      }
    }
    const float sc = fmaxf(fmaxf(__low2float(m2), __high2float(m2)), 1e-6f);
    const float mul = 127.0f / sc;
    const float dqs = sc / 127.0f;
    for (int c = 0; c < cpr; ++c) {
      const uint4 v = row[c];
      uint32_t o[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint32_t wv = vq::word(v, w);
        o[w] = pair_word(rintf(vq::bf16_half(wv, 0) * mul) * dqs,
                         rintf(vq::bf16_half(wv, 1) * mul) * dqs);
      }
      row[c] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n * cpr; j += R) dst[base + j] = stage[j];
}

}  // namespace

// q [rows_q, D], k [rows_k, D] bf16 -> qo, ko (same shapes) bf16: the
// headwise quantize-dequantize of every row. D % 8 == 0 (the wrapper pads
// other D with zeros, which move no row's absmax), D <= 2048; every
// pointer 16-byte aligned. Blocks of 128 rows up to D = 192, of 32 above.
VQ_EXPORT int vq_qk_headwise_quant(const void* q, const void* k, void* qo,
                                   void* ko, int rows_q, int rows_k, int D,
                                   void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (D <= 0 || D % 8 != 0 || D > MAX_D || rows_q < 0 || rows_k < 0 ||
      !aligned(q) || !aligned(k) || !aligned(qo) || !aligned(ko))
    return cudaErrorInvalidValue;
  const int R = D <= NARROW_D ? ROWS : WIDE_ROWS;
  const int smem = R * D * 2;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qk_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks_q = (rows_q + R - 1) / R;
  const int blocks = blocks_q + (rows_k + R - 1) / R;
  if (blocks == 0) return 0;
  qk_quant_kernel<<<blocks, R, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<__nv_bfloat16*>(qo), static_cast<__nv_bfloat16*>(ko), rows_q,
      rows_k, D, blocks_q);
  return static_cast<int>(cudaGetLastError());
}
