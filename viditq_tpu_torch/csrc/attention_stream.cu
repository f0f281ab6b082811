// K6: kv-streaming (online-softmax) attention over [B, N, H*D] for kv
// lengths above the one-shot range (PixArt-Σ 1024 self-attention: N = M =
// 4096, 16 heads of 72), full or kv-masked, with a bf16 PV or the int8 PV.
//
// Replaces the TPU kernel `_attn_stream_kernel` (viditq_tpu/kernels/
// attention.py:236-368, dispatched at :643-714). Per (b, h, q row), for
// each kv block of exactly `bkv` rows (the numerics rule `stream_kv_block`):
//   s      = bf16(q * scale*log2e) . bf16(k)  (+ -inf where masked; f32 sums)
//   m_new  = max(m_old, rowmax(s over the whole block))
//   m_safe = m_new, or 0 while the row is fully masked
//   e      = exp2(s - m_safe);  corr = exp2(m_old - m_safe)
//   r      = r * corr + sum(e)
//   bf16 PV: pv = sum(bf16(e) * v)                              (f32)
//   int8 PV: pv = float(sum(round(e*127) * vq)) * (vs * (1/127^2))
//   acc    = acc * corr + pv
// and at the end o = acc * (1 / max(r, 1e-30)), written in bf16. The int8
// codes and the bf16 rounding of e are taken against the RUNNING max (C3),
// which must be the whole block's, not a tile's: each block is walked
// twice, pass 1 over QK^T for the block's row max only, pass 2 for e, the
// row sum and PV (one exp2 per score). A one-pass form would round e
// against a per-tile max and move the result (ROADMAP C9). Emission is not
// done here: the wrapper quantizes the bf16 output with K4, as the JAX
// package does (attention.py:705-713).
//
// Bound on the card: tensor-core work (4*B*H*N*M*D flops; at Σ-1024 154.6
// GFLOP, about 0.16 ms at 989 TFLOP/s; with the second QK^T pass and D
// padded to 80 for the k16 steps, 0.26 ms) and the B*H*N*M exp2 on the
// MUFU pipe (about 0.15 ms); q/k/v/o are 75 MB (0.02 ms).
// Design: the shared core (attn_core.cuh): 128 q rows per block in two
// wgmma warpgroups, k/v tiles of 64 rows through a 3-slot cp.async ring,
// QK^T and PV on wgmma (bf16 PV with the probabilities as the register
// operand and v as the MN-major operand; int8 PV on s8 wgmma with exact
// int32 sums per block over v^T codes from the transposing v-quantize
// pass). The ring runs over the schedule block 0 pass 1 (k only), block 0
// pass 2 (k and v), block 1 pass 1, ..., so the copies of the next block's
// first tiles overlap the last tiles of this one. In bf16 PV the `corr`
// rescale is applied to the accumulator before the block's PV tiles are
// added to it (acc * corr + pv with pv summed into acc, one f32 register
// set fewer); the int8 PV keeps its block sum apart, exact, and adds
// float(sum) * vs/127^2 once per block. Heads wider than 128 split their
// output columns over two blocks (attn_core.cuh, `block_cols`): each walks
// the whole recurrence, the same max, corr and row sum, for its half.
//
// Build: parts/attention_stream_wide.cu includes this file with
// VQ_K6_PART set and instantiates the launchers of D = 192 and 256 alone,
// which the entry point here declares extern, so that the build compiles
// them in parallel with the others.
#include "attn_core.cuh"

namespace vq {
namespace k6 {

using namespace vq::attn;

template <int D, bool INT8>
__global__ void __launch_bounds__(THREADS, D > 72 ? 1 : 2)
    attn_stream_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const void* __restrict__ v,
                       const float* __restrict__ vscale,
                       const int* __restrict__ mask,
                       __nv_bfloat16* __restrict__ out, int N, int M, int H,
                       int bkv, float scale2) {
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

  const int nb = bkv / BKV;         // tiles per kv block
  const int steps = 2 * (M / BKV);  // every block walked twice
  auto slot_of = [&](int step) {
    return Slot<D, DV>(ring + (step % STAGES) * T::STAGE_BYTES);
  };
  auto kv_of = [&](int step) {
    return ((step / (2 * nb)) * nb + (step % (2 * nb)) % nb) * BKV;
  };
  auto prefetch = [&](int step) {
    if (step < steps)
      load_tile<D, DV, INT8>(slot_of(step), k, v, mask, b, h, c0,
                             kv_of(step), M, M, M, C, H,
                             step % (2 * nb) >= nb);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) prefetch(i);

  float m_run[2] = {-INFINITY, -INFINITY};
  float r_run[2] = {0.0f, 0.0f};
  float bm[2] = {-INFINITY, -INFINITY};
  float m_new[2], m_safe[2], corr[2], rs[2];
  float acc[T::NO];
#pragma unroll
  for (int i = 0; i < T::NO; ++i) acc[i] = 0.0f;
  int pvi[INT8 ? T::NO8 : 1];

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    prefetch(step + STAGES - 1);
    const Slot<D, DV> slot = slot_of(step);
    const int w = step % (2 * nb);
    float s[32];
    scores<D, DV>(s, qs, slot, ln, kv_of(step), M, masked);
    if (w < nb) {
      // pass 1: the row max over the whole kv block
      if (w == 0) bm[0] = bm[1] = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        bm[(i >> 1) & 1] = fmaxf(bm[(i >> 1) & 1], s[i]);
      if (w == nb - 1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m_new[hh] = fmaxf(m_run[hh], quad_max(bm[hh]));
          m_safe[hh] = m_new[hh] == -INFINITY ? 0.0f : m_new[hh];
          corr[hh] = exp2f(m_run[hh] - m_safe[hh]);
          rs[hh] = 0.0f;
        }
        if constexpr (!INT8) {
#pragma unroll
          for (int i = 0; i < T::NO; ++i) acc[i] *= corr[(i >> 1) & 1];
        }
      }
      continue;
    }
    // pass 2: e, its row sum and the block's PV
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] - m_safe[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += s[i];
    }
    if constexpr (INT8) {
      uint32_t a[BKV / 32][4];
      pack_codes(a, s);
      pv_s8<D, DV>(pvi, a, slot, w > nb ? 1 : 0);
    } else {
      uint32_t p[BKV / 16][4];
      pack_p(p, s, [](float x, int) { return x; });
      pv_bf16<D, DV>(acc, p, slot, 1);
    }
    if (w == 2 * nb - 1) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        r_run[hh] = r_run[hh] * corr[hh] + quad_sum(rs[hh]);
        m_run[hh] = m_new[hh];
      }
      if constexpr (INT8) {
        const float* vsr = vscale + static_cast<size_t>(b) * C + h * D + c0;
#pragma unroll
        for (int i = 0; i < T::NO; ++i) {
          const int d = 8 * (i >> 2) + 2 * ln.t4 + (i & 1);
          const float vsd =
              vsr[d] * static_cast<float>(1.0 / (127.0 * 127.0));
          acc[i] = acc[i] * corr[(i >> 1) & 1] +
                   static_cast<float>(pvi[i]) * vsd;
        }
      }
    }
  }
  cp_async_wait<0>();
  const float inv[2] = {1.0f / fmaxf(r_run[0], 1e-30f),
                        1.0f / fmaxf(r_run[1], 1e-30f)};
  store_out<DV>(ring, out, ln, b, h * D + c0, q0, N, C,
                [&](int i) { return acc[i] * inv[(i >> 1) & 1]; });
}

template <int D, bool INT8>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* vs, const int* mask, void* out, int B, int N,
                   int M, int H, int bkv, float scale2, cudaStream_t st) {
  auto kernel = attn_stream_kernel<D, INT8>;
  const int smem = Tile<D, block_cols(D)>::SMEM_BYTES;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, H * (D / block_cols(D)), B);
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), v, vs, mask,
      static_cast<__nv_bfloat16*>(out), N, M, H, bkv, scale2);
  return cudaGetLastError();
}

}  // namespace k6
}  // namespace vq

#define VQ_K6_LAUNCH(PRE, DD, I8)                                       \
  PRE template cudaError_t vq::k6::launch<DD, I8>(                      \
      const void*, const void*, const void*, const float*, const int*,  \
      void*, int, int, int, int, int, float, cudaStream_t);
#define VQ_K6_WIDE(PRE)                                                 \
  VQ_K6_LAUNCH(PRE, 192, false) VQ_K6_LAUNCH(PRE, 192, true)           \
  VQ_K6_LAUNCH(PRE, 256, false) VQ_K6_LAUNCH(PRE, 256, true)

#ifdef VQ_K6_PART
VQ_K6_WIDE()
#else  // the entry point
VQ_K6_WIDE(extern)

// q [B, N, H*D], k [B, M, H*D] bf16; v bf16 [B, M, H*D], or (int8_pv) the
// codes from vq_attn_vquant_t at Mp = M ([B, H, D, M] int8, kv_perm order)
// with scales vs [B, 1, H*D]; mask [B, M] int32 or null; out [B, N, H*D]
// bf16. D in {16, 32, 64, 72, 128, 192, 256}; bkv a multiple of 64
// dividing M; every pointer 16-byte aligned.
VQ_EXPORT int vq_attention_stream(const void* q, const void* k, const void* v,
                                  const void* vs, const void* mask, void* out,
                                  int B, int N, int M, int H, int D, int bkv,
                                  float scale2, int int8_pv, void* stream) {
  if (bkv <= 0 || bkv % vq::attn::BKV != 0 || M % bkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* vsp = static_cast<const float*>(vs);
  const int* mp = static_cast<const int*>(mask);
  cudaError_t err;
  switch (D * 2 + (int8_pv ? 1 : 0)) {
#define VQ_STREAM_CASE(DD, I8)                                              \
  case DD * 2 + I8:                                                         \
    err = vq::k6::launch<DD, I8 != 0>(q, k, v, vsp, mp, out, B, N, M, H,    \
                                      bkv, scale2, st);                     \
    break;
    VQ_STREAM_CASE(16, 0)
    VQ_STREAM_CASE(16, 1)
    VQ_STREAM_CASE(32, 0)
    VQ_STREAM_CASE(32, 1)
    VQ_STREAM_CASE(64, 0)
    VQ_STREAM_CASE(64, 1)
    VQ_STREAM_CASE(72, 0)
    VQ_STREAM_CASE(72, 1)
    VQ_STREAM_CASE(128, 0)
    VQ_STREAM_CASE(128, 1)
    VQ_STREAM_CASE(192, 0)
    VQ_STREAM_CASE(192, 1)
    VQ_STREAM_CASE(256, 0)
    VQ_STREAM_CASE(256, 1)
#undef VQ_STREAM_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#endif  // VQ_K6_PART
