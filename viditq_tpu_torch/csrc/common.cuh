// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel file exposes plain C entry points (extern "C") that launch
// on the stream they are given and return cudaGetLastError() as an int;
// the Python wrappers load the library with ctypes and raise on non-zero.
//
// Numerics: the library is compiled with -fmad=false so that a*b+c stays a
// rounded multiply then a rounded add, as in the JAX reference and the
// plain PyTorch versions; division and sqrt are IEEE (no fast-math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define VQ_EXPORT extern "C" __attribute__((visibility("default")))

namespace vq {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// round half to even, then saturate to int8 (jnp.clip(jnp.round(.), -128, 127))
__device__ __forceinline__ int8_t round_sat_s8(float v) {
  float r = rintf(v);
  r = fminf(fmaxf(r, -128.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(r));
}

// four ints saturated to int8 and packed, c0 in the lowest byte
// (cvt.pack.sat: two instructions for the clamp and the pack of four)
__device__ __forceinline__ uint32_t pack_sat_s8(int c0, int c1, int c2,
                                                int c3) {
  uint32_t hi, out;
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, 0;\n"
      : "=r"(hi)
      : "r"(c3), "r"(c2));
  asm("cvt.pack.sat.s8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(c1), "r"(c0), "r"(hi));
  return out;
}

// the sum of a word's four int8 codes, added to acc
__device__ __forceinline__ int sum_s8x4(uint32_t w, int acc) {
  return __dp4a(static_cast<int>(w), 0x01010101, acc);
}

// --- 16-byte vectors of bf16 or f32 (K1, K4, K7a)

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// the bf16 value in the low (hi = 0) or high half of a word, as float
__device__ __forceinline__ float bf16_half(uint32_t w, int hi) {
  return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
}

// element e of a 16-byte vector of T, as float (exact)
template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e);
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& r, int e) {
  return bf16_half(word(r, e >> 1), e & 1);
}
template <>
__device__ __forceinline__ float elem<float>(const uint4& r, int e) {
  return __uint_as_float(word(r, e));
}

// The row quantizer of the fused producers (K1, K4, K3's asym emission;
// `_quantize_rows_f32`, fused_matmul.py:118-137), every division a true
// IEEE division:
//   sym : s = max(absmax / 127, 1e-6), inv = 1/s, codes = clip(rint(x*inv))
//   asym: s = max((hi - lo) / 255, 1e-6) with lo = min(x, 0), hi = max(x, 0),
//         inv = 1/s, zp = rint(-lo * inv) - 128,
//         codes = clip(rint(x * inv) + zp, -128, 127)
struct RowQuant {
  float s, inv, zp;
  static __device__ __forceinline__ RowQuant sym(float absmax) {
    const float s = fmaxf(absmax / 127.0f, 1e-6f);
    return {s, 1.0f / s, 0.0f};
  }
  static __device__ __forceinline__ RowQuant asym(float lo, float hi) {
    const float s = fmaxf((hi - lo) / 255.0f, 1e-6f);
    const float inv = 1.0f / s;
    return {s, inv, rintf(-lo * inv) - 128.0f};
  }
  // The channel-balancing fold of the consuming layer (`col_scale`, the
  // smooth-quant 1/cs): the value times its column's scale, one rounded f32
  // multiply (-fmad=false keeps it out of any neighbouring FMA), taken
  // where the JAX kernels take it: after the GELU, before the row statistic
  // (fused_matmul.py:167-168, :372-374, :593-596; attention.py:213-216).
  // K2's emission, K3's emissions, K4 and K5 share this one definition.
  static __device__ __forceinline__ float balance(float x, float cs) {
    return x * cs;
  }
  // cs[col .. col + 3], zeros at and past K; vec: cs 16-byte aligned and
  // K % 4 == 0 (col a multiple of 4), so one vector load
  static __device__ __forceinline__ float4 col_scales4(const float* cs,
                                                      int col, int K,
                                                      bool vec) {
    if (col >= K) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (vec) return __ldg(reinterpret_cast<const float4*>(cs + col));
    return make_float4(__ldg(cs + col),
                       col + 1 < K ? __ldg(cs + col + 1) : 0.0f,
                       col + 2 < K ? __ldg(cs + col + 2) : 0.0f,
                       col + 3 < K ? __ldg(cs + col + 3) : 0.0f);
  }
  template <bool SYM>
  __device__ __forceinline__ int8_t code(float x) const {
    if constexpr (SYM) {
      return round_sat_s8(x * inv);
    } else {
      const float c = fminf(fmaxf(rintf(x * inv) + zp, -128.0f), 127.0f);
      return static_cast<int8_t>(static_cast<int>(c));
    }
  }
  // the codes of x[0..3] packed into a word, x[0] in the lowest byte: the
  // same codes as code<SYM> (rint(x * inv) is an integer, and |x * inv| <=
  // 255 (asym) or 127 (sym) for finite x, so adding zp in int32 and
  // saturating is the float clip)
  template <bool SYM>
  __device__ __forceinline__ uint32_t pack4(const float* x) const {
    const int z = SYM ? 0 : static_cast<int>(zp);
    return pack_sat_s8(__float2int_rn(x[0] * inv) + z,
                       __float2int_rn(x[1] * inv) + z,
                       __float2int_rn(x[2] * inv) + z,
                       __float2int_rn(x[3] * inv) + z);
  }
  // one warp's row: lane 0 writes the scale, the zero point (asym) and the
  // code sum (where rowsum is not null; sum: this lane's partial sum, an
  // exact integer stored as f32)
  template <bool SYM>
  __device__ __forceinline__ void store(int row, int lane, int sum,
                                        float* qs, float* zps,
                                        float* rowsum) const {
    if (rowsum != nullptr) sum = warp_sum_int(sum);
    if (lane != 0) return;
    qs[row] = s;
    if (!SYM) zps[row] = zp;
    if (rowsum != nullptr) rowsum[row] = static_cast<float>(sum);
  }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// --- Hopper async helpers shared by the wgmma cores (attn_core.cuh,
// int8_mma.cuh)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// make this thread's generic-proxy shared writes (st.shared, cp.async)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// barrier `id` of `threads` threads (a multiple of 32) of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// pin the accumulators after a wgmma wait, so no read of them is scheduled
// before it. Only where no wgmma is in flight: touching registers an
// in-flight wgmma writes makes ptxas wait for it (serializing the loop)
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// --- mbarriers (the int8 GEMM core's ring, the seg attention's bulk loads)

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of `parity` to complete. A barrier that does not
// complete within ~10 s is a fault of the kernel: trap (a launch error the
// wrapper reports) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) {
      start = now;
    } else if (now - start > 20000000000ll) {
      __trap();
    }
  }
}

// one-dimensional bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) from global to shared memory, completing on mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace vq
