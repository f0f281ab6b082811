// The int8 x int8 -> int32 main loop shared by the int8 GEMMs (K2 in
// int8_gemm.cu, K7b in int_matmul.cu).
//
// A block of 256 threads computes a 128x128 tile of A [M, K] x W [K, N]
// over k-tiles of 64: two shared-memory buffers filled from registers (the
// next tile's global loads are in flight while the tensor cores run on the
// current one; no cp.async/TMA), 8 warps each computing 64x32 with
// mma.sync m16n8k32 s8 (int32 sums, exact). The weight tile arrives [K, N]
// (the JAX layout) and is transposed 4x4 bytes at a time (__byte_perm) into
// shared memory as [N][K], so each B fragment is one 32-bit load.
//
// EDGE = false takes K % 64 == 0, N % 4 == 0, 16-byte aligned A rows and
// 4-byte aligned W rows (rows past M and columns past N read as zero).
// EDGE = true takes any M, N, K and alignment: every byte is loaded on its
// own, and bytes past M, N or K are zero, which is exact for the product.
#pragma once

#include "common.cuh"

namespace vq {
namespace i8mma {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // padded shared row stride in bytes
constexpr int THREADS = 256;

struct Smem {
  __align__(16) int8_t a[2][BM * LDS];
  __align__(16) int8_t b[2][BN * LDS];
};

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t load_byte(const int8_t* p, bool ok,
                                              int shift) {
  return ok ? (static_cast<uint32_t>(static_cast<uint8_t>(*p)) << shift) : 0u;
}

// The tile at block (m0, n0): acc[mi][ni][e] of warp (wm, wn) holds row
// m0 + wm*64 + mi*16 + g + (e >= 2 ? 8 : 0), column
// n0 + wn*32 + ni*8 + t*2 + (e & 1), with g = lane/4, t = lane%4, wm =
// warp/4, wn = warp%4. after_tile(kt) runs after k-tile kt has been
// accumulated (all threads, after a barrier).
template <bool EDGE, typename AfterTile>
__device__ __forceinline__ void mainloop(const int8_t* __restrict__ A,
                                         const int8_t* __restrict__ W, int M,
                                         int N, int K, int m0, int n0,
                                         Smem& sm, int (&acc)[4][4][4],
                                         AfterTile after_tile) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;  // 2 warps along M, 64 rows each
  const int wn = warp & 3;   // 4 warps along N, 32 columns each
  const int g = lane >> 2;
  const int t = lane & 3;

  int4 a_reg[2];
  uint32_t b_reg[2][4];
  auto load_global = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * THREADS;  // A: BM rows x BK bytes, 16-byte vectors
      const int gm = m0 + (v >> 2);
      const int gk = k0 + (v & 3) * 16;
      if constexpr (EDGE) {
        uint32_t w[4];
        const int8_t* p = A + static_cast<size_t>(gm) * K + gk;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w[j] |= load_byte(p + j * 4 + b, gm < M && gk + j * 4 + b < K,
                              8 * b);
        }
        a_reg[i] = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                             static_cast<int>(w[2]), static_cast<int>(w[3]));
      } else {
        a_reg[i] = gm < M ? *reinterpret_cast<const int4*>(
                                A + static_cast<size_t>(gm) * K + gk)
                          : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // W: 4 k-rows x 4 n-columns per item; a warp covers 8 k-quads x 4
      // n-quads (16-byte row segments, spread shared-memory banks)
      const int blk = tid + i * THREADS;
      const int kq = ((blk >> 2) & 7) | (((blk >> 5) & 1) << 3);
      const int gn = n0 + ((blk & 3) | ((blk >> 6) << 2)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gk = k0 + kq * 4 + j;
        if constexpr (EDGE) {
          const int8_t* p = W + static_cast<size_t>(gk) * N + gn;
          uint32_t w = 0u;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            w |= load_byte(p + b, gk < K && gn + b < N, 8 * b);
          b_reg[i][j] = w;
        } else {
          b_reg[i][j] = gn < N ? *reinterpret_cast<const uint32_t*>(
                                     W + static_cast<size_t>(gk) * N + gn)
                               : 0u;
        }
      }
    }
  };
  auto store_smem = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * THREADS;
      *reinterpret_cast<int4*>(sm.a[buf] + (v >> 2) * LDS + (v & 3) * 16) =
          a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = tid + i * THREADS;
      const int kq = ((blk >> 2) & 7) | (((blk >> 5) & 1) << 3);
      const int cn = ((blk & 3) | ((blk >> 6) << 2)) * 4;
      // 4x4 byte transpose: word j holds 4 n-values at k-row j; word c of
      // the result holds 4 k-values at n-column c
      const uint32_t* w = b_reg[i];
      const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
      int8_t* dst = sm.b[buf] + cn * LDS + kq * 4;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + LDS) = __byte_perm(lo01, lo23, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * LDS) =
          __byte_perm(hi01, hi23, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * LDS) =
          __byte_perm(hi01, hi23, 0x7632);
    }
  };

  const int nk = EDGE ? (K + BK - 1) / BK : K / BK;
  load_global(0);
  store_smem(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load_global((kt + 1) * BK);
    const int8_t* as = sm.a[buf];
    const int8_t* bs = sm.b[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* ap = as + (wm * 64 + mi * 16 + g) * LDS + kk + t * 4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(ap);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(ap + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* bp = bs + (wn * 32 + ni * 8 + g) * LDS + kk + t * 4;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(bp);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(bp + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
    if (kt + 1 < nk) store_smem(buf ^ 1);
    __syncthreads();
    after_tile(kt);
  }
}

}  // namespace i8mma
}  // namespace vq
