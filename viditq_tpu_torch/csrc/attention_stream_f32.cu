// K6 in float32: the kv-streaming (online-softmax) attention for f32 q/k/v
// and an f32 output, full or kv-masked: the float32 block of AdaRound
// reconstruction at kv lengths above the one-shot range (PixArt-Σ 1024's
// self-attention in blocks 0-13, N = M = 4096, 16 heads of 72;
// viditq_tpu/quant/reconstruction.py:431-461).
//
// Replaces the TPU kernel `_attn_stream_kernel` (viditq_tpu/kernels/
// attention.py:236-368, launched at :699) when its inputs are f32, with the
// recurrence of that kernel in f32 (:287-291, :328-330, :343-346) and of
// the port's plain version (kernels/attention.py
// `attention_bnhd_stream_plain`). In float32 nothing is rounded against the
// running max (e and v stay f32), so the kv block that fixes the bf16
// mode's numerics (C3) only moves f32 rounding here: the launch takes no
// `bkv`, and the running max moves once per kv tile of the float32 core
// (csrc/attn_f32_core.cuh: q.k on the bf16 tensor cores, the PV as three
// TF32 products, one pass; its header states the design and the bound),
// which K3's float32 mode launches too.

#include "attn_f32_core.cuh"

// q [B, N, H*D], k/v [B, M, H*D], out [B, N, H*D], all f32 and 16-byte
// aligned; mask [B, M] int32 (1 = attend) or null; scale2 = scale * log2(e).
VQ_EXPORT int vq_attention_stream_f32(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* out, int B, int N, int M, int H,
                                      int D, float scale2, void* stream) {
  return static_cast<int>(vq::attn_f32::launch_core_any(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(mask),
      static_cast<float*>(out), B, N, M, H, D, scale2,
      static_cast<cudaStream_t>(stream)));
}
