"""Layout-native attention (K3, K6): port of `viditq_tpu/kernels/attention.py`.

`attention_bnhd` takes q/k/v in the projection's layout [B, N, H, D] and
dispatches as the JAX package does (attention.py:643):

  * K3, the one-shot kernel (`_attn_kernel`, attention.py:80-234), for
    block-diagonal attention and for kv lengths M <= ONESHOT_MAX_M: an f32
    base-2 softmax over bf16-cast scores against the row's global max, a
    float PV or the int8 PV, and optionally its output row-quantized
    across all heads for the proj linear (the attention's own formulas:
    sym, or asym with zero point, and the code row sum on request);
  * K6, the kv-streaming kernel (`_attn_stream_kernel`, attention.py:
    236-368), for full or kv-masked attention with M > ONESHOT_MAX_M: an
    online softmax whose running max updates once per kv block of
    `stream_kv_block` rows, unnormalised `e` in v's dtype, a `corr`
    rescale of the accumulator, int8-PV codes rounded against the running
    max (C3), and emission through K4's row quantize of the q-dtype output
    (attention.py:705-713), sym or asym.

An emission may take the proj's channel-balancing column scale
(`col_scale`, JAX `out_col_scale`, attention.py:213-216): the f32 output
times it, before the row statistic.

On CPU tensors each runs its plain version (`attention_bnhd_plain`,
`attention_bnhd_stream_plain`); on CUDA tensors it launches
csrc/attention.cu or csrc/attention_stream.cu (bf16 inputs), or for f32
q/k/v (the float32 block of AdaRound reconstruction) the float32 modes:
K3's, csrc/attention_f32.cu (full, kv-masked and seg), and K6's,
csrc/attention_stream_f32.cu (full and kv-masked), both with the float PV
and no emission; or raises. Their full and kv-masked modes are one core
(csrc/attn_f32_core.cuh): one pass whose running max moves once per 64-row
kv tile (in f32 the kv block moves only rounding), q.k on the bf16 tensor
cores, the PV as three TF32 products (`pv_tf32` is its plain emulation,
for the tests); K3's seg mode is a kernel of its own, on the CUDA cores.

Gradients (JAX `custom_vjp`, attention.py:530-557): where q, k or v
requires grad, `attention_bnhd` runs its forward as above and its backward
recomputes through `attention_bnhd_xla`, the plain attention with an f32
softmax and q.k in f32 (no bf16 rounding), as the JAX package does: the
straight-through convention for the int8 modes. The emitting form
(emit=True, JAX `attention_bnhd_int8out`) has no gradient.
Both kernels' full and kv-masked modes run on one core
(csrc/attn_core.cuh: wgmma products over kv tiles of `KV_TILE` rows fed by
a cp.async ring); their int8 PV reads v's codes transposed per head in the
order `KV_PERM` (`v_codes_transposed`). K3's seg mode runs a kernel of its
own: a block per 16-row tile across all heads, its emission inside
the kernel, its int8 PV on v codes per tile and channel in the order
`KV_PERM[:16]` (`v_codes_tiles`); shapes that `seg_tiled` refuses take a
row kernel, whose emission takes two launches.

int8_qk (the attn8 plan's q/k quantizers) runs K8, `qk_headwise_quant`
(csrc/qk_quant.cu: one launch for q and k), on q and k before every mode,
as the JAX package applies `_fake_quant_tokens_headwise` (attention.py:
481-490, :625-627): the products stay bf16, on dequantized values.

The oracles `attention_bnhd_xla` / `attention_bnhd_xla_quant`
(attention.py:409-478) are ported too; the tests hold both packages'
oracles and kernel paths against each other.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels._common import (col_scale_arg, divc, on_cuda,
                                              rdiv, require)
from viditq_tpu_torch.kernels._counters import COUNTERS, count_plain
from viditq_tpu_torch.kernels.fused_matmul import (balance_cols,
                                                   quantize_rows,
                                                   quantize_rows_f32)

LOG2E = float(math.log2(math.e))
# head dims instantiated in csrc/attention*.cu, attn_core.cuh and
# attn_f32_core.cuh; a CUDA call at any other D up to the widest is padded
# with zero channels to the next of them (`_padded_heads`). Heads wider
# than 128 split their output columns over blocks (or warps), each taking
# the whole head's q.k (csrc/attn_core.cuh `block_cols`).
KERNEL_HEAD_DIMS = (16, 32, 64, 72, 128, 192, 256)
# JAX's gate of its attention kernels (attention.py:834): H * D * 2 bytes
# <= 4096, so H * D <= MAX_HD
MAX_HD = 2048
QK_MAX_D = MAX_HD  # K8's widest head (csrc/qk_quant.cu)
# seg mode's tiled kernel (csrc/attention.cu attn_seg_tiled): a block
# holds SEG_TILE rows of all heads (H/2 warps), so seg_len must divide
# SEG_TILE and H be even, at most SEG_MAX_HEADS, at a head dim of
# SEG_TILED_HEAD_DIMS; its v-quantize pass holds a v group in shared memory
# (at most SEG_MAX_V_BLOCK rows). Other shapes run the row kernel
# (attn_seg_rows).
SEG_TILE = 16
SEG_MAX_HEADS = 32
SEG_MAX_V_BLOCK = 1024
SEG_TILED_HEAD_DIMS = (16, 32, 64, 72)
# ... and at the wide head dims, a warp a half head (`seg_parts`): H <=
# SEG_WIDE_MAX_HEADS, any H
SEG_WIDE_HEAD_DIMS = (192, 256)
SEG_WIDE_MAX_HEADS = 8
# the row kernel's output columns a block at head dims above 128
# (`rows_cols`): its emission's range statistic is one per such part
SEG_ROWS_WIDE_COLS = 64
# full/masked attention over more kv rows than this streams them (K6)
ONESHOT_MAX_M = 2048
KV_TILE = 64  # kv rows per tile of csrc/attn_core.cuh
# kv row (within its 32-row chunk) of byte k of a chunk of the transposed
# v codes: the k index of the s8 wgmma's register operand packed from the
# score registers holds that column (csrc/attn_core.cuh pack_codes)
KV_PERM = tuple((k // 16) * 16 + (k % 4 // 2) * 8 + (k % 16 // 4) * 2
                + k % 2 for k in range(32))


def seg_tiled(heads: int, seg_len: int, int8_pv: bool,
              v_block: Optional[int], head_dim: int) -> bool:
    """Whether seg mode runs the tiled kernel on the card (else the row
    kernel): a shape rule, the same for every input."""
    heads_ok = ((heads % 2 == 0 and heads <= SEG_MAX_HEADS
                 and head_dim in SEG_TILED_HEAD_DIMS)
                or (heads <= SEG_WIDE_MAX_HEADS
                    and head_dim in SEG_WIDE_HEAD_DIMS))
    return (SEG_TILE % seg_len == 0 and heads_ok
            and (not int8_pv or v_block <= SEG_MAX_V_BLOCK))


def seg_rows_parts(head_dim: int) -> int:
    """Blocks a head of the seg row kernel (csrc/attention.cu
    `rows_cols`): 1, or one a SEG_ROWS_WIDE_COLS columns above 128."""
    return head_dim // SEG_ROWS_WIDE_COLS if head_dim > 128 else 1


def _padded_heads(fn, q, k, v, col_scale=None, emit=False, emit_sym=True):
    """fn (an attention dispatch taking q, k, v and col_scale) at the next
    instantiated head dim (KERNEL_HEAD_DIMS): q, k and v padded with zero
    channels per head, the column scales with zeros. The padded channels'
    outputs are exactly 0, so they move no softmax, no v scale (each
    channel its own) and no row statistic (the sym absmax and the asym
    range both hold 0); sym codes there are 0 and asym ones the zero
    point, which the row sum loses again (H * pad * zp, exact integers in
    f32). The output, or the emitted codes, are sliced back to D. Raises
    above JAX's gate (H * D > MAX_HD), above the widest instantiation, and
    where the padded heads pass the gate (H * Dp > MAX_HD)."""
    B, N, H, D = q.shape
    require(H * D <= MAX_HD, f"H * D = {H * D} above {MAX_HD}, JAX's gate")
    require(D <= KERNEL_HEAD_DIMS[-1], f"head dim {D}: the CUDA attention "
            f"kernels take D <= {KERNEL_HEAD_DIMS[-1]} (wider heads would "
            "sum q.k over D in pieces whose q tile exceeds shared memory)")
    Dp = next(w for w in KERNEL_HEAD_DIMS if w >= D)
    require(H * Dp <= MAX_HD, f"head dim {D} pads to {Dp}: H * {Dp} = "
            f"{H * Dp} above {MAX_HD}")

    def pad(t):
        return torch.nn.functional.pad(t, (0, Dp - D))
    cs = (None if col_scale is None
          else pad(col_scale.reshape(H, D).float()).reshape(H * Dp))
    out = fn(pad(q), pad(k), pad(v), cs)
    if not emit:
        return out[..., :D].contiguous()
    codes, scales, zp, rowsum = out
    codes = codes.reshape(B, N, H, Dp)[..., :D].reshape(B, N, H * D)
    if rowsum is not None and not emit_sym:
        rowsum = rowsum - float(H * (Dp - D)) * zp
    return codes, scales, zp, rowsum


def stream_kv_block(n: int, m: int, c: int, v_int8_in: bool = False) -> int:
    """Kv rows per online-softmax step of K6 (`select_stream_blocks`,
    attention.py:371-406, without its environment overrides).

    The running max updates once per block, so the block fixes the bf16
    rounding of `e` and the int8-PV codes (C3): like `seg_v_block` it is a
    numerics rule, kept as an explicit parameter. 1024 at PixArt-Σ 1024
    (N = M = 4096, C = 1152), 256 at N = M = 2304. The TPU rule picks the
    largest power-of-two q block (<= 512) and kv block (<= 1024) dividing
    the lengths whose VMEM estimate fits 16 MB."""
    def vmem(bq, bkv):
        return (bq * c * 2 + 2 * bkv * c * 2
                + 2 * bkv * c * (1 if v_int8_in else 2)
                + bq * c * 4 + bq * bkv * 4 + 2 * bq * 128 * 4)

    for bq in (512, 256, 128):
        if n % bq:
            continue
        for bkv in (1024, 512, 256, 128):
            if m % bkv == 0 and vmem(bq, bkv) <= 16e6:
                return bkv
    raise ValueError(f"no kv-streaming block for N={n}, M={m}, C={c}")


def seg_v_block(n: int, seg_len: int) -> int:
    """Token group of the per-channel v scales in block-diagonal int8 PV.

    The TPU kernel quantizes v per (q-block x channel) in VMEM, and its
    q-block comes from `select_block_q` (attention.py:511-519): the largest
    multiple of seg_len not above max(seg_len, 256) that divides n. That
    tiling choice fixes the numerics (C2), so the port keeps the rule as an
    explicit parameter: 256 at the main path (n = 16384, seg_len = 16)."""
    cap = max(seg_len, 256)
    return next(k * seg_len for k in range(cap // seg_len, 0, -1)
                if n % (k * seg_len) == 0)


def headwise_fake_quant(t: torch.Tensor) -> torch.Tensor:
    """Per-(token, head) sym int8 quantize-dequantize of t [..., D] over
    its last axis in f32 (`_fake_quant_tokens_headwise`, attention.py:
    481-490): sc = max(max |t|, 1e-6), round(t * (127 / sc)) * (sc / 127),
    both divisions true ones, cast back to t's dtype."""
    tf = t.float()
    sc = torch.clamp(tf.abs().amax(dim=-1, keepdim=True), min=1e-6)
    return (torch.round(tf * rdiv(127.0, sc)) * divc(sc, 127.0)).to(t.dtype)


def qk_headwise_quant_plain(q: torch.Tensor, k: torch.Tensor):
    count_plain("qk_headwise_quant", q)
    return headwise_fake_quant(q), headwise_fake_quant(k)


def qk_headwise_quant(q: torch.Tensor, k: torch.Tensor):
    """K8: the attention's int8 q/k quantizers, q [B, N, H, D] and k
    [B, M, H, D] -> (q, k) quantize-dequantized per (token, head) in their
    own dtype (`headwise_fake_quant`). On the card one launch of
    csrc/qk_quant.cu takes both (bf16, D <= QK_MAX_D; D % 8 != 0 padded
    with zero channels)."""
    if not on_cuda(q, k):
        return qk_headwise_quant_plain(q, k)
    D = q.shape[-1]
    require(q.dtype == k.dtype == torch.bfloat16,
            "the CUDA q/k quantizer takes bfloat16 q and k")
    require(k.shape[-1] == D and D <= QK_MAX_D,
            f"head dim {D}: K8 takes D <= {QK_MAX_D}")
    if D % 8:  # zero channels: no row's absmax moves; sliced off again
        pad = -D % 8
        qo, ko = qk_headwise_quant(torch.nn.functional.pad(q, (0, pad)),
                                   torch.nn.functional.pad(k, (0, pad)))
        return qo[..., :D].contiguous(), ko[..., :D].contiguous()
    q1, k1 = _aligned(q), _aligned(k)
    qo, ko = torch.empty_like(q1), torch.empty_like(k1)
    _build.check(_build.lib().vq_qk_headwise_quant(
        q1.data_ptr(), k1.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        q1.numel() // D, k1.numel() // D, D, _build.stream_ptr(q)),
        "vq_qk_headwise_quant")
    COUNTERS["qk_headwise_quant"].launches += 1
    return qo, ko


def _v_quant(v: torch.Tensor, v_block: int):
    """Per-(v_block tokens x channel) sym int8 codes of v [B, M, C] (float
    values) and scales [B, M // v_block, C]."""
    B, M, C = v.shape
    vg = v.float().reshape(B, M // v_block, v_block, C)
    vs = torch.clamp(vg.abs().amax(dim=2, keepdim=True), min=1e-6)
    vq = torch.round(vg * rdiv(127.0, vs))
    return vq.reshape(B, M, C), vs.reshape(B, M // v_block, C)


def kv_padded(m: int) -> int:
    """Kv length of the transposed v codes: m rounded up to a whole tile."""
    return -(-m // KV_TILE) * KV_TILE


def v_codes_transposed(vq: torch.Tensor, heads: int) -> torch.Tensor:
    """The full modes' v-code layout (csrc/attention.cu vquant_kernel_t),
    plain version: codes [B, M, H*D] -> int8 [B, H, D, kv_padded(M)], zero
    past M, the rows of every 32-row chunk in KV_PERM order."""
    B, M, C = vq.shape
    D = C // heads
    Mp = kv_padded(M)
    vt = torch.zeros((B, Mp, heads, D), dtype=torch.int8, device=vq.device)
    vt[:, :M] = vq.reshape(B, M, heads, D).to(torch.int8)
    perm = torch.tensor(KV_PERM, device=vq.device)
    vt = vt.reshape(B, Mp // 32, 32, heads, D)[:, :, perm]
    return vt.reshape(B, Mp, heads, D).permute(0, 2, 3, 1).contiguous()


def v_codes_tiles(vq: torch.Tensor) -> torch.Tensor:
    """The tiled seg kernel's v-code layout (csrc/attention.cu
    vquant_tiles_kernel), plain version: codes [B, N, C] -> int8
    [B, ceil(N/16), C, 16], per 16-row tile and channel the rows in the
    order KV_PERM[:16], zero past N."""
    B, N, C = vq.shape
    nt = -(-N // SEG_TILE)
    vt = torch.zeros((B, nt * SEG_TILE, C), dtype=torch.int8,
                     device=vq.device)
    vt[:, :N] = vq.to(torch.int8)
    perm = torch.tensor(KV_PERM[:SEG_TILE], device=vq.device)
    vt = vt.reshape(B, nt, SEG_TILE, C)[:, :, perm]
    return vt.permute(0, 1, 3, 2).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself if contiguous and 16-byte aligned (the kernels' vector
    loads), else a fresh copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _v_codes_cuda(v3: torch.Tensor, heads: int, lib, stream):
    """Scales [B, 1, C] and transposed codes of v [B, M, C] on the card."""
    B, M, C = v3.shape
    Mp = kv_padded(M)
    vt = torch.empty((B, heads, C // heads, Mp), dtype=torch.int8,
                     device=v3.device)
    vs = torch.empty((B, 1, C), dtype=torch.float32, device=v3.device)
    _build.check(lib.vq_attn_vquant_t(
        v3.data_ptr(), vt.data_ptr(), vs.data_ptr(), B, M, heads, C // heads,
        Mp, stream), "vq_attn_vquant_t")
    return vt, vs


def _row_quant_emit(of: torch.Tensor, emit_sym: bool = True,
                    need_rowsum: bool = False, col_scale=None):
    """Emission row quantize, the attention site's forms (attention.py:
    213-233): the column scales first (where given), then sym smax =
    max(absmax, 1e-6), codes = round(o * (127/smax)), scale smax / 127;
    asym `_quantize_rows_f32`'s (inv = 1/scale). Returns (codes, scales,
    zp | None, rowsum | None)."""
    of = balance_cols(of, col_scale)
    if emit_sym:
        smax = torch.clamp(of.abs().amax(dim=-1, keepdim=True), min=1e-6)
        codes = torch.clamp(torch.round(of * rdiv(127.0, smax)), -128, 127)
        scale, zp = smax / 127.0, None
    else:
        codes, scale, zp = quantize_rows_f32(of, sym=False)
    rowsum = codes.sum(dim=-1, keepdim=True) if need_rowsum else None
    return codes.to(torch.int8), scale, zp, rowsum


def attention_bnhd_plain(q, k, v, scale: float, seg_len: int = 0,
                         kv_mask: Optional[torch.Tensor] = None,
                         int8_pv: bool = False, v_block: Optional[int] = None,
                         emit: bool = False, emit_sym: bool = True,
                         need_rowsum: bool = False, col_scale=None,
                         int8_qk: bool = False):
    """K3's plain version; int8_qk: K8's plain version on q and k
    first."""
    if int8_qk:
        q, k = qk_headwise_quant_plain(q, k)
    count_plain("attention_bnhd", q)
    B, N, H, D = q.shape
    M = k.shape[1]
    C = H * D
    qf = (q.float() * (scale * LOG2E)).to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float()
    if seg_len > 0:
        G = N // seg_len
        s = torch.einsum("bgnhd,bgmhd->bghnm",
                         qf.reshape(B, G, seg_len, H, D),
                         kf.reshape(B, G, seg_len, H, D))
    else:
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf)
        if kv_mask is not None:
            s = s + torch.where(kv_mask[:, None, None, :] != 0, 0.0,
                                float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    r = e.sum(dim=-1, keepdim=True)
    if int8_pv:
        pq = torch.round(e * 127.0).double()
        vb = v_block if seg_len > 0 else M
        vq, vs = _v_quant(v.reshape(B, M, C), vb)
        vq = vq.reshape(B, M, H, D).double()
        t = rdiv(1.0 / (127.0 * 127.0), r)
        if seg_len > 0:
            acc = torch.einsum("bghnm,bgmhd->bghnd", pq,
                               vq.reshape(B, G, seg_len, H, D)).float()
            # v scale of each row's group: rows of one segment share it
            vsr = vs.reshape(B, N // vb, 1, H, D).expand(
                B, N // vb, vb // seg_len, H, D).reshape(B, G, H, 1, D)
            o = (acc * t) * vsr                       # [B, G, H, seg, D]
            o = o.permute(0, 1, 3, 2, 4).reshape(B, N, H, D)
        else:
            acc = torch.einsum("bhnm,bmhd->bhnd", pq, vq).float()
            o = (acc * t) * vs.reshape(B, H, 1, D)
            o = o.permute(0, 2, 1, 3)
    else:
        p = (e * rdiv(1.0, r)).to(v.dtype).float()
        vf = v.float()
        if seg_len > 0:
            o = torch.einsum("bghnm,bgmhd->bgnhd", p,
                             vf.reshape(B, G, seg_len, H, D))
            o = o.reshape(B, N, H, D)
        else:
            o = torch.einsum("bhnm,bmhd->bnhd", p, vf)
    if emit:
        return _row_quant_emit(o.reshape(B, N, C), emit_sym, need_rowsum,
                               col_scale)
    return o.to(q.dtype)


def attention_bnhd_stream_plain(q, k, v, scale: float, bkv: int,
                                kv_mask: Optional[torch.Tensor] = None,
                                int8_pv: bool = False):
    """K6's recurrence (attention.py:267-368) over kv blocks of exactly bkv
    rows; [B, N, H, D] -> [B, N, H, D] in q's dtype (no emission: the
    wrapper quantizes the rounded output with K4, as attention.py:705-713
    does). int8_pv quantizes v per channel over the whole kv axis
    (attention.py:636-642)."""
    count_plain("attention_bnhd_stream", q)
    B, N, H, D = q.shape
    M = k.shape[1]
    require(M % bkv == 0, f"kv length {M} is not a multiple of {bkv}")
    qf = (q.float() * (scale * LOG2E)).to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float()
    if int8_pv:
        vq, vs = _v_quant(v.reshape(B, M, H * D), M)
        vq = vq.reshape(B, M, H, D).double()
        vsd = (vs * (1.0 / (127.0 * 127.0))).reshape(B, H, 1, D)
    m = torch.full((B, H, N, 1), float("-inf"), device=q.device)
    r = torch.zeros((B, H, N, 1), device=q.device)
    acc = torch.zeros((B, H, N, D), device=q.device)
    for j in range(0, M, bkv):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, j:j + bkv])
        if kv_mask is not None:
            s = s + torch.where(kv_mask[:, None, None, j:j + bkv] != 0, 0.0,
                                float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # rows masked so far keep m = -inf; exp2(-inf - 0) is exactly 0
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        e = torch.exp2(s - m_safe)
        corr = torch.exp2(m - m_safe)
        r = r * corr + e.sum(dim=-1, keepdim=True)
        if int8_pv:
            pq = torch.round(e * 127.0).double()
            pv = torch.einsum("bhnm,bmhd->bhnd", pq,
                              vq[:, j:j + bkv]).float() * vsd
        else:
            pv = torch.einsum("bhnm,bmhd->bhnd", e.to(v.dtype).float(),
                              v[:, j:j + bkv].float())
        acc = acc * corr + pv
        m = m_new
    o = acc * rdiv(1.0, torch.clamp(r, min=1e-30))
    return o.permute(0, 2, 1, 3).to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, kept as f32: PTX `cvt.rna.tf32.f32` (finite x)."""
    bits = x.float().contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (mag | (bits & -2 ** 31)).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """x = hi + lo + (a residue below 2^-21 |x|), both TF32 values: the
    float32 core's operand split (csrc/attn_f32_core.cuh split_tf32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def pv_tf32(e: torch.Tensor, v: torch.Tensor, products: int = 3):
    """The float32 core's PV, plain: e [B, H, N, m] times v [B, m, H, D]
    -> [B, H, N, D] as TF32 products with f32 sums (each product of two
    TF32 values is exact in f32). products=3: e_hi.v_hi + e_hi.v_lo +
    e_lo.v_hi, the kernel's; products=1: e_hi.v_hi alone, one TF32
    product. Its sums round to nearest; the tensor cores' truncate, which
    the kernel confines to one kv tile. For the tests: no path runs it."""
    eh, el = split_tf32(e)
    vh, vl = split_tf32(v)
    pv = torch.einsum("bhnm,bmhd->bhnd", eh, vh)
    if products == 3:
        pv = pv + (torch.einsum("bhnm,bmhd->bhnd", eh, vl)
                   + torch.einsum("bhnm,bmhd->bhnd", el, vh))
    elif products != 1:
        raise ValueError(f"products is 1 or 3, not {products}")
    return pv


def attention_f32_emulation(q, k, v, scale: float,
                            kv_mask: Optional[torch.Tensor] = None,
                            products: int = 3):
    """The float32 core's full and kv-masked attention (csrc/
    attn_f32_core.cuh), plain: f32 [B, N, H, D] -> [B, N, H, D], K6's
    recurrence over kv tiles of KV_TILE rows (the last one ragged) with
    the PV as `pv_tf32` takes it; tiles masked whole skipped. For the
    tests: no path runs it."""
    B, N, H, D = q.shape
    M = k.shape[1]
    qf = (q.float() * (scale * LOG2E)).to(torch.bfloat16).float()
    kf = k.float().to(torch.bfloat16).float()
    m = torch.full((B, H, N, 1), float("-inf"), device=q.device)
    r = torch.zeros((B, H, N, 1), device=q.device)
    acc = torch.zeros((B, H, N, D), device=q.device)
    for j in range(0, M, KV_TILE):
        sl = slice(j, j + KV_TILE)
        if kv_mask is not None and not kv_mask[:, sl].any():
            continue
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, sl])
        if kv_mask is not None:
            s = s + torch.where(kv_mask[:, None, None, sl] != 0, 0.0,
                                float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        e = torch.exp2(s - m_safe)
        corr = torch.exp2(m - m_safe)
        r = r * corr + e.sum(dim=-1, keepdim=True)
        acc = acc * corr + pv_tf32(e, v[:, sl].float(), products)
        m = m_new
    o = acc * rdiv(1.0, torch.clamp(r, min=1e-30))
    return o.permute(0, 2, 1, 3)


def attention_bnhd_stream(q, k, v, scale: float,
                          kv_mask: Optional[torch.Tensor] = None,
                          int8_pv: bool = False, emit: bool = False,
                          bkv: Optional[int] = None, emit_sym: bool = True,
                          need_rowsum: bool = False, col_scale=None):
    """K6: kv-streaming attention for M > ONESHOT_MAX_M (see the module
    docstring). bkv defaults to `stream_kv_block` (f32 CUDA tensors run
    K6's float32 mode, which takes none). With emit=True returns
    (int8 codes [B, N, H*D], scales, zp | None, rowsum | None [B, N, 1])
    from K4 (emit_sym, need_rowsum, col_scale: its sym, need_rowsum and
    col_scale; attention.py:705-709)."""
    B, N, H, D = q.shape
    M = k.shape[1]
    C = H * D
    cuda = on_cuda(q, k, v, kv_mask)
    if bkv is None and not (cuda and q.dtype == torch.float32):
        bkv = stream_kv_block(N, M, C, v_int8_in=int8_pv)
    if cuda and D not in KERNEL_HEAD_DIMS:  # at the true D's kv block
        return _padded_heads(
            lambda q_, k_, v_, cs_: attention_bnhd_stream(
                q_, k_, v_, scale, kv_mask, int8_pv, emit, bkv, emit_sym,
                need_rowsum, cs_), q, k, v, col_scale, emit, emit_sym)
    if cuda and q.dtype == torch.float32:
        require(not (int8_pv or emit),
                "K6's float32 mode takes the float PV and no emission")
        return _attention_stream_f32_cuda(q, k, v, scale, kv_mask)
    if not cuda:
        out = attention_bnhd_stream_plain(q, k, v, scale, bkv, kv_mask,
                                          int8_pv)
    else:
        out = _attention_stream_cuda(q, k, v, scale, bkv, kv_mask, int8_pv)
    if not emit:
        return out
    return _bn1(B, N, *quantize_rows(out.reshape(B * N, C), sym=emit_sym,
                                     need_rowsum=need_rowsum,
                                     col_scale=col_scale))


def _bn1(B, N, codes, scales, zp, rowsum):
    """Emission outputs from [B*N, .] rows to [B, N, .]."""
    return tuple(None if t is None else t.reshape(B, N, -1)
                 for t in (codes, scales, zp, rowsum))


def _attention_stream_cuda(q, k, v, scale, bkv, kv_mask, int8_pv):
    B, N, H, D = q.shape
    M = k.shape[1]
    C = H * D
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            "the CUDA attention kernel takes bfloat16 q/k/v")
    require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    require(M % bkv == 0 and bkv % KV_TILE == 0,
            f"kv block {bkv} must divide M={M} and be a multiple of "
            f"{KV_TILE}")
    q3 = _aligned(q.reshape(B, N, C))
    k3 = _aligned(k.reshape(B, M, C))
    v3 = _aligned(v.reshape(B, M, C))
    lib = _build.lib()
    stream = _build.stream_ptr(q)
    vs = None
    v_arg = v3
    if int8_pv:
        v_arg, vs = _v_codes_cuda(v3, H, lib, stream)
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).reshape(B, M).contiguous()
    out = torch.empty((B, N, C), dtype=q.dtype, device=q.device)
    _build.check(lib.vq_attention_stream(
        q3.data_ptr(), k3.data_ptr(), v_arg.data_ptr(),
        None if vs is None else vs.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        B, N, M, H, D, bkv, float(scale * LOG2E), int(int8_pv), stream),
        "vq_attention_stream")
    COUNTERS["attention_bnhd_stream"].launches += 1
    return out.reshape(B, N, H, D)


def _attention_stream_f32_cuda(q, k, v, scale, kv_mask):
    """K6's float32 mode on the card (csrc/attention_stream_f32.cu, the
    float32 core): f32 q/k/v -> f32 output, full or kv-masked, any kv
    length."""
    B, N, H, D = q.shape
    M = k.shape[1]
    C = H * D
    require(k.dtype == v.dtype == torch.float32,
            "K6's float32 mode takes float32 q, k and v")
    require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    q3 = _aligned(q.reshape(B, N, C))
    k3 = _aligned(k.reshape(B, M, C))
    v3 = _aligned(v.reshape(B, M, C))
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).reshape(B, M).contiguous()
    out = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    _build.check(_build.lib().vq_attention_stream_f32(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), _ptr(mask),
        out.data_ptr(), B, N, M, H, D, float(scale * LOG2E),
        _build.stream_ptr(q)), "vq_attention_stream_f32")
    COUNTERS["attention_bnhd_stream_f32"].launches += 1
    return out.reshape(B, N, H, D)


class _AttentionVJP(torch.autograd.Function):
    """K3/K6's forward with the JAX package's backward: a recompute through
    `attention_bnhd_xla` (attention.py:542-554)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, seg_len, int8_pv, v_block,
                int8_qk):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.scale, ctx.seg_len = scale, seg_len
        return _attention_bnhd(q, k, v, scale, seg_len, kv_mask, int8_pv,
                               v_block, False, int8_qk)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_bnhd_xla(*qkv, ctx.scale, ctx.seg_len, kv_mask)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None, None


def attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, seg_len: int = 0,
                   kv_mask: Optional[torch.Tensor] = None,
                   int8_pv: bool = False, v_block: Optional[int] = None,
                   emit: bool = False, int8_qk: bool = False,
                   emit_sym: bool = True, need_rowsum: bool = False,
                   col_scale=None):
    """Softmax attention over [B, N, H, D] -> [B, N, H, D] (q's dtype), or
    with emit=True its output row-quantized for the proj linear, as JAX
    `attention_bnhd_int8out` returns it: (int8 codes [B, N, H*D], scales,
    zp | None, rowsum | None, each [B, N, 1] f32). emit_sym: sym codes, or
    asym ones with their zero point; need_rowsum: the code row sum (asym
    proj weights); col_scale [H*D]: the proj's channel-balancing 1/cs, the
    f32 output times it before the row statistic (emission only).

    seg_len > 0: block-diagonal attention in segments of seg_len tokens
    (k/v co-indexed with q). kv_mask [B, M] (1 = attend) masks kv tokens.
    int8_pv: round(e*127) softmax codes times per-channel int8 v, dequant
    folded into the output; v is grouped per `v_block` tokens in seg mode
    (default `seg_v_block(N, seg_len)`) and over the whole kv axis
    otherwise. Without seg_len and with M > ONESHOT_MAX_M the call goes to
    K6 (`attention_bnhd_stream`), as in the JAX package. int8_qk: q and k
    per-(token, head) int8 quantize-dequantized by K8 (`qk_headwise_quant`)
    first, in every mode. Differentiable where q, k or v requires grad
    (`_AttentionVJP`; not with emit)."""
    require(col_scale is None or emit, "col_scale applies to the emission")
    if (not emit and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return _AttentionVJP.apply(q, k, v, kv_mask, scale, seg_len, int8_pv,
                                   v_block, int8_qk)
    return _attention_bnhd(q, k, v, scale, seg_len, kv_mask, int8_pv,
                           v_block, emit, int8_qk, emit_sym, need_rowsum,
                           col_scale)


def _attention_bnhd(q, k, v, scale, seg_len=0, kv_mask=None, int8_pv=False,
                    v_block=None, emit=False, int8_qk=False, emit_sym=True,
                    need_rowsum=False, col_scale=None):
    """attention_bnhd's dispatch (JAX `_attention_bnhd_impl`)."""
    if int8_qk:
        q, k = qk_headwise_quant(q, k)
    B, N, H, D = q.shape
    M = k.shape[1]
    C = H * D
    require(seg_len == 0 or (M == N and N % seg_len == 0),
            "seg mode needs k/v co-indexed with q and N % seg_len == 0")
    require(seg_len == 0 or kv_mask is None, "seg mode takes no kv_mask")
    if seg_len == 0 and M > ONESHOT_MAX_M:
        return attention_bnhd_stream(q, k, v, scale, kv_mask, int8_pv, emit,
                                     emit_sym=emit_sym,
                                     need_rowsum=need_rowsum,
                                     col_scale=col_scale)
    if seg_len > 0 and int8_pv:
        v_block = seg_v_block(N, seg_len) if v_block is None else v_block
        require(v_block % seg_len == 0 and N % v_block == 0,
                f"v_block {v_block} must hold whole segments and divide N")
    if not on_cuda(q, k, v, kv_mask, col_scale):
        return attention_bnhd_plain(q, k, v, scale, seg_len, kv_mask,
                                    int8_pv, v_block, emit, emit_sym,
                                    need_rowsum, col_scale)
    if D not in KERNEL_HEAD_DIMS:
        return _padded_heads(
            lambda q_, k_, v_, cs_: _attention_bnhd(
                q_, k_, v_, scale, seg_len, kv_mask, int8_pv, v_block, emit,
                False, emit_sym, need_rowsum, cs_), q, k, v, col_scale, emit,
            emit_sym)
    if q.dtype == torch.float32:
        require(not (int8_pv or emit),
                "K3's float32 mode takes the float PV and no emission")
        return _attention_f32_cuda(q, k, v, scale, seg_len, kv_mask)
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            "the CUDA attention kernel takes bfloat16 q/k/v")
    require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    q3 = _aligned(q.reshape(B, N, C))
    k3 = _aligned(k.reshape(B, M, C))
    v3 = _aligned(v.reshape(B, M, C))
    cs = col_scale_arg(col_scale, C)
    if seg_len > 0:
        return _attention_seg_cuda(q3, k3, v3, H, float(scale * LOG2E),
                                   seg_len, int8_pv, v_block, emit, emit_sym,
                                   need_rowsum, cs)
    lib = _build.lib()
    stream = _build.stream_ptr(q)
    vs = None
    v_arg = v3
    if int8_pv:
        v_arg, vs = _v_codes_cuda(v3, H, lib, stream)
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).reshape(B, M).contiguous()
    out = torch.empty((B, N, C), dtype=torch.float32 if emit else q.dtype,
                      device=q.device)
    _build.check(lib.vq_attention(
        q3.data_ptr(), k3.data_ptr(), v_arg.data_ptr(),
        None if vs is None else vs.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), int(emit),
        B, N, M, H, D, float(scale * LOG2E), int(int8_pv), stream),
        "vq_attention")
    COUNTERS["attention_bnhd"].launches += 1
    if not emit:
        return out.reshape(B, N, H, D)
    rows = B * N
    codes = torch.empty((rows, C), dtype=torch.int8, device=q.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=q.device)
    zp = None if emit_sym else torch.empty_like(scales)
    rowsum = torch.empty_like(scales) if need_rowsum else None
    _build.check(lib.vq_attn_row_quant(
        out.data_ptr(), _ptr(cs), codes.data_ptr(), scales.data_ptr(),
        None if zp is None else zp.data_ptr(),
        None if rowsum is None else rowsum.data_ptr(), rows, C, stream),
        "vq_attn_row_quant")
    return _bn1(B, N, codes, scales, zp, rowsum)


def _attention_f32_cuda(q, k, v, scale, seg_len, kv_mask):
    """K3's float32 mode on the card (csrc/attention_f32.cu): f32 q/k/v ->
    f32 output, full or kv-masked (the float32 core, as K6's), or seg (its
    own kernel)."""
    B, N, H, D = q.shape
    M = k.shape[1]
    C = H * D
    require(k.dtype == v.dtype == torch.float32,
            "K3's float32 mode takes float32 q, k and v")
    require(D in KERNEL_HEAD_DIMS, f"head dim {D} not in {KERNEL_HEAD_DIMS}")
    q3 = _aligned(q.reshape(B, N, C))
    k3 = _aligned(k.reshape(B, M, C))
    v3 = _aligned(v.reshape(B, M, C))
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).reshape(B, M).contiguous()
    out = torch.empty((B, N, C), dtype=torch.float32, device=q.device)
    _build.check(_build.lib().vq_attention_f32(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), _ptr(mask),
        out.data_ptr(), B, N, M, H, D, seg_len, float(scale * LOG2E),
        _build.stream_ptr(q)), "vq_attention_f32")
    COUNTERS["attention_bnhd_f32"].launches += 1
    return out.reshape(B, N, H, D)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def seg_v_codes_cuda(v3: torch.Tensor, v_block: int, tiled: bool):
    """Seg mode's v-quantize pass on the card: codes of v [B, N, C] (bf16)
    in the layout of the kernel they feed (`v_codes_tiles` for the tiled
    kernel, [B, N, C] for the row kernel) and scales [B, N // v_block, C]."""
    B, N, C = v3.shape
    lib = _build.lib()
    vs = torch.empty((B, N // v_block, C), dtype=torch.float32,
                     device=v3.device)
    if tiled:
        vq = torch.empty((B, -(-N // SEG_TILE), C, SEG_TILE),
                         dtype=torch.int8, device=v3.device)
        fn, name = lib.vq_attn_vquant_tiles, "vq_attn_vquant_tiles"
    else:
        vq = torch.empty((B, N, C), dtype=torch.int8, device=v3.device)
        fn, name = lib.vq_attn_vquant, "vq_attn_vquant"
    _build.check(fn(v3.data_ptr(), vq.data_ptr(), vs.data_ptr(), B, N, C,
                    v_block, _build.stream_ptr(v3)), name)
    return vq, vs


def _attention_seg_cuda(q3, k3, v3, H, scale2, seg_len, int8_pv, v_block,
                        emit, emit_sym, need_rowsum, cs=None):
    """Seg mode on the card: the tiled kernel (emission inside it), or for
    other shapes (`seg_tiled`) the row kernel, whose emission takes two
    launches (each (row, head)'s output range, then the codes), both on
    the outputs times the column scales cs where given. Neither writes an
    f32 output. Int8 PV first quantizes v per (v_block tokens x channel)
    in the layout of the kernel it feeds."""
    B, N, C = q3.shape
    D = C // H
    lib = _build.lib()
    stream = _build.stream_ptr(q3)
    tiled = seg_tiled(H, seg_len, int8_pv, v_block, D)
    vs, v_arg = None, v3
    vgroup, n_vgroups = N, 1
    if int8_pv:
        vgroup, n_vgroups = v_block, N // v_block
        v_arg, vs = seg_v_codes_cuda(v3, v_block, tiled)
    out = codes = scales = zp = rowsum = None
    if emit:
        codes = torch.empty((B * N, C), dtype=torch.int8, device=q3.device)
        scales = torch.empty((B * N, 1), dtype=torch.float32,
                             device=q3.device)
        zp = None if emit_sym else torch.empty_like(scales)
        if need_rowsum:  # the row kernel adds each head's code sum
            rowsum = (torch.empty_like if tiled else torch.zeros_like)(scales)
    else:
        out = torch.empty((B, N, C), dtype=q3.dtype, device=q3.device)
    ins = (q3.data_ptr(), k3.data_ptr(), v_arg.data_ptr(), _ptr(vs), vgroup,
           n_vgroups, _ptr(out), _ptr(cs))
    outs = (_ptr(codes), _ptr(scales), _ptr(zp), _ptr(rowsum), B, N, H, D,
            seg_len, scale2, int(int8_pv))
    mode = 0 if not emit else 1 if emit_sym else 2
    if tiled:
        _build.check(lib.vq_attention_seg(*ins, *outs, mode, stream),
                     "vq_attention_seg")
    else:
        stats = (torch.empty((B * N, H * seg_rows_parts(D), 2),
                             dtype=torch.float32, device=q3.device)
                 if emit else None)
        for m in ((1, mode + 1) if emit else (0,)):
            _build.check(lib.vq_attention_seg_rows(*ins, _ptr(stats), *outs,
                                                   m, stream),
                         "vq_attention_seg_rows")
    COUNTERS["attention_bnhd"].launches += 1
    if not emit:
        return out.reshape(B, N, H, D)
    return _bn1(B, N, codes, scales, zp, rowsum)


# ---------------------------------------------------------------------------
# oracles (attention.py:409-478)
# ---------------------------------------------------------------------------

def attention_bnhd_xla(q, k, v, scale: float, seg_len: int = 0,
                       kv_mask: Optional[torch.Tensor] = None):
    """Reference attention with an f32 softmax (no bf16 score casts)."""
    B, N, H, D = q.shape
    if seg_len > 0:
        G = N // seg_len
        qs = q.reshape(B, G, seg_len, H, D)
        ks = k.reshape(B, G, seg_len, H, D)
        vs = v.reshape(B, G, seg_len, H, D)
        attn = torch.einsum("bgnhd,bgmhd->bghnm", (qs * scale).float(),
                            ks.float())
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        out = torch.einsum("bghnm,bgmhd->bgnhd", attn, vs)
        return out.reshape(B, N, H, D)
    attn = torch.einsum("bnhd,bmhd->bhnm", (q * scale).float(), k.float())
    if kv_mask is not None:
        attn = attn + torch.where(kv_mask[:, None, None, :] != 0, 0.0,
                                  float("-inf"))
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def attention_bnhd_xla_quant(q, k, v, scale: float, seg_len: int = 0,
                             kv_mask: Optional[torch.Tensor] = None,
                             int8_qk: bool = False, int8_pv: bool = False,
                             v_block: Optional[int] = None):
    """Oracle of the int8 attention math: per-token sym q/k quantize-
    dequantize over the head dim, kept in f32 (int8_qk), round(e*127)
    codes, per-channel v over v_block-token groups (int8_pv)."""
    if int8_qk:  # q and k stay f32, as in JAX, and v is promoted with them
        q, k, v = (headwise_fake_quant(q.float()),
                   headwise_fake_quant(k.float()), v.float())
    if not int8_pv:
        return attention_bnhd_xla(q, k, v, scale, seg_len, kv_mask)
    B, N, H, D = q.shape
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.einsum("bhnd,bhmd->bhnm", qh * scale, kh)
    if kv_mask is not None:
        s = s + torch.where(kv_mask[:, None, None, :] != 0, 0.0,
                            float("-inf"))
    if seg_len > 0:
        ri = torch.arange(s.shape[2]) // seg_len
        ci = torch.arange(s.shape[3]) // seg_len
        s = torch.where(ri[:, None] == ci[None, :], s, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = e.sum(dim=-1, keepdim=True)
    pq = torch.round(e * 127.0)
    M = vh.shape[2]
    vb = M if v_block is None else v_block
    vg = vh.reshape(B, H, M // vb, vb, D)
    vqs = torch.clamp(vg.abs().amax(dim=3, keepdim=True), min=1e-6)
    vq = (torch.round(vg * rdiv(127.0, vqs)) * (vqs / 127.0)).reshape(vh.shape)
    o = torch.einsum("bhnm,bhmd->bhnd", pq, vq)
    o = o * rdiv(1.0 / 127.0, r)
    return o.permute(0, 2, 1, 3).to(q.dtype)
