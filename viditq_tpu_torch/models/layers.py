"""DiT layers of the port's backbones: STDiT, PixArt, DiT, Latte and MMDiT
(port of `viditq_tpu/models/layers.py`).

Linear layers that a plan may quantize are `QuantLinear`s built with the
spec their dotted name resolves to, exactly as in the JAX package, so the
same plan files and layer lists apply. The attention layers keep the
layout-native dataflow of the JAX kernel path: q/k/v stay [B, N, H, D] and
go to `attention_bnhd` (K3); under a fused plan the input quantize runs
once in a producer (K1 or K4) and the attention emits int8 for its proj
(K2), sym or asym as the proj's act spec says; on the native backend's
other impls q/k/v share one K7a pass, each runs K7b, and the attention
output goes to its proj in bf16. The port has
this one dataflow per impl; the JAX package's CPU fallbacks and
the TPU-only shape gates have no counterpart. Under channel balancing
(CB) each producer folds its consumers' 1/cs, read from the consuming
`QuantLinear` (`inv_balance`), as the JAX package folds it: K1 into the
adaLN shift/scale vectors, the shared q/k/v K4 pass and fc2's handoff (K4
or fc1's K2 emission) into the quantize, the attention emission before its
row statistic. The attention sites take the attn8 plan's q/k quantizers
(`int8_qk`: K8 before K3); an attention quantizer combination the
kernels do not take runs the JAX package's fake-quant fallback in plain
PyTorch (`fake_quant_attention`). `Mlp`, `SelfAttention` and `CrossAttention`
take an `epilogue` (residual, gate | None) for fc2 or the proj, and then
return the updated residual stream. PixArt-Σ's KV-compressed
self-attention keeps the JAX package's `sdpa` route: PyTorch's
`scaled_dot_product_attention` on CUDA tensors, where the JAX package
called the stock Pallas flash kernel (not a kernel of its own), and a copy
of `sdpa_xla` on CPU tensors.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from viditq_tpu_torch.kernels.attention import attention_bnhd, seg_v_block
from viditq_tpu_torch.kernels.fused_matmul import (emission_block_n,
                                                   ln_modulate_quantize,
                                                   quantize_rows)
from viditq_tpu_torch.quant import core as qcore
from viditq_tpu_torch.quant.qlinear import (Prequant, QuantCtx, QuantLinear,
                                            is_fused_dynamic,
                                            shared_prequant)
from viditq_tpu_torch.quant.spec import LayerQuantSpec

Resolver = Callable[[str], Optional[LayerQuantSpec]]


def no_quant(name: str) -> Optional[LayerQuantSpec]:
    return None


def t2i_modulate(x, shift, scale):
    """blocks.py:51."""
    return x * (1 + scale) + shift


def modulate(norm_x, shift, scale):
    """adaLN modulate with per-sample [B, C] vectors (layers.py:39)."""
    return norm_x * (1 + scale[:, None]) + shift[:, None]


def layer_norm(x: torch.Tensor, dtype, eps: float = 1e-6) -> torch.Tensor:
    """Non-affine LayerNorm in f32, cast to dtype (layers.py:43-54)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(dtype)


class AffineLayerNorm(nn.Module):
    """LayerNorm with learned scale and bias, eps 1e-6, in f32
    (layers.py:57-69)."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.bfloat16):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(self.dtype)


def approx_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-GELU as flax computes it, in x's dtype."""
    cdf = 0.5 * (1.0 + torch.tanh(0.7978845608028654
                                  * (x + 0.044715 * (x * x * x))))
    return x * cdf


def attn_quant_exec_flags(spec, qctx):
    """(int8_qk, int8_pv, kernel_ok) for one attention site's internal
    quantizers (layers.py:280-307)."""
    int8_qk = int8_pv = False
    ok = True
    if qctx is None or qctx.mode != "quant" or spec is None:
        return int8_qk, int8_pv, ok
    sm = spec.softmax
    aa = spec.attn_act
    if sm is not None:
        if (spec.impl == "fused" and sm.n_bits == 8
                and sm.always_zero and sm.dynamic):
            int8_pv = True
        else:
            ok = False
    if aa is not None:
        if (spec.impl == "fused" and aa.n_bits == 8
                and aa.dynamic and aa.sym and int8_pv):
            int8_qk = True
        else:
            ok = False
    return int8_qk, int8_pv, ok


def _exec_flags(spec, qctx):
    """(int8_qk, int8_pv) of an attention site whose quantizers the kernels
    take, None for a combination that runs the fake-quant fallback
    (`fake_quant_attention`, layers.py:536-570)."""
    int8_qk, int8_pv, ok = attn_quant_exec_flags(spec, qctx)
    return (int8_qk, int8_pv) if ok else None


def fake_quant_attention(q, k, v, spec, scale: float, kv_mask=None):
    """The JAX package's attention for quantizer combinations its kernel
    does not take (layers.py:543-570, :740-770), in plain PyTorch as JAX
    runs it in XLA: q, k, v [B, H, N, D] fake-quantized by `attn_act`
    (dynamic, per token position over batch, heads and channels); with a
    `softmax` spec the probabilities computed explicitly (f32 scores,
    softmax cast to q's dtype), fake-quantized and multiplied by v, else
    `sdpa`. kv_mask [B, M]: 1 = attend."""
    aa, sm = spec.attn_act, spec.softmax
    if aa is not None:
        q, k, v = (qcore.fake_quant_dynamic(t, aa) for t in (q, k, v))
    if sm is None:
        return sdpa(q, k, v, scale, kv_mask=kv_mask)
    attn = torch.einsum("bhnd,bhmd->bhnm", (q * scale).float(), k.float())
    if kv_mask is not None:
        attn = attn + _mask_bias(kv_mask)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    attn = qcore.fake_quant_dynamic(attn, sm)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


def ln_mod_prequant(resolver: Resolver, prefix: str, inp, shift, scale,
                    spec_names, qctx, consumer: QuantLinear, sp_mesh=None
                    ) -> Optional[Prequant]:
    """Fused LN + adaLN modulate + row quantize producer (layers.py:310-359):
    one K1 pass emits the int8 codes (and, for asym acts or weights, the
    zero points and code row sums) every consumer linear of `spec_names`
    takes. None when the consumers are not one fused-dynamic spec, or,
    under CB, do not share one cs (several consumers without
    `qkv_share_cs`). Under CB the consumers' 1/cs (`consumer`: the layer of
    spec_names[0]) folds into the adaLN vectors, since
    LN(x)*(1+scale)*ics + shift*ics = LN(x)*((1+scale)*ics) + shift*ics:
    shift*ics and (1+scale)*ics - 1 in f32, rounded to the vectors' dtype
    (layers.py:349-354). K1 itself is unchanged. None under an sp mesh
    (layers.py:325-326)."""
    if sp_mesh is not None:
        return None
    specs = [resolver(f"{prefix}.{n}") for n in spec_names]
    s0 = specs[0]
    if (s0 is None or any(s != s0 for s in specs)
            or s0.backend != "native" or s0.impl != "fused"
            or s0.act is None or not s0.act.dynamic
            or not s0.act_quant or not s0.weight_quant):
        return None
    smooth = s0.smooth_quant
    if smooth.enable and len(spec_names) > 1 and not smooth.qkv_share_cs:
        return None  # per-layer cs: one shared pass can't serve
    if qctx is None or qctx.mode != "quant" or qctx.capture:
        return None
    if smooth.enable:
        ics = consumer.inv_balance(qctx)
        shift = (shift.float() * ics).to(shift.dtype)
        scale = ((1.0 + scale.float()) * ics - 1.0).to(scale.dtype)
    return Prequant(*ln_modulate_quantize(
        inp, shift, scale, sym=s0.act.sym,
        need_rowsum=not (s0.weight is not None and s0.weight.sym)))


def attn_emit_int8_ok(pspec, qctx, has_col_scale: bool = False) -> bool:
    """Whether the attention emits its output int8 for the proj linear
    (layers.py:362-384, without the TPU device check). has_col_scale: the
    caller holds the proj's 1/cs; a CB proj emits only then, with the
    rescale folded into the emission."""
    return not (qctx is None or qctx.mode != "quant" or qctx.capture
                or pspec is None or pspec.backend != "native"
                or pspec.impl != "fused" or pspec.act is None
                or not pspec.act.dynamic
                or pspec.act.n_bits != 8 or pspec.weight is None
                or not pspec.act_quant or not pspec.weight_quant
                or (pspec.smooth_quant.enable and not has_col_scale)
                or pspec.split)


def emitted_prequant(emitted, C: int) -> Prequant:
    """The attention's emission (codes [B, N, C], scales, zp | None,
    rowsum | None [B, N, 1]) as its proj's `Prequant` over B*N rows."""
    codes, *rows = emitted
    return Prequant(codes.reshape(-1, C),
                    *(None if t is None else t.reshape(-1, 1) for t in rows))


class Mlp(nn.Module):
    """fc1 -> tanh-GELU -> fc2 (layers.py:76-168). Under a fused plan the
    handoff stays int8: with a producer prequant and sym acts x sym weights
    at fc2, fc1's epilogue applies the GELU and emits int8 codes with
    group-wise scales that fc2 consumes (K2 emit, K2 gw_x); otherwise fc1
    writes its output in the model dtype and one K4 pass applies the GELU
    and quantizes it per fc2's act spec (sym or asym, with the code row
    sum for asym weights), and fc2 consumes that prequant (K2). Under CB,
    fc2's 1/cs (fc2 is the handoff's only consumer) is applied after the
    GELU in either producer. token_layout / d_t / d_s: the token view of
    fc1's and fc2's token-wise act quantization (Latte's blocks)."""

    def __init__(self, in_features: int, hidden_features: int,
                 resolver: Resolver = no_quant, prefix: str = "",
                 dtype=torch.bfloat16, token_layout: Optional[str] = None,
                 d_t: int = 1, d_s: int = 1):
        super().__init__()
        self.hidden_features = hidden_features
        self.spec1 = resolver(f"{prefix}.fc1")
        self.spec2 = resolver(f"{prefix}.fc2")
        kw = dict(dtype=dtype, token_layout=token_layout, d_t=d_t, d_s=d_s)
        self.fc1 = QuantLinear(in_features, hidden_features, self.spec1,
                               **kw)
        self.fc2 = QuantLinear(hidden_features, in_features, self.spec2,
                               **kw)

    def forward(self, x, qctx: Optional[QuantCtx] = None, prequant=None,
                epilogue=None):
        """`epilogue`: (residual, gate | None) for fc2 (the block's
        `res + gate * mlp(x)`, `QuantLinear.forward`)."""
        spec1, spec2 = self.spec1, self.spec2
        ics2 = self.fc2.inv_balance(qctx)
        # capture mode: fc2 sees its real (post-GELU) input (layers.py:
        # 116-119)
        fused2 = (is_fused_dynamic(spec2) and qctx is not None
                  and qctx.mode == "quant" and not qctx.capture
                  and (not spec2.smooth_quant.enable or ics2 is not None))
        if fused2:
            emit1 = (prequant is not None and spec2.act.sym
                     and spec2.weight.sym and is_fused_dynamic(spec1)
                     and not spec1.split and spec1.act.n_bits == 8
                     and emission_block_n(self.hidden_features) > 0)
            if emit1:
                pre = self.fc1(None, qctx, prequant=prequant,
                               emit={"gelu": True, "col_scale": ics2})
            else:
                h = self.fc1(x, qctx, prequant=prequant)
                pre = Prequant(*quantize_rows(
                    h.reshape(-1, self.hidden_features), sym=spec2.act.sym,
                    gelu=True, need_rowsum=not spec2.weight.sym,
                    col_scale=ics2))
            return self.fc2(None, qctx, prequant=pre, epilogue=epilogue)
        x = approx_gelu(self.fc1(x, qctx, prequant=prequant))
        return self.fc2(x, qctx, epilogue=epilogue)


class SelfAttention(nn.Module):
    """Separate-q/k/v multi-head self-attention (layers.py:387-576, the
    layout-native branch). seg_len > 0: block-diagonal attention in
    segments of seg_len tokens (STDiT temporal attention; the CB act
    statistic of its linears views their input in those segments).
    token_layout / d_t / d_s: the token view of its linears' token-wise
    act quantization (STDiT's spatial attention: 'spatial'). qk_norm: q
    and k each through an affine LayerNorm over a head's channels before
    the attention, on every path (the kernels, the fake-quant fallback).

    sp_mesh (a `parallel.mesh.Mesh`) / sp_mode: sequence parallelism
    (layers.py:415-419, :460-479). With an sp axis of size > 1 dividing N
    and, for Ulysses, H, the attention runs through `ulysses_attention`
    ('ulysses'; 'auto' where sp divides H) or `ring_attention` ('ring';
    'auto' otherwise) on the q/k/v of the linears, and the proj takes its
    float output: as in JAX the branch returns before the plan's attention
    quantizers (softmax, attention acts, int8 q.k and PV) and the int8
    emission are read, and before qk_norm. Under tensor parallelism
    (`parallel/training.tp_shard_`) `num_heads` is this rank's share and
    the linears' widths follow it."""

    def __init__(self, dim: int, num_heads: int, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16, seg_len: int = 0,
                 token_layout: Optional[str] = None, d_t: int = 1,
                 d_s: int = 1, qk_norm: bool = False, sp_mesh=None,
                 sp_mode: str = "auto"):
        super().__init__()
        if sp_mode not in ("auto", "ulysses", "ring"):
            raise ValueError(f"unknown sp_mode {sp_mode!r}")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.sp_mesh, self.sp_mode = sp_mesh, sp_mode
        self.seg_len = seg_len
        self.qk_norm = qk_norm
        if qk_norm:
            # per head, over its D channels (layers.py:510-512, :546-548)
            self.q_norm = AffineLayerNorm(dim // num_heads, dtype=dtype)
            self.k_norm = AffineLayerNorm(dim // num_heads, dtype=dtype)
        self.specs = [resolver(f"{prefix}.{n}") for n in ("q", "k", "v")]
        self.pspec = resolver(f"{prefix}.proj")
        kw = dict(dtype=dtype, seg_len=seg_len, token_layout=token_layout,
                  d_t=d_t, d_s=d_s)
        self.q = QuantLinear(dim, dim, self.specs[0], **kw)
        self.k = QuantLinear(dim, dim, self.specs[1], **kw)
        self.v = QuantLinear(dim, dim, self.specs[2], **kw)
        self.proj = QuantLinear(dim, dim, self.pspec, **kw)

    def forward(self, x, qctx: Optional[QuantCtx] = None,
                prequant: Optional[Prequant] = None, shape=None,
                epilogue=None):
        """x [B, N, C]; with a producer `prequant` x may be None and
        `shape` gives (B, N, C). Under CB with `qkv_share_cs` the shared
        q/k/v quantize takes their pooled 1/cs (layers.py:437-450); the
        proj's 1/cs goes into the attention's emission (:481-530).
        `epilogue`: (residual, gate | None) for the proj; the return value
        is then the updated residual stream (layers.py:423-430)."""
        B, N, _ = x.shape if x is not None else shape
        H, D = self.num_heads, self.head_dim
        C = H * D  # the q/k/v width (this rank's heads under tp)
        pre = prequant
        s0 = self.specs[0]
        if (pre is None and all(s == s0 for s in self.specs)
                and qctx is not None and qctx.mode == "quant"):
            ics = (self.q.inv_balance(qctx) if s0 is not None
                   and s0.smooth_quant.qkv_share_cs else None)
            pre = shared_prequant(x, s0, col_scale=ics)
        q = self.q(x, qctx, prequant=pre).reshape(B, N, H, D)
        k = self.k(x, qctx, prequant=pre).reshape(B, N, H, D)
        v = self.v(x, qctx, prequant=pre).reshape(B, N, H, D)
        sp = 1 if self.sp_mesh is None else self.sp_mesh.shape["sp"]
        ring = self.sp_mode == "ring" or (self.sp_mode == "auto"
                                          and H % sp != 0)
        if sp > 1 and N % sp == 0 and (ring or H % sp == 0):
            from viditq_tpu_torch.parallel.ring import ring_attention
            from viditq_tpu_torch.parallel.ulysses import ulysses_attention
            out = (ring_attention if ring else ulysses_attention)(
                q, k, v, self.sp_mesh, scale=D ** -0.5)
            return self.proj(out.reshape(B, N, C), qctx, epilogue=epilogue)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        flags = _exec_flags(self.specs[0], qctx)
        if flags is None:
            # segments unpacked into the batch (layers.py:537-542)
            G = N // self.seg_len if self.seg_len > 0 else 1
            n = N // G

            def heads(t):
                return t.reshape(B * G, n, H, D).transpose(1, 2)
            out = fake_quant_attention(heads(q), heads(k), heads(v),
                                       self.specs[0], D ** -0.5)
            return self.proj(out.transpose(1, 2).reshape(B, N, C), qctx,
                             epilogue=epilogue)
        int8_qk, int8_pv = flags
        v_block = (seg_v_block(N, self.seg_len)
                   if int8_pv and self.seg_len > 0 else None)
        ics_p = self.proj.inv_balance(qctx)
        if attn_emit_int8_ok(self.pspec, qctx, ics_p is not None):
            out = self.proj(None, qctx, prequant=emitted_prequant(
                attention_bnhd(
                    q, k, v, scale=D ** -0.5, seg_len=self.seg_len,
                    int8_qk=int8_qk, int8_pv=int8_pv, v_block=v_block,
                    emit=True, emit_sym=self.pspec.act.sym,
                    need_rowsum=not self.pspec.weight.sym,
                    col_scale=ics_p), C), epilogue=epilogue)
            return out.reshape(B, N, C)
        out = attention_bnhd(q, k, v, scale=D ** -0.5, seg_len=self.seg_len,
                             int8_qk=int8_qk, int8_pv=int8_pv,
                             v_block=v_block)
        return self.proj(out.reshape(B, N, C), qctx, epilogue=epilogue)


def _mask_bias(kv_mask):
    """[B, M] (1 = attend) -> the additive f32 bias [B, 1, 1, M]."""
    return torch.where(kv_mask[:, None, None, :] != 0, 0.0,
                       float("-inf")).float()


def sdpa_xla(q, k, v, scale: float, kv_mask=None):
    """Attention over [B, H, N, D] with an f32 softmax (layers.py:171-184):
    scores in f32, probabilities cast to q's dtype before the PV."""
    attn = torch.einsum("bhnd,bhmd->bhnm", (q * scale).float(), k.float())
    if kv_mask is not None:
        attn = attn + _mask_bias(kv_mask)
    attn = torch.softmax(attn, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", attn, v)


def sdpa(q, k, v, scale: float, kv_mask=None):
    """layers.py:206-236 (kv_mask [B, M], 1 = attend): PyTorch's fused
    attention on CUDA tensors (the JAX package's stock flash kernel there
    is not its own kernel), the f32 softmax oracle on CPU tensors. Its
    callers are the KV-compressed attention and the fake-quant fallback
    (`fake_quant_attention`)."""
    if not q.is_cuda:
        return sdpa_xla(q, k, v, scale, kv_mask)
    mask = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          scale=scale)


class DepthwiseQuantConv(nn.Module):
    """Depthwise conv with kernel = stride = ratio, the PixArt-Σ KV-compress
    `sr` layer (layers.py:239-277). `kernel` keeps the JAX layout
    [r, r, 1, C]; the conv is a reshape and a per-channel weighted sum of
    each r x r patch in f32. Under a plan it always runs simulate
    semantics, whatever the backend: min-max fake quant of the kernel per
    its weight spec and dynamic fake quant of the input per its act spec."""

    def __init__(self, dim: int, ratio: int,
                 lspec: Optional[LayerQuantSpec] = None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.ratio = ratio
        self.lspec = lspec
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.full((ratio, ratio, 1, dim),
                                              1.0 / ratio ** 2))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, qctx: Optional[QuantCtx] = None):
        """x [B, H, W, C] -> [B, H/r, W/r, C]."""
        r = self.ratio
        w = self.kernel
        spec = self.lspec
        if spec is not None and qctx is not None and qctx.mode == "quant":
            if spec.weight is not None and spec.weight_quant:
                w2 = w.reshape(-1, w.shape[-1])
                d, z = qcore.compute_qparams(w2, spec.weight)
                w = qcore.fake_quant(w2, d, z, spec.weight).reshape(w.shape)
            if spec.act is not None and spec.act_quant:
                x = qcore.fake_quant_dynamic(x, spec.act)
        B, H, W, C = x.shape
        xg = x.to(self.dtype).float().reshape(B, H // r, r, W // r, r, C)
        wg = w.to(self.dtype).float().reshape(1, 1, r, 1, r, C)
        out = (xg * wg).sum(dim=(2, 4)).to(self.dtype)
        return out + self.bias.to(self.dtype)


def nearest_index(m: int, n: int, device=None) -> torch.Tensor:
    """The source indices `jax.image.resize(..., "nearest")` keeps when it
    shrinks an axis of m entries to n: floor((i + 1/2) * m / n) in float32
    (half-pixel centres; jax/_src/image/scale.py `_resize_nearest`). At
    m = r * n that is r * i + r // 2: rows 1, 3, 5, 7 of 8 at r = 2."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * m / n).long()


class KVCompressSelfAttention(nn.Module):
    """PixArt-Σ self-attention with KV compression (layers.py:579-653):
    q/k/v/proj linears (each quantizes its own input under a fused plan:
    K5), optionally q and k through an affine LayerNorm over all C channels
    (`qk_norm`, layers.py:628-630), k and v downsampled, and `sdpa` over N
    queries and the kept keys. Samplings (layers.py:588-608): 'conv' (the
    released Σ config: the shared depthwise `sr` conv, then the affine
    `norm`), 'uniform' (every r-th row and column of the token grid),
    'uniform_every' (every r-th token of the flat sequence) and 'ave',
    which despite its name is `jax.image.resize(..., "nearest")` of the
    grid to (H/r, W/r): no average (`nearest_index`)."""

    SAMPLINGS = ("conv", "uniform", "uniform_every", "ave")

    def __init__(self, dim: int, num_heads: int, sampling: Optional[str],
                 sr_ratio: int, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16,
                 qk_norm: bool = False):
        super().__init__()
        if sr_ratio > 1 and sampling not in self.SAMPLINGS:
            raise ValueError(sampling)
        self.num_heads = num_heads
        self.sampling = sampling
        self.sr_ratio = sr_ratio
        self.qk_norm = qk_norm
        self.q, self.k, self.v, self.proj = (
            QuantLinear(dim, dim, resolver(f"{prefix}.{n}"), dtype=dtype)
            for n in ("q", "k", "v", "proj"))
        if qk_norm:
            self.q_norm = AffineLayerNorm(dim, dtype=dtype)
            self.k_norm = AffineLayerNorm(dim, dtype=dtype)
        if sr_ratio > 1 and sampling == "conv":
            self.sr = DepthwiseQuantConv(dim, sr_ratio,
                                         resolver(f"{prefix}.sr"), dtype)
            self.norm = AffineLayerNorm(dim, dtype=dtype)

    def _downsample(self, t, H, W, qctx):
        B, N, C = t.shape
        r = self.sr_ratio
        if self.sampling is None or r == 1:
            return t
        if self.sampling == "uniform_every":
            return t[:, ::r]
        grid = t.reshape(B, H, W, C)
        if self.sampling == "uniform":
            grid = grid[:, ::r, ::r]
        elif self.sampling == "ave":
            grid = grid[:, nearest_index(H, H // r, t.device)][
                :, :, nearest_index(W, W // r, t.device)]
        else:
            grid = self.norm(self.sr(grid, qctx))
        return grid.reshape(B, -1, C)

    def forward(self, x, qctx: Optional[QuantCtx] = None, HW=None):
        B, N, C = x.shape
        H, D = self.num_heads, C // self.num_heads
        h, w = HW if HW is not None else (math.isqrt(N),) * 2
        q = self.q(x, qctx)
        k = self.k(x, qctx)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        k = self._downsample(k, h, w, qctx)
        v = self._downsample(self.v(x, qctx), h, w, qctx)
        M = k.shape[1]
        out = sdpa(q.reshape(B, N, H, D).transpose(1, 2),
                   k.reshape(B, M, H, D).transpose(1, 2),
                   v.reshape(B, M, H, D).transpose(1, 2), scale=D ** -0.5)
        out = out.transpose(1, 2).reshape(B, N, C)
        return self.proj(out, qctx)


class CrossAttention(nn.Module):
    """Multi-head cross-attention to 0-masked prompt tokens
    (layers.py:656-740, the layout-native branch). Under tensor
    parallelism `num_heads` is this rank's share, and `kv_linear` holds
    the same heads of k and of v (`parallel.mesh.shard_params`)."""

    def __init__(self, dim: int, num_heads: int, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qspec = resolver(f"{prefix}.q_linear")
        self.pspec = resolver(f"{prefix}.proj")
        self.q_linear = QuantLinear(dim, dim, self.qspec, dtype=dtype)
        # the CB statistic on the reference's packed [1, B*P, C] prompts;
        # token-wise acts on the 'cross_kv' view
        self.kv_linear = QuantLinear(dim, 2 * dim,
                                     resolver(f"{prefix}.kv_linear"),
                                     dtype=dtype, stat_layout="packed_prompt",
                                     token_layout="cross_kv")
        self.proj = QuantLinear(dim, dim, self.pspec, dtype=dtype)

    def forward(self, x, cond, mask=None, qctx: Optional[QuantCtx] = None,
                epilogue=None):
        """`epilogue`: (residual, gate | None) for the proj, as
        `SelfAttention`'s."""
        B, N, _ = x.shape
        P = cond.shape[-2]
        H, D = self.num_heads, self.head_dim
        C = H * D
        q = self.q_linear(x, qctx)
        kv = self.kv_linear(cond, qctx)
        k, v = torch.split(kv, C, dim=-1)
        kv_mask = (mask.to(torch.int32) if mask is not None
                   else torch.ones((B, P), dtype=torch.int32,
                                   device=x.device))
        flags = _exec_flags(self.qspec, qctx)
        if flags is None:
            out = fake_quant_attention(
                q.reshape(B, N, H, D).transpose(1, 2),
                k.reshape(B, P, H, D).transpose(1, 2),
                v.reshape(B, P, H, D).transpose(1, 2), self.qspec,
                D ** -0.5, kv_mask=kv_mask)
            return self.proj(out.transpose(1, 2).reshape(B, N, C), qctx,
                             epilogue=epilogue)
        int8_qk, int8_pv = flags
        args = (q.reshape(B, N, H, D), k.reshape(B, P, H, D),
                v.reshape(B, P, H, D))
        ics_p = self.proj.inv_balance(qctx)
        if attn_emit_int8_ok(self.pspec, qctx, ics_p is not None):
            out = self.proj(None, qctx, prequant=emitted_prequant(
                attention_bnhd(
                    *args, scale=D ** -0.5, kv_mask=kv_mask, int8_qk=int8_qk,
                    int8_pv=int8_pv, emit=True, emit_sym=self.pspec.act.sym,
                    need_rowsum=not self.pspec.weight.sym,
                    col_scale=ics_p), C), epilogue=epilogue)
            return out.reshape(B, N, C)
        out = attention_bnhd(*args, scale=D ** -0.5, kv_mask=kv_mask,
                             int8_qk=int8_qk, int8_pv=int8_pv)
        return self.proj(out.reshape(B, N, C), qctx, epilogue=epilogue)


def call_block(block: nn.Module, grad_checkpoint: bool, *args):
    """block(*args); with grad_checkpoint and autograd recording, its
    activations are not kept but recomputed in the backward pass from its
    inputs (the JAX models' `nn.remat` of each block)."""
    if grad_checkpoint and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


def float32_copy(module: nn.Module) -> nn.Module:
    """A copy of module (parameters and tables) whose every layer computes
    in float32: the float32 block of AdaRound reconstruction (JAX
    `_standalone_block` builds the block with dtype=float32,
    reconstruction.py:431-461). The copy's parameters need no gradient."""
    import copy
    out = copy.deepcopy(module)
    for m in out.modules():
        if getattr(m, "dtype", None) is not None:
            m.dtype = torch.float32
    out.requires_grad_(False)
    return out


# ---------------- embedders ----------------

def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000
                       ) -> torch.Tensor:
    """Sinusoidal embedding, cos-first (blocks.py:419-437)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    """blocks.py:405-444 (fp: remain_fp.txt lists t_embedder)."""

    def __init__(self, hidden_size: int, freq_size: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        self.freq_size = freq_size
        self.dtype = dtype
        self.fc1 = QuantLinear(freq_size, hidden_size, dtype=dtype,
                               kernel_init="lecun_normal")
        self.fc2 = QuantLinear(hidden_size, hidden_size, dtype=dtype,
                               kernel_init="lecun_normal")

    def forward(self, t):
        emb = timestep_embedding(t, self.freq_size).to(self.dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class TBlock(nn.Module):
    """SiLU -> Linear(6*hidden) adaLN-single table head (stdit.py:189)."""

    def __init__(self, hidden_size: int, dtype=torch.bfloat16):
        super().__init__()
        self.linear = QuantLinear(hidden_size, 6 * hidden_size, dtype=dtype,
                                  kernel_init="lecun_normal")

    def forward(self, t):
        return self.linear(F.silu(t))


class SizeEmbedder(TimestepEmbedder):
    """blocks.py:477-508 (layers.py:820-838), PixArt-Σ's micro-condition:
    s [B, d] (or [B], or one row for the batch) tiled to bs rows, each
    scalar embedded as a timestep is (fc1 -> SiLU -> fc2, fp), the d
    embeddings concatenated: [bs, d * hidden_size]."""

    def forward(self, s, bs: int):
        if s.dim() == 1:
            s = s[:, None]
        if s.shape[0] != bs:
            s = s.repeat(bs // s.shape[0], 1)
        return super().forward(s.reshape(-1)).reshape(s.shape[0], -1)


class CaptionEmbedder(nn.Module):
    """blocks.py:511-542; `y_embedding` is the learned null prompt."""

    def __init__(self, in_channels: int, hidden_size: int,
                 token_num: int = 120, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.y_embedding = nn.Parameter(torch.zeros(token_num, in_channels))
        self.fc1 = QuantLinear(in_channels, hidden_size, dtype=dtype,
                               kernel_init="lecun_normal")
        self.fc2 = QuantLinear(hidden_size, hidden_size, dtype=dtype,
                               kernel_init="lecun_normal")

    def forward(self, caption):
        return self.fc2(approx_gelu(self.fc1(caption.to(self.dtype))))


class LabelEmbedder(nn.Module):
    """Class-label embedding with the CFG null slot (blocks.py:447-474,
    layers.py:866-878): a float32 table of num_classes + 1 rows, row
    num_classes the null label, cast to the model dtype."""

    def __init__(self, num_classes: int, hidden_size: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(num_classes + 1,
                                                  hidden_size))

    def forward(self, labels):
        return self.embedding[labels.long()].to(self.dtype)


class PatchEmbed(nn.Module):
    """2D patchify conv (layers.py:881-913) lowered like PatchEmbed3D: each
    p x p patch is one row of p*p*C_in values in the conv kernel's
    (ph, pw, C_in) flatten order. `proj.kernel`: [p*p*C_in, embed_dim]."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 resolver: Resolver = no_quant, prefix: str = "x_embedder",
                 dtype=torch.bfloat16):
        super().__init__()
        self.patch_size = patch_size
        self.proj = QuantLinear(patch_size * patch_size * in_channels,
                                embed_dim, resolver(f"{prefix}.proj"),
                                dtype=dtype, kernel_init="lecun_normal")

    def forward(self, x, qctx: Optional[QuantCtx] = None):
        # x: [B, C, H, W] -> [B, h*w, D]
        B, C, Hh, W = x.shape
        p = self.patch_size
        x = x.reshape(B, C, Hh // p, p, W // p, p)
        x = x.permute(0, 2, 4, 3, 5, 1).reshape(
            B, (Hh // p) * (W // p), p * p * C)
        return self.proj(x, qctx)


class PatchEmbed3D(nn.Module):
    """3D patchify conv (blocks.py:60-110) as a reshape plus a linear layer:
    the stride equals the kernel, so each patch is one row of
    pt*ph*pw*C_in values in the conv kernel's (*k, C_in) flatten order — the
    JAX package's QuantConv lowering (qlinear.py:895-910). `proj.kernel`:
    [pt*ph*pw*C_in, embed_dim]."""

    def __init__(self, patch_size, in_channels: int, embed_dim: int,
                 resolver: Resolver = no_quant, prefix: str = "x_embedder",
                 dtype=torch.bfloat16):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = QuantLinear(int(np.prod(patch_size)) * in_channels,
                                embed_dim, resolver(f"{prefix}.proj"),
                                dtype=dtype, kernel_init="lecun_normal")

    def forward(self, x, qctx: Optional[QuantCtx] = None):
        # x: [B, C, T, H, W] -> [B, t*h*w, D]
        B, C, T, Hh, W = x.shape
        pt, ph, pw = self.patch_size
        x = x.reshape(B, C, T // pt, pt, Hh // ph, ph, W // pw, pw)
        x = x.permute(0, 2, 4, 6, 3, 5, 7, 1).reshape(
            B, (T // pt) * (Hh // ph) * (W // pw), pt * ph * pw * C)
        return self.proj(x, qctx)


class T2IFinalLayer(nn.Module):
    """blocks.py:381-397 (scale_shift_table variant)."""

    def __init__(self, hidden_size: int, num_patch: int, out_channels: int,
                 resolver: Resolver = no_quant, prefix: str = "final_layer",
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.scale_shift_table = nn.Parameter(torch.zeros(2, hidden_size))
        self.linear = QuantLinear(hidden_size, num_patch * out_channels,
                                  resolver(f"{prefix}.linear"), dtype=dtype)

    def forward(self, x, t, qctx: Optional[QuantCtx] = None):
        mods = (self.scale_shift_table[None].to(self.dtype)
                + t[:, None].to(self.dtype))
        shift, scale = mods[:, 0:1], mods[:, 1:2]
        x = t2i_modulate(layer_norm(x, self.dtype), shift, scale)
        return self.linear(x, qctx)


class FinalLayer(nn.Module):
    """DiT's final layer with its own adaLN head (blocks.py:363-378,
    layers.py:976-991): shift and scale from `adaLN_linear` on SiLU(c),
    modulate the non-affine LN of x, then `linear`; both fp."""

    def __init__(self, hidden_size: int, num_patch: int, out_channels: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.adaLN_linear = QuantLinear(hidden_size, 2 * hidden_size,
                                        dtype=dtype,
                                        kernel_init="lecun_normal")
        self.linear = QuantLinear(hidden_size, num_patch * out_channels,
                                  dtype=dtype, kernel_init="lecun_normal")

    def forward(self, x, c):
        shift, scale = torch.chunk(self.adaLN_linear(F.silu(c)), 2, dim=-1)
        return self.linear(modulate(layer_norm(x, self.dtype), shift, scale))


# ---------------- sincos position embeddings (numpy, static) ----------------

def get_1d_sincos_pos_embed(embed_dim, length, scale=1.0):
    pos = np.arange(0, length)[..., None] / scale
    return _sincos_from_grid(embed_dim, pos)


def _sincos_from_grid(embed_dim, pos):
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim, grid_size, scale=1.0, base_size=None):
    """blocks.py:551-583 — note w-first meshgrid."""
    if not isinstance(grid_size, tuple):
        grid_size = (grid_size, grid_size)
    grid_h = np.arange(grid_size[0], dtype=np.float32) / scale
    grid_w = np.arange(grid_size[1], dtype=np.float32) / scale
    if base_size is not None:
        grid_h *= base_size / grid_size[0]
        grid_w *= base_size / grid_size[1]
    grid = np.meshgrid(grid_w, grid_h)
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size[1], grid_size[0]])
    emb_h = _sincos_from_grid(embed_dim // 2, grid[0])
    emb_w = _sincos_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)
