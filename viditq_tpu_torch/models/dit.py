"""DiT (class- or text-conditional) and Latte (alternating spatial and
temporal blocks) video backbones: port of `viditq_tpu/models/dit.py`.

`DiTBlock` is adaLN-Zero: each block has its own `adaLN_linear` head on
SiLU(c) for its six modulation vectors, where STDiT and PixArt add a
per-block table to a shared head. The block hands its attention and MLP
their modulated inputs in the model dtype, with no producer prequant and
no residual epilogue, as the JAX block does: under a fused plan q/k/v
share one K4 pass, and fc2 takes K4's GELU handoff. The block stack is
unrolled (`blocks.{i}`, each with `adaLN_linear`), so plans resolve per
block and the JAX package's trees load through `utils/bridge.py`.
`grad_checkpoint` recomputes each block in the backward pass (dit.py:139,
:177).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from viditq_tpu_torch.models.layers import (
    CaptionEmbedder, FinalLayer, LabelEmbedder, Mlp, PatchEmbed3D, Resolver,
    SelfAttention, TimestepEmbedder, call_block, get_1d_sincos_pos_embed,
    get_2d_sincos_pos_embed, layer_norm, modulate, no_quant)
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear


class DiTBlock(nn.Module):
    """dit.py:24-56: x + gate_msa * attn(modulate(LN(x))), then the MLP
    the same way. token_layout / d_t / d_s: the token view of the block's
    linears ('spatial' or 'temporal' in Latte)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16,
                 token_layout: Optional[str] = None, d_t: int = 1,
                 d_s: int = 1):
        super().__init__()
        C = hidden_size
        self.dtype = dtype
        self.adaLN_linear = QuantLinear(C, 6 * C, dtype=dtype,
                                        kernel_init="lecun_normal")
        kw = dict(token_layout=token_layout, d_t=d_t, d_s=d_s)
        self.attn = SelfAttention(C, num_heads, resolver, f"{prefix}.attn",
                                  dtype, **kw)
        self.mlp = Mlp(C, int(C * mlp_ratio), resolver, f"{prefix}.mlp",
                       dtype, **kw)

    def forward(self, x, c, qctx: Optional[QuantCtx] = None):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = torch.chunk(self.adaLN_linear(F.silu(c)), 6, dim=-1)
        x = x + gate_msa[:, None] * self.attn(
            modulate(layer_norm(x, self.dtype), shift_msa, scale_msa), qctx)
        return x + gate_mlp[:, None] * self.mlp(
            modulate(layer_norm(x, self.dtype), shift_mlp, scale_mlp),
            qctx).reshape(x.shape)


class DiT(nn.Module):
    """dit.py:59-156. input_size is the latent [T, H, W]; condition
    'text' (a caption's first token through `CaptionEmbedder` with one
    token, cut to C) or 'label_<num_classes>' (`LabelEmbedder`; y the
    int labels, the null label num_classes)."""

    def __init__(self, input_size: Tuple[int, int, int] = (16, 32, 32),
                 in_channels: int = 4,
                 patch_size: Tuple[int, int, int] = (1, 2, 2),
                 hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 learn_sigma: bool = True, condition: str = "text",
                 no_temporal_pos_emb: bool = False,
                 caption_channels: int = 512, model_max_length: int = 77,
                 resolver: Resolver = no_quant, dtype=torch.bfloat16,
                 grad_checkpoint: bool = False):
        super().__init__()
        self.grad_checkpoint = grad_checkpoint
        self.input_size = tuple(input_size)
        self.patch_size = tuple(patch_size)
        self.hidden_size = hidden_size
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.condition = condition
        self.no_temporal_pos_emb = no_temporal_pos_emb
        self.dtype = dtype
        self.num_temporal = input_size[0] // patch_size[0]
        self.num_spatial = ((input_size[1] // patch_size[1])
                            * (input_size[2] // patch_size[2]))
        C = hidden_size
        # static sincos tables (numpy f64 -> f32): a square grid of the
        # latent's height, as dit.py:108-110
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(C, input_size[1] // patch_size[1])[None]
        ).float(), persistent=False)
        self.register_buffer("pos_embed_temporal", torch.from_numpy(
            get_1d_sincos_pos_embed(C, self.num_temporal)[None]).float(),
            persistent=False)
        self.x_embedder = PatchEmbed3D(patch_size, in_channels, C, resolver,
                                       dtype=dtype)
        self.t_embedder = TimestepEmbedder(C, dtype=dtype)
        if self.use_text_encoder:
            self.y_embedder = CaptionEmbedder(caption_channels, C, 1, dtype)
        else:
            self.y_embedder = LabelEmbedder(
                int(condition.split("_")[-1]), C, dtype)
        self.blocks = nn.ModuleList(self._blocks(depth, num_heads, mlp_ratio,
                                                 resolver))
        self.final_layer = FinalLayer(C, int(np.prod(patch_size)),
                                      self.out_channels, dtype)

    def _blocks(self, depth, num_heads, mlp_ratio, resolver):
        return [DiTBlock(self.hidden_size, num_heads, mlp_ratio, resolver,
                         f"blocks.{i}", self.dtype) for i in range(depth)]

    @property
    def use_text_encoder(self) -> bool:
        return not self.condition.startswith("label")

    def _embed_condition(self, t_emb, y):
        if self.use_text_encoder:
            y_emb = self.y_embedder(y.to(self.dtype))
            y_emb = y_emb.reshape(y_emb.shape[0], -1)[:, :self.hidden_size]
        else:
            y_emb = self.y_embedder(y)
        return t_emb + y_emb

    def _embed_x(self, x, qctx):
        B = x.shape[0]
        T, S, C = self.num_temporal, self.num_spatial, self.hidden_size
        x = self.x_embedder(x.to(self.dtype), qctx).reshape(B, T, S, C)
        return x + self.pos_embed.to(self.dtype)

    def forward(self, x, timestep, y, mask=None,
                qctx: Optional[QuantCtx] = None):
        """x: [B, C, T, H, W]; timestep: [B]; y: [B, 1, L, C_cap] (text) or
        [B] int labels; mask is not read. Returns [B, C_out, T, H, W]
        float32."""
        B = x.shape[0]
        T, S, C = self.num_temporal, self.num_spatial, self.hidden_size
        x = self._embed_x(x, qctx)
        if not self.no_temporal_pos_emb:
            x = (x.transpose(1, 2) + self.pos_embed_temporal.to(self.dtype)
                 ).transpose(1, 2)
        x = x.reshape(B, T * S, C)
        cond = self._embed_condition(self.t_embedder(timestep), y)
        for block in self.blocks:
            x = call_block(block, self.grad_checkpoint, x, cond, qctx)
        return self.unpatchify(self.final_layer(x, cond)).float()

    def unpatchify(self, x):
        """dit.py:172-180: n t h w r p q c -> n c (t r) (h p) (w q)."""
        t = self.input_size[0] // self.patch_size[0]
        h = self.input_size[1] // self.patch_size[1]
        w = self.input_size[2] // self.patch_size[2]
        pt, ph, pw = self.patch_size
        c = self.out_channels
        x = x.reshape(x.shape[0], t, h, w, pt, ph, pw, c)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(x.shape[0], c, t * pt, h * ph, w * pw)


class Latte(DiT):
    """dit.py:159-200: DiT's parameters; even blocks attend over the S
    tokens of a frame ([(B T), S, C], token view 'spatial'), odd blocks
    over the T frames of a token position ([(B S), T, C], 'temporal'),
    each block's modulation from the condition repeated per frame or per
    position; the temporal position table is added at block 1 only."""

    def _blocks(self, depth, num_heads, mlp_ratio, resolver):
        return [DiTBlock(self.hidden_size, num_heads, mlp_ratio, resolver,
                         f"blocks.{i}", self.dtype,
                         token_layout="spatial" if i % 2 == 0
                         else "temporal", d_t=self.num_temporal,
                         d_s=self.num_spatial) for i in range(depth)]

    def forward(self, x, timestep, y, mask=None,
                qctx: Optional[QuantCtx] = None):
        B = x.shape[0]
        T, S, C = self.num_temporal, self.num_spatial, self.hidden_size
        x = self._embed_x(x, qctx).reshape(B, T * S, C)
        cond = self._embed_condition(self.t_embedder(timestep), y)
        cond_s = cond.repeat_interleave(T, dim=0)  # (b t) d
        cond_t = cond.repeat_interleave(S, dim=0)  # (b s) d
        for i, block in enumerate(self.blocks):
            if i % 2 == 0:
                x = call_block(block, self.grad_checkpoint,
                               x.reshape(B * T, S, C), cond_s, qctx)
                continue
            xb = x.reshape(B, T, S, C).transpose(1, 2).reshape(B * S, T, C)
            if i == 1:
                xb = xb + self.pos_embed_temporal.to(self.dtype)
            xb = call_block(block, self.grad_checkpoint, xb, cond_t, qctx)
            x = xb.reshape(B, S, T, C).transpose(1, 2)
        x = x.reshape(B, T * S, C)
        return self.unpatchify(self.final_layer(x, cond)).float()


def DiT_XL_2(**kwargs) -> DiT:
    return DiT(depth=28, hidden_size=1152, patch_size=(1, 2, 2),
               num_heads=16, **kwargs)


def Latte_XL_2(**kwargs) -> Latte:
    return Latte(depth=28, hidden_size=1152, patch_size=(1, 2, 2),
                 num_heads=16, **kwargs)
