"""PixArt-α / PixArt-Σ backbones: port of `viditq_tpu/models/pixart.py`.

PixArt-Σ (PixArtMS) is PixArt with KV compression on a set of blocks: those
blocks' self-attention downsamples k and v on the token grid
(`KVCompressSelfAttention`); the others keep the layout-native
`SelfAttention`, which at 1024x1024 (N = M = 4096 tokens) streams its kv
through K6. The block stack is unrolled (`blocks.{i}`), so plans resolve
per block; weights from the JAX package's unrolled, single-scan or
multi-run scanned layouts load through `viditq_tpu_torch.utils.bridge`.
Capture mode reads each block's input, output and shared context from the
block's own call (`quant/reconstruction.py`, where the JAX package sows,
pixart.py:42-43, :87-88, :199-201), and `standalone_block` is block i alone
in float32 for reconstruction. PixArtMS's options are ported: the
micro-condition (`micro_condition`: the `csize_embedder` and `ar_embedder`
of `data_info`'s image size and aspect ratio added to the timestep
embedding), `qk_norm` and every KV-compress sampling. `grad_checkpoint`
recomputes each block in the backward pass (pixart.py:212-245).
`forward(..., stage="embed" | "final")` splits the forward around the
block stack for the pipeline (`parallel/pipeline.py`), as STDiT's does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from viditq_tpu_torch.models.layers import (
    CaptionEmbedder, CrossAttention, KVCompressSelfAttention, Mlp, PatchEmbed,
    Resolver, SelfAttention, SizeEmbedder, T2IFinalLayer, TBlock,
    TimestepEmbedder, call_block, float32_copy, get_2d_sincos_pos_embed,
    layer_norm, ln_mod_prequant, no_quant, t2i_modulate)
from viditq_tpu_torch.quant.qlinear import QuantCtx


class PixArtBlock(nn.Module):
    """pixart.py:25-92: self attn -> cross attn -> MLP, adaLN-single."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, sampling: Optional[str] = None,
                 sr_ratio: int = 1, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16,
                 qk_norm: bool = False):
        super().__init__()
        C = hidden_size
        self.dtype = dtype
        self.resolver = resolver
        self.prefix = prefix
        self.kv_compress = sr_ratio > 1 or sampling is not None
        self.scale_shift_table = nn.Parameter(torch.zeros(6, C))
        if self.kv_compress:
            self.attn = KVCompressSelfAttention(
                C, num_heads, sampling, sr_ratio, resolver,
                f"{prefix}.attn", dtype, qk_norm=qk_norm)
        else:
            self.attn = SelfAttention(C, num_heads, resolver,
                                      f"{prefix}.attn", dtype,
                                      qk_norm=qk_norm)
        self.cross_attn = CrossAttention(C, num_heads, resolver,
                                         f"{prefix}.cross_attn", dtype)
        self.mlp = Mlp(C, int(C * mlp_ratio), resolver, f"{prefix}.mlp",
                       dtype)

    def forward(self, x, y, t0, mask=None, HW=None,
                qctx: Optional[QuantCtx] = None):
        B, N, C = x.shape
        mods = (self.scale_shift_table[None].to(self.dtype)
                + t0.reshape(B, 6, -1).to(self.dtype))
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = torch.split(mods, 1, dim=1)
        if self.kv_compress:
            # k/v consume the downsampled stream, so the attention
            # quantizes its own inputs (no shared producer)
            x_m = t2i_modulate(layer_norm(x, self.dtype), shift_msa,
                               scale_msa)
            attn_out = self.attn(x_m, qctx, HW=HW)
        else:
            pre = ln_mod_prequant(self.resolver, self.prefix, x, shift_msa,
                                  scale_msa, ("attn.q", "attn.k", "attn.v"),
                                  qctx, self.attn.q)
            x_m = None
            if pre is None:
                x_m = t2i_modulate(layer_norm(x, self.dtype), shift_msa,
                                   scale_msa)
            attn_out = self.attn(x_m, qctx, prequant=pre, shape=(B, N, C))
        x = x + gate_msa * attn_out.reshape(B, N, C)
        x = x + self.cross_attn(x, y, mask, qctx)
        pre_mlp = ln_mod_prequant(self.resolver, self.prefix, x, shift_mlp,
                                  scale_mlp, ("mlp.fc1",), qctx,
                                  self.mlp.fc1)
        x_in = None
        if pre_mlp is None:
            x_in = t2i_modulate(layer_norm(x, self.dtype), shift_mlp,
                                scale_mlp)
        h = self.mlp(x_in, qctx, prequant=pre_mlp)
        return x + gate_mlp * h.reshape(B, N, C)


class PixArt(nn.Module):
    """pixart.py:95-270. `input_size` is the latent's spatial size
    (image_size // 8); blocks listed in `kv_compress_layers` compress k/v
    by `kv_compress_scale` with `kv_compress_sampling`; `qk_norm`
    normalises every self-attention's q and k; `micro_condition` adds the
    embeddings of `data_info` to the timestep's (pixart.py:154-160)."""

    def __init__(self, input_size: int = 64, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152,
                 depth: int = 28, num_heads: int = 16,
                 mlp_ratio: float = 4.0, pred_sigma: bool = True,
                 caption_channels: int = 4096, model_max_length: int = 120,
                 pe_interpolation: float = 1.0, qk_norm: bool = False,
                 micro_condition: bool = False,
                 kv_compress_sampling: Optional[str] = None,
                 kv_compress_scale: int = 1,
                 kv_compress_layers: Sequence[int] = (),
                 resolver: Resolver = no_quant, dtype=torch.bfloat16,
                 grad_checkpoint: bool = False):
        super().__init__()
        self.grad_checkpoint = grad_checkpoint
        self.depth = depth
        self.kv_compress_scale = kv_compress_scale
        self.kv_compress_layers = tuple(kv_compress_layers)
        self.micro_condition = micro_condition
        self.input_size = input_size
        self.patch_size = patch_size
        self.hidden_size = hidden_size
        self.out_channels = in_channels * 2 if pred_sigma else in_channels
        self.dtype = dtype
        C = hidden_size
        # static sincos table of the input_size grid (numpy f64 -> f32)
        grid = input_size // patch_size
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(C, (grid, grid), scale=pe_interpolation,
                                    base_size=grid)[None]).float(),
            persistent=False)
        self.x_embedder = PatchEmbed(patch_size, in_channels, C, resolver,
                                     dtype=dtype)
        self.t_embedder = TimestepEmbedder(C, dtype=dtype)
        if micro_condition:
            self.csize_embedder = SizeEmbedder(C // 3, dtype=dtype)
            self.ar_embedder = SizeEmbedder(C // 3, dtype=dtype)
        self.t_block = TBlock(C, dtype)
        self.y_embedder = CaptionEmbedder(caption_channels, C,
                                          model_max_length, dtype)
        blocks = []
        for i in range(depth):
            sr = kv_compress_scale if i in kv_compress_layers else 1
            blocks.append(PixArtBlock(
                C, num_heads, mlp_ratio,
                sampling=kv_compress_sampling if sr > 1 else None,
                sr_ratio=sr, resolver=resolver, prefix=f"blocks.{i}",
                dtype=dtype, qk_norm=qk_norm))
        self.blocks = nn.ModuleList(blocks)
        self.final_layer = T2IFinalLayer(C, patch_size ** 2,
                                         self.out_channels, resolver,
                                         dtype=dtype)

    def forward(self, x, timestep, y, mask=None,
                qctx: Optional[QuantCtx] = None, data_info=None,
                stage: str = "all", x_tokens=None):
        """x: [B, C, H, W] at the input_size grid; timestep: [B]; y:
        [B, 1, L, C_cap] or [B, L, C_cap]; mask: [B, L] or the CFG-doubled
        [2B, L]; data_info (micro_condition): {"img_hw": [B or 1, 2],
        "aspect_ratio": [B or 1, 1]}, as the JAX model's (a keyword here:
        the samplers pass qctx fifth). Returns [B, C_out, H, W] float32.
        stage 'embed': (x_tokens, t0, y, mask, (h, w)), the block stack's
        inputs; 'final': the head on the stack's output x_tokens (y and
        mask unused) (pixart.py:139-164, :197)."""
        B = x.shape[0]
        C = self.hidden_size
        h = x.shape[-2] // self.patch_size
        w = x.shape[-1] // self.patch_size
        if stage not in ("all", "embed", "final"):
            raise ValueError(f"unknown stage {stage!r}")
        t = self.t_embedder(timestep)
        if self.micro_condition:
            if data_info is None:
                raise ValueError("micro_condition needs data_info")
            size, ar = (torch.as_tensor(data_info[k], device=x.device)
                        for k in ("img_hw", "aspect_ratio"))
            t = t + torch.cat([self.csize_embedder(size, B),
                               self.ar_embedder(ar, B)], dim=1)
        if stage == "final":
            return unpatchify(self.final_layer(x_tokens, t, qctx), h, w,
                              self.patch_size, self.out_channels).float()
        x = (self.x_embedder(x.to(self.dtype), qctx)
             + self.pos_embed.to(self.dtype))
        t0 = self.t_block(t)
        y = self.y_embedder(y.to(self.dtype))
        if y.dim() == 4:
            y = y.reshape(B, -1, C)
        if mask is not None:
            if mask.shape[0] > B:
                mask = mask[:B]
            elif mask.shape[0] != B:
                mask = mask.repeat(B // mask.shape[0], 1)
            y = y * mask[..., None].to(y.dtype)
        if stage == "embed":
            return x, t0, y, mask, (h, w)
        for block in self.blocks:
            x = call_block(block, self.grad_checkpoint, x, y, t0, mask,
                           (h, w), qctx)
        x = self.final_layer(x, t, qctx)
        return unpatchify(x, h, w, self.patch_size,
                          self.out_channels).float()

    def standalone_block(self, i: int):
        """(block i computing in float32 on a copy of its parameters and
        tables, its extra argument: the token grid (h, w) of the model's
        input size) (JAX `_standalone_block`, reconstruction.py:451-461).
        Call it as block(x, y, t0, mask, extra, qctx)."""
        grid = self.input_size // self.patch_size
        return float32_copy(self.blocks[i]), (grid, grid)


def unpatchify(x, h: int, w: int, p: int, c: int):
    """pixart.py:256-262: [B, h*w, p*p*c] -> [B, c, h*p, w*p]."""
    B = x.shape[0]
    x = x.reshape(B, h, w, p, p, c)
    x = torch.einsum("nhwpqc->nchpwq", x)
    return x.reshape(B, c, h * p, w * p)


def PixArt_XL_2(**kwargs) -> PixArt:
    return PixArt(depth=28, hidden_size=1152, patch_size=2, num_heads=16,
                  **kwargs)


def PixArtMS_XL_2(**kwargs) -> PixArt:
    """Σ-style multi-scale variant (pixart.py:273-280)."""
    kwargs.setdefault("micro_condition", False)
    return PixArt(depth=28, hidden_size=1152, patch_size=2, num_heads=16,
                  **kwargs)
