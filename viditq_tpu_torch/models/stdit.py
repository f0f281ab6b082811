"""STDiT (OpenSora v1.0 spatial-temporal DiT): port of
`viditq_tpu/models/stdit.py`.

The block stack is unrolled as an `nn.ModuleList`, so module names are the
reference's dotted layer names (`blocks.3.attn.q`) and plans resolve per
block. Weights from the JAX package's scanned or unrolled layouts load
through `viditq_tpu_torch.utils.bridge`. `fuse_epilogue` (off by default,
as in the JAX package) sends the block's residual adds of the spatial
attention, the cross attention and the MLP into the epilogue of their
output linear (K2 or K5 under a fused plan): the JAX package's
`VIDITQ_FUSE_EPILOGUE` switch, here a model argument. Capture mode
(`QuantCtx.capture`, for reconstruction) reads each block's input, its
output and its shared context (y, t0) from the block's own call
(`quant/reconstruction.py` hooks each `STDiTBlock`, where the JAX package
sows `block_in`, `block_out`, `block_ctx_y` and `block_ctx_t0`, stdit.py:
48-51, :153-154, :262-265); `standalone_block` is block i alone in float32
for reconstruction's gradients. `grad_checkpoint` recomputes each block
in the backward pass (stdit.py:273-290, `models/layers.call_block`).

Sequence parallelism (stdit.py:42-43, :104-126): `sp_mesh`, a
`parallel.mesh.Mesh`, and `sp_mode` reach every block's self-attentions
(`layers.SelfAttention`), the K1 producers stand aside
(`layers.ln_mod_prequant`), and the temporal branch leaves the packed
segment form: its attention runs on [(B S), T, C] with
`token_layout="temporal"`, which is also the token view of its linears'
act statistic and per-token quantization (stdit.py:117-126). The stages
(stdit.py:212-233, :261-262): `forward(..., stage="embed")` stops before
the block stack and returns (x_tokens, t0, y, mask, tpe); `stage="final"`
takes the stack's output as `x_tokens` and runs the head; the pipeline
(`parallel/pipeline.py`) runs the blocks between.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.models.layers import (
    CaptionEmbedder, CrossAttention, Mlp, PatchEmbed3D, Resolver,
    SelfAttention, T2IFinalLayer, TBlock, TimestepEmbedder, call_block,
    float32_copy, get_1d_sincos_pos_embed, get_2d_sincos_pos_embed,
    layer_norm, ln_mod_prequant, no_quant, t2i_modulate)
from viditq_tpu_torch.quant.qlinear import QuantCtx


class STDiTBlock(nn.Module):
    """stdit.py:36-133: spatial attn -> temporal attn -> cross attn -> MLP
    with t2i (adaLN-single) modulation from a per-block scale_shift_table.
    fuse_epilogue: the residual adds of the spatial proj (with gate_msa),
    the cross proj and fc2 (with gate_mlp) as those linears' epilogues
    (stdit.py:70-74, :86-90, :135-136, :148-150); the temporal branch keeps
    its add."""

    def __init__(self, hidden_size: int, num_heads: int, d_s: int, d_t: int,
                 mlp_ratio: float = 4.0, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16,
                 fuse_epilogue: bool = False, sp_mesh=None,
                 sp_mode: str = "auto"):
        super().__init__()
        C = hidden_size
        self.d_s, self.d_t = d_s, d_t
        self.sp_mesh = sp_mesh
        self.fuse_epilogue = fuse_epilogue
        self.dtype = dtype
        self.resolver = resolver
        self.prefix = prefix
        self.scale_shift_table = nn.Parameter(torch.zeros(6, C))
        # spatial: [(B T), S, C], token-wise acts on the [B, T*S, C] view
        sp = dict(sp_mesh=sp_mesh, sp_mode=sp_mode)
        self.attn = SelfAttention(C, num_heads, resolver, f"{prefix}.attn",
                                  dtype, token_layout="spatial", d_t=d_t,
                                  d_s=d_s, **sp)
        # packed [B, (S T), C] segments; under sp [(B S), T, C] rows
        temporal = (dict(seg_len=d_t) if sp_mesh is None else
                    dict(token_layout="temporal", d_t=d_t, d_s=d_s, **sp))
        self.attn_temp = SelfAttention(C, num_heads, resolver,
                                       f"{prefix}.attn_temp", dtype,
                                       **temporal)
        self.cross_attn = CrossAttention(C, num_heads, resolver,
                                         f"{prefix}.cross_attn", dtype)
        self.mlp = Mlp(C, int(C * mlp_ratio), resolver, f"{prefix}.mlp",
                       dtype)

    def forward(self, x, y, t0, mask=None, tpe=None,
                qctx: Optional[QuantCtx] = None):
        B, N, C = x.shape
        T, S = self.d_t, self.d_s
        mods = (self.scale_shift_table[None].to(self.dtype)
                + t0.reshape(B, 6, -1).to(self.dtype))
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = torch.split(mods, 1, dim=1)

        # spatial branch: [B, (T S), C] -> [(B T), S, C]; under a fused plan
        # the K1 producer replaces LN + modulate + the q/k/v quantize
        pre_attn = ln_mod_prequant(self.resolver, self.prefix, x, shift_msa,
                                   scale_msa, ("attn.q", "attn.k", "attn.v"),
                                   qctx, self.attn.q, self.sp_mesh)
        x_s = None
        if pre_attn is None:
            x_s = t2i_modulate(layer_norm(x, self.dtype), shift_msa,
                               scale_msa).reshape(B * T, S, C)
        # capture mode: each linear's own output, the residual adds apart
        epi = self.fuse_epilogue and not (qctx is not None and qctx.capture)
        x_s = self.attn(x_s, qctx, prequant=pre_attn, shape=(B * T, S, C),
                        epilogue=(x, gate_msa.reshape(B, C)) if epi else None)
        x = (x_s.reshape(B, N, C) if epi
             else x + gate_msa * x_s.reshape(B, N, C))

        # temporal branch, packed as [B, (S T), C] segments of T tokens
        # (under sp: [(B S), T, C] rows)
        x_t = x.reshape(B, T, S, C).permute(0, 2, 1, 3)
        if tpe is not None:
            x_t = x_t + tpe.to(self.dtype)[None]
        x_t = self.attn_temp(x_t.reshape(B, S * T, C) if self.sp_mesh is None
                             else x_t.reshape(B * S, T, C), qctx)
        x_t = x_t.reshape(B, S, T, C).permute(0, 2, 1, 3)
        x = x + gate_msa * x_t.reshape(B, N, C)

        # cross attention to prompt tokens
        if epi:
            x = self.cross_attn(x, y, mask, qctx, epilogue=(x, None))
        else:
            x = x + self.cross_attn(x, y, mask, qctx)

        # MLP
        pre_mlp = ln_mod_prequant(self.resolver, self.prefix, x, shift_mlp,
                                  scale_mlp, ("mlp.fc1",), qctx,
                                  self.mlp.fc1, self.sp_mesh)
        x_in = None
        if pre_mlp is None:
            x_in = t2i_modulate(layer_norm(x, self.dtype), shift_mlp,
                                scale_mlp)
        if epi:
            return self.mlp(x_in, qctx, prequant=pre_mlp, epilogue=(
                x, gate_mlp.reshape(B, C))).reshape(B, N, C)
        h = self.mlp(x_in, qctx, prequant=pre_mlp)
        return x + gate_mlp * h.reshape(B, N, C)


class STDiT(nn.Module):
    """stdit.py:137-452. input_size is the latent [T, H, W]. fuse_epilogue:
    every block's residual adds in its linears' epilogues (`STDiTBlock`);
    grad_checkpoint: each block recomputed in the backward pass; a
    workload config sets either in its `model` dict. sp_mesh / sp_mode:
    sequence parallelism (module docstring)."""

    def __init__(self, input_size: Tuple[int, int, int] = (16, 64, 64),
                 in_channels: int = 4,
                 patch_size: Tuple[int, int, int] = (1, 2, 2),
                 hidden_size: int = 1152, depth: int = 28,
                 num_heads: int = 16, mlp_ratio: float = 4.0,
                 pred_sigma: bool = True, caption_channels: int = 4096,
                 model_max_length: int = 120, space_scale: float = 1.0,
                 time_scale: float = 1.0, no_temporal_pos_emb: bool = False,
                 resolver: Resolver = no_quant, dtype=torch.bfloat16,
                 fuse_epilogue: bool = False, grad_checkpoint: bool = False,
                 sp_mesh=None, sp_mode: str = "auto"):
        super().__init__()
        self.grad_checkpoint = grad_checkpoint
        self.depth = depth
        self.input_size = tuple(input_size)
        self.in_channels = in_channels
        self.patch_size = tuple(patch_size)
        self.hidden_size = hidden_size
        self.out_channels = in_channels * 2 if pred_sigma else in_channels
        self.dtype = dtype
        self.no_temporal_pos_emb = no_temporal_pos_emb
        self.num_temporal = input_size[0] // patch_size[0]
        self.num_spatial = ((input_size[1] // patch_size[1])
                            * (input_size[2] // patch_size[2]))
        grid = (input_size[1] // patch_size[1], input_size[2] // patch_size[2])
        # static sincos tables (numpy f64 -> f32), stdit.py:200-208
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(hidden_size, grid, scale=space_scale)[None]
        ).float(), persistent=False)
        self.register_buffer("pos_embed_temporal", torch.from_numpy(
            get_1d_sincos_pos_embed(hidden_size, self.num_temporal,
                                    scale=time_scale)[None]
        ).float(), persistent=False)
        C = hidden_size
        self.x_embedder = PatchEmbed3D(patch_size, in_channels, C, resolver,
                                       dtype=dtype)
        self.t_embedder = TimestepEmbedder(C, dtype=dtype)
        self.t_block = TBlock(C, dtype)
        self.y_embedder = CaptionEmbedder(caption_channels, C,
                                          model_max_length, dtype)
        self.blocks = nn.ModuleList([
            STDiTBlock(C, num_heads, d_s=self.num_spatial,
                       d_t=self.num_temporal, mlp_ratio=mlp_ratio,
                       resolver=resolver, prefix=f"blocks.{i}", dtype=dtype,
                       fuse_epilogue=fuse_epilogue, sp_mesh=sp_mesh,
                       sp_mode=sp_mode)
            for i in range(depth)])
        self.final_layer = T2IFinalLayer(C, int(np.prod(patch_size)),
                                          self.out_channels, resolver,
                                          dtype=dtype)

    def forward(self, x, timestep, y, mask=None,
                qctx: Optional[QuantCtx] = None, stage: str = "all",
                x_tokens=None):
        """x: [B, C, T, H, W]; timestep: [B]; y: [B, 1, L, C_cap] or
        [B, L, C_cap]; mask: [B, L] or the CFG-doubled [2B, L]. Returns
        [B, C_out, T, H, W] float32. stage 'embed': (x_tokens [B, T*S, C],
        t0, y, mask, tpe), the block stack's inputs; 'final': the head on
        the stack's output x_tokens (x, y and mask unused)."""
        if stage == "final":
            t = self.t_embedder(timestep)
            return self.unpatchify(self.final_layer(x_tokens, t,
                                                    qctx)).float()
        if stage not in ("all", "embed"):
            raise ValueError(f"unknown stage {stage!r}")
        B = x.shape[0]
        T, S, C = self.num_temporal, self.num_spatial, self.hidden_size
        x = self.x_embedder(x.to(self.dtype), qctx)
        x = x.reshape(B, T, S, C) + self.pos_embed.to(self.dtype)
        x = x.reshape(B, T * S, C)
        t = self.t_embedder(timestep)
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
        tpe = (None if self.no_temporal_pos_emb
               else self.pos_embed_temporal.to(self.dtype))
        if stage == "embed":
            return x, t0, y, mask, tpe
        for i, block in enumerate(self.blocks):
            x = call_block(block, self.grad_checkpoint, x, y, t0, mask,
                           tpe if i == 0 else None, qctx)
        x = self.final_layer(x, t, qctx)
        return self.unpatchify(x).float()

    def standalone_block(self, i: int):
        """(block i computing in float32 on a copy of its parameters and
        tables, its extra argument): the temporal position table in
        float32 for block 0, else None (JAX `_standalone_block`,
        reconstruction.py:441-450). Call it as block(x, y, t0, mask,
        extra, qctx)."""
        tpe = (None if self.no_temporal_pos_emb or i != 0
               else self.pos_embed_temporal.float())
        return float32_copy(self.blocks[i]), tpe

    def unpatchify(self, x):
        """[B, N, T_p*H_p*W_p*C_out] -> [B, C_out, T, H, W]."""
        n_t = self.input_size[0] // self.patch_size[0]
        n_h = self.input_size[1] // self.patch_size[1]
        n_w = self.input_size[2] // self.patch_size[2]
        t_p, h_p, w_p = self.patch_size
        c = self.out_channels
        B = x.shape[0]
        x = x.reshape(B, n_t, n_h, n_w, t_p, h_p, w_p, c)
        x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
        return x.reshape(B, c, n_t * t_p, n_h * h_p, n_w * w_p)


def STDiT_XL_2(**kwargs) -> STDiT:
    """stdit.py:454-456."""
    return STDiT(depth=28, hidden_size=1152, patch_size=(1, 2, 2),
                 num_heads=16, **kwargs)
