"""MMDiT (SD3-class multimodal DiT) with its rectified-flow sampler: port
of `viditq_tpu/models/mmdit.py`.

Image and text tokens keep weights of their own in every block but attend
jointly. Plans name the linears as the JAX package does
(`blocks.N.img_attn.{q,k,v,proj}`, `blocks.N.txt_mlp.{fc1,fc2}`), while
the modules keep the flax names (`img_attn_proj`, `txt_attn_proj`), so the
JAX trees load through `utils/bridge.py` unchanged. Under a fused plan the
image stream's LN + modulate + q/k/v quantize, and that before fc1, run in
one K1 pass each (mmdit.py:84-123; without the TPU tiling gate N % 256);
the text stream (77 tokens, fp under `configs/mmdit/w4a8_tpu_fused.yaml`)
keeps the unfused path. The joint attention runs `layers.sdpa` (PyTorch's
fused attention on the card, where the JAX package called the stock flash
kernel) over the unpadded N_t + N_i tokens: JAX's pad to a multiple of 256
only engaged the TPU kernel, and its masked kv rows leave the result as
it is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from viditq_tpu_torch.models.layers import (
    Mlp, PatchEmbed, Resolver, TimestepEmbedder, get_2d_sincos_pos_embed,
    layer_norm, ln_mod_prequant, modulate, no_quant, sdpa)
from viditq_tpu_torch.quant.qlinear import (QuantCtx, QuantLinear,
                                            shared_prequant)


class _StreamAttnProj(nn.Module):
    """One stream's q/k/v linears (mmdit.py:30-56); on the native dynamic
    path they share one quantize of their input (`shared_prequant`) unless
    a producer hands them its codes."""

    def __init__(self, dim: int, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16):
        super().__init__()
        self.specs = [resolver(f"{prefix}.{n}") for n in ("q", "k", "v")]
        self.q, self.k, self.v = (QuantLinear(dim, dim, s, dtype=dtype)
                                  for s in self.specs)

    def forward(self, x, qctx: Optional[QuantCtx] = None, prequant=None):
        pre = prequant
        s0 = self.specs[0]
        if (pre is None and qctx is not None and qctx.mode == "quant"
                and all(s == s0 for s in self.specs)):
            pre = shared_prequant(x, s0)
        return tuple(lin(x, qctx, prequant=pre)
                     for lin in (self.q, self.k, self.v))


class MMDiTBlock(nn.Module):
    """Dual-stream joint-attention block (mmdit.py:59-173): per-stream
    adaLN-Zero from one `adaLN_linear` of 12 vectors."""

    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, resolver: Resolver = no_quant,
                 prefix: str = "", dtype=torch.bfloat16):
        super().__init__()
        C = hidden_size
        self.num_heads = num_heads
        self.dtype = dtype
        self.resolver = resolver
        self.prefix = prefix
        self.adaLN_linear = QuantLinear(C, 12 * C, dtype=dtype,
                                        kernel_init="lecun_normal")
        self.img_attn = _StreamAttnProj(C, resolver, f"{prefix}.img_attn",
                                        dtype)
        self.txt_attn = _StreamAttnProj(C, resolver, f"{prefix}.txt_attn",
                                        dtype)
        self.img_attn_proj = QuantLinear(
            C, C, resolver(f"{prefix}.img_attn.proj"), dtype=dtype)
        self.txt_attn_proj = QuantLinear(
            C, C, resolver(f"{prefix}.txt_attn.proj"), dtype=dtype)
        hidden = int(C * mlp_ratio)
        self.img_mlp = Mlp(C, hidden, resolver, f"{prefix}.img_mlp", dtype)
        self.txt_mlp = Mlp(C, hidden, resolver, f"{prefix}.txt_mlp", dtype)

    def _img_prequant(self, img, shift, scale, spec_names, qctx, consumer):
        """The image stream's K1 producer (mmdit.py:84-111): as the STDiT
        block's, but never under channel balancing."""
        s0 = self.resolver(f"{self.prefix}.{spec_names[0]}")
        if s0 is None or s0.smooth_quant.enable:
            return None
        return ln_mod_prequant(self.resolver, self.prefix, img,
                               shift[:, None], scale[:, None], spec_names,
                               qctx, consumer)

    def _modulated(self, x, shift, scale, pre):
        return (None if pre is not None
                else modulate(layer_norm(x, self.dtype), shift, scale))

    def forward(self, img, txt, c, qctx: Optional[QuantCtx] = None):
        B, N_i, C = img.shape
        N_t = txt.shape[1]
        H = self.num_heads
        D = C // H
        (i_shift, i_scale, i_gate, i_shift2, i_scale2, i_gate2, t_shift,
         t_scale, t_gate, t_shift2, t_scale2, t_gate2) = torch.chunk(
             self.adaLN_linear(F.silu(c)), 12, dim=-1)

        pre = self._img_prequant(img, i_shift, i_scale,
                                 ("img_attn.q", "img_attn.k", "img_attn.v"),
                                 qctx, self.img_attn.q)
        img_m = self._modulated(img, i_shift, i_scale, pre)
        qi, ki, vi = self.img_attn(img_m, qctx, prequant=pre)
        qt, kt, vt = self.txt_attn(
            modulate(layer_norm(txt, self.dtype), t_shift, t_scale), qctx)
        N = N_t + N_i

        def heads(a, b):  # joint [txt; img] tokens, [B, H, N, D]
            return torch.cat([a.reshape(B, N_t, C), b.reshape(B, N_i, C)],
                             dim=1).reshape(B, N, H, D).transpose(1, 2)
        out = sdpa(heads(qt, qi), heads(kt, ki), heads(vt, vi),
                   scale=D ** -0.5)
        out = out.transpose(1, 2).reshape(B, N, C)
        img = img + i_gate[:, None] * self.img_attn_proj(
            out[:, N_t:], qctx).reshape(B, N_i, C)
        txt = txt + t_gate[:, None] * self.txt_attn_proj(
            out[:, :N_t], qctx).reshape(B, N_t, C)

        pre = self._img_prequant(img, i_shift2, i_scale2, ("img_mlp.fc1",),
                                 qctx, self.img_mlp.fc1)
        img = img + i_gate2[:, None] * self.img_mlp(
            self._modulated(img, i_shift2, i_scale2, pre), qctx,
            prequant=pre).reshape(B, N_i, C)
        txt = txt + t_gate2[:, None] * self.txt_mlp(
            modulate(layer_norm(txt, self.dtype), t_shift2, t_scale2),
            qctx).reshape(B, N_t, C)
        return img, txt


class MMDiT(nn.Module):
    """Rectified-flow multimodal DiT (mmdit.py:176-245). input_size is the
    latent's side."""

    def __init__(self, input_size: int = 64, patch_size: int = 2,
                 in_channels: int = 4, hidden_size: int = 1152,
                 depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, caption_channels: int = 4096,
                 pooled_channels: int = 2048, model_max_length: int = 77,
                 resolver: Resolver = no_quant, dtype=torch.bfloat16):
        super().__init__()
        C = hidden_size
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.pooled_channels = pooled_channels
        self.dtype = dtype
        grid = input_size // patch_size
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(C, (grid, grid))[None]).float(),
            persistent=False)
        self.x_embedder = PatchEmbed(patch_size, in_channels, C, resolver,
                                     dtype=dtype)
        dense = dict(dtype=dtype, kernel_init="lecun_normal")
        self.context_embedder = QuantLinear(caption_channels, C, **dense)
        self.t_embedder = TimestepEmbedder(C, dtype=dtype)
        self.y_embedder_fc1 = QuantLinear(pooled_channels, C, **dense)
        self.y_embedder = QuantLinear(C, C, **dense)
        self.blocks = nn.ModuleList([
            MMDiTBlock(C, num_heads, mlp_ratio, resolver, f"blocks.{i}",
                       dtype) for i in range(depth)])
        self.final_adaLN = QuantLinear(C, 2 * C, **dense)
        self.final_linear = QuantLinear(C, patch_size ** 2 * in_channels,
                                        **dense)

    def _pos_embed(self, h: int, w: int):
        if h * w == self.pos_embed.shape[1] and h == w:
            return self.pos_embed
        return torch.from_numpy(get_2d_sincos_pos_embed(
            self.hidden_size, (h, w))[None]).float().to(self.pos_embed.device)

    def forward(self, x, timestep, y, mask=None,
                qctx: Optional[QuantCtx] = None, y_pooled=None):
        """x: [B, C, H, W]; timestep: [B] in [0, 1000); y: [B, 1, L, C_cap]
        or [B, L, C_cap] text tokens; mask [B, L] (or one row) multiplies
        them; y_pooled [B, C_pool] (zeros if None; a keyword here, as the
        samplers pass qctx fifth). Returns the velocity [B, C, H, W]
        float32."""
        B = x.shape[0]
        p = self.patch_size
        h, w = x.shape[-2] // p, x.shape[-1] // p
        img = (self.x_embedder(x.to(self.dtype), qctx)
               + self._pos_embed(h, w).to(self.dtype))
        if y.dim() == 4:
            y = y.reshape(B, -1, y.shape[-1])
        txt = self.context_embedder(y.to(self.dtype))
        if mask is not None:
            txt = txt * mask[..., None].to(txt.dtype)
        t_emb = self.t_embedder(timestep)
        if y_pooled is None:
            y_pooled = torch.zeros((B, self.pooled_channels),
                                   dtype=self.dtype, device=x.device)
        cond = t_emb + self.y_embedder(F.silu(self.y_embedder_fc1(
            y_pooled.to(self.dtype))))
        for block in self.blocks:
            img, txt = block(img, txt, cond, qctx)
        shift, scale = torch.chunk(self.final_adaLN(F.silu(cond)), 2, dim=-1)
        img = self.final_linear(modulate(layer_norm(img, self.dtype), shift,
                                         scale))
        img = img.reshape(B, h, w, p, p, self.in_channels)
        img = torch.einsum("nhwpqc->nchpwq", img)
        return img.reshape(B, self.in_channels, h * p, w * p).float()


def rectified_flow_sample(model_apply, z, y, mask=None, num_steps: int = 20,
                          cfg_scale: float = 4.0, qctx_factory=None,
                          return_trajectory: bool = False):
    """Euler rectified-flow sampler (mmdit.py:248-276): dx/dt = v(x, t), t
    from 1 (noise) to 0. model_apply(x, t [2B], y, mask, qctx) -> the
    velocity; y is [cond; null] ([2B, ...]) for CFG. The times are JAX's
    float32 `linspace(1, 0, n + 1)` (1 - i / n); the model takes t * 999
    in float32, the context its truncation clipped to [0, 999], and each
    step adds (t1 - t0) * v in float32 to the latent, cast back to its
    dtype."""
    n = np.float32(num_steps)
    ts = [np.float32(1) - np.float32(i) / n for i in range(num_steps)]
    ts.append(np.float32(0))
    B = z.shape[0]
    x = z
    xs, tr = [], []
    with torch.no_grad():
        for i in range(num_steps):
            t0, t1 = ts[i], ts[i + 1]
            t999 = np.float32(t0 * np.float32(999))
            t_model = torch.full((2 * B,), float(t999), dtype=torch.float32,
                                 device=z.device)
            t_id = min(max(int(t999), 0), 999)
            qctx = (qctx_factory(t_id, i) if qctx_factory is not None
                    else None)
            v = model_apply(torch.cat([x, x], dim=0), t_model, y, mask, qctx)
            v_c, v_u = torch.chunk(v, 2, dim=0)
            v = v_u + cfg_scale * (v_c - v_u)
            if return_trajectory:
                xs.append(x)
                tr.append(t_model[:B].to(torch.int32))
            dt = torch.tensor(np.float32(t1 - t0), device=z.device)
            x = (x.float() + dt * v.to(x.dtype).float()).to(x.dtype)
    if return_trajectory:
        return x, {"xs": torch.stack(xs), "ts": torch.stack(tr)}
    return x
