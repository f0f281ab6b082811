"""AutoencoderKL (the SD f8 VAE), its frame-wise video wrapper and the SVD
temporal decoder (port of `viditq_tpu/models/vae.py`), as `nn.Module`s in
NCHW (frames) and NCDHW (the temporal blocks' [B, C, T, H, W]).

Reference: `t2v/opensora/models/vae/vae.py` wraps diffusers'
AutoencoderKL frame-wise with micro-batching and latent scale 0.18215
(vae.py:10-59) and the SVD temporal decoder (vae.py:61-83). Every module
keeps the JAX module's name, arguments and submodule names (`conv_in`,
`down_{i}_block_{j}`, `mid_attn`, ...), so `utils/bridge.
vae_state_dict_from_flax` maps a JAX parameter tree onto the state dict by
name. The JAX package runs all of this in XLA, outside any Pallas kernel:
the convolutions are PyTorch's (cuDNN on the card), the group norms
`nn.GroupNorm`, the attention a float32 einsum and softmax. On the card a
float32 convolution runs in TF32 unless the caller turns
`torch.backends.cudnn.allow_tf32` off.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    """flax nn.GroupNorm(32, epsilon=1e-6) over channels (dim 1); the JAX
    module's `gn.scale`/`gn.bias` are `weight`/`bias`."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-6, dtype=torch.float32):
        super().__init__(num_groups, num_channels, eps=eps, dtype=dtype)


def _conv(cin, cout, k, dtype, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dtype=dtype)


def _upsample2(h):
    """jax.image.resize(..., 'nearest') to twice the size."""
    return F.interpolate(h, scale_factor=2, mode="nearest")


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, dtype=dtype)
        self.conv1 = _conv(in_channels, out_channels, 3, dtype, padding=1)
        self.norm2 = GroupNorm(out_channels, dtype=dtype)
        self.conv2 = _conv(out_channels, out_channels, 3, dtype, padding=1)
        self.conv_shortcut = (_conv(in_channels, out_channels, 1, dtype)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the H*W positions, the scores and
    softmax in float32 (vae.py:49-67)."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels, dtype=dtype)
        self.q = nn.Linear(channels, channels, dtype=dtype)
        self.k = nn.Linear(channels, channels, dtype=dtype)
        self.v = nn.Linear(channels, channels, dtype=dtype)
        self.proj_out = nn.Linear(channels, channels, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.q(h), self.k(h), self.v(h)
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q.float(),
                                          k.float()) * (C ** -0.5),
                             dim=-1).to(x.dtype)
        h = self.proj_out(torch.einsum("bnm,bmc->bnc", attn, v))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class Encoder(nn.Module):
    """[B, 3, H, W] -> [B, 2 * latent, H/f, W/f] (mean ++ logvar), f =
    2^(len(block_out_channels) - 1)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 dtype=torch.float32):
        super().__init__()
        chans = tuple(block_out_channels)
        self.n_levels = len(chans)
        self.layers_per_block = layers_per_block
        self.conv_in = _conv(3, chans[0], 3, dtype, padding=1)
        prev = chans[0]
        for i, ch in enumerate(chans):
            for j in range(layers_per_block):
                self.add_module(f"down_{i}_block_{j}",
                                ResnetBlock(prev, ch, dtype))
                prev = ch
            if i < len(chans) - 1:  # padding ((0, 1), (0, 1)), stride 2
                self.add_module(f"down_{i}_downsample",
                                _conv(ch, ch, 3, dtype, stride=2))
        ch = chans[-1]
        self.mid_block_1 = ResnetBlock(ch, ch, dtype)
        self.mid_attn = AttnBlock(ch, dtype)
        self.mid_block_2 = ResnetBlock(ch, ch, dtype)
        self.norm_out = GroupNorm(ch, dtype=dtype)
        self.conv_out = _conv(ch, 2 * latent_channels, 3, dtype, padding=1)
        self.quant_conv = _conv(2 * latent_channels, 2 * latent_channels, 1,
                                dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for i in range(self.n_levels):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{i}_block_{j}")(h)
            if i < self.n_levels - 1:
                h = getattr(self, f"down_{i}_downsample")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        h = F.silu(self.norm_out(h))
        return self.quant_conv(self.conv_out(h))


class Decoder(nn.Module):
    """[B, 4, h, w] -> [B, out_channels, h*f, w*f]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 3, out_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        rev = list(reversed(tuple(block_out_channels)))
        self.n_levels = len(rev)
        self.layers_per_block = layers_per_block
        self.post_quant_conv = _conv(4, 4, 1, dtype)
        ch = rev[0]
        self.conv_in = _conv(4, ch, 3, dtype, padding=1)
        self.mid_block_1 = ResnetBlock(ch, ch, dtype)
        self.mid_attn = AttnBlock(ch, dtype)
        self.mid_block_2 = ResnetBlock(ch, ch, dtype)
        prev = ch
        for i, c in enumerate(rev):
            for j in range(layers_per_block):
                self.add_module(f"up_{i}_block_{j}",
                                ResnetBlock(prev, c, dtype))
                prev = c
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample",
                                _conv(c, c, 3, dtype, padding=1))
        self.norm_out = GroupNorm(rev[-1], dtype=dtype)
        self.conv_out = _conv(rev[-1], out_channels, 3, dtype, padding=1)

    def forward(self, z):
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        for i in range(self.n_levels):
            for j in range(self.layers_per_block):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i < self.n_levels - 1:
                h = getattr(self, f"up_{i}_upsample")(_upsample2(h))
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """SD f8 KL autoencoder, channels-first [B, C, H, W]. decoder=False
    builds the encoder alone (what training encodes with; the JAX `train`
    command initialises `method=vae.encode`, which has no decoder
    parameters either)."""

    def __init__(self, latent_channels: int = 4,
                 scaling_factor: float = 0.18215, dtype=torch.float32,
                 decoder: bool = True):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.dtype = dtype
        self.encoder = Encoder(latent_channels=latent_channels, dtype=dtype)
        self.decoder = Decoder(dtype=dtype) if decoder else None

    def encode(self, x, generator: Optional[torch.Generator] = None):
        """x [B, 3, H, W] -> latent [B, 4, H/8, W/8]: the posterior mean, or
        its draw from `generator` (on the generator's device; the JAX
        package draws from a threefry key, so the values differ)."""
        mean, logvar = torch.chunk(self.encoder(x.to(self.dtype)), 2, dim=1)
        if generator is not None:
            std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
            noise = torch.randn(mean.shape, generator=generator,
                                device=generator.device, dtype=mean.dtype)
            mean = mean + std * noise.to(mean.device)
        return mean * self.scaling_factor

    def decode(self, z):
        """z [B, 4, h, w] -> [B, 3, 8h, 8w]."""
        if self.decoder is None:
            raise RuntimeError("this AutoencoderKL was built without its "
                               "decoder")
        return self.decoder((z / self.scaling_factor).to(self.dtype))

    def forward(self, x, generator=None):
        return self.decode(self.encode(x, generator))


class TemporalResnetBlock(nn.Module):
    """Temporal-only residual block: (3, 1, 1) convs over the frame axis
    (diffusers TemporalResnetBlock as the SVD TemporalDecoder uses it).
    Input [B, C, T, H, W]."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype=torch.float32):
        super().__init__()
        kw = dict(kernel_size=(3, 1, 1), padding=(1, 0, 0), dtype=dtype)
        self.norm1 = GroupNorm(in_channels, dtype=dtype)
        self.conv1 = nn.Conv3d(in_channels, out_channels, **kw)
        self.norm2 = GroupNorm(out_channels, dtype=dtype)
        self.conv2 = nn.Conv3d(out_channels, out_channels, **kw)
        self.conv_shortcut = (nn.Conv3d(in_channels, out_channels, 1,
                                        dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _to_video(h, num_frames):
    """[B*T, C, H, W] -> [B, C, T, H, W]."""
    BT, C, H, W = h.shape
    return h.reshape(BT // num_frames, num_frames, C, H, W).transpose(1, 2)


def _to_frames(hv):
    """[B, C, T, H, W] -> [B*T, C, H, W]."""
    B, C, T, H, W = hv.shape
    return hv.transpose(1, 2).reshape(B * T, C, H, W)


class SpatioTemporalResBlock(nn.Module):
    """Spatial ResnetBlock + temporal ResnetBlock blended with a learned
    alpha (diffusers SpatioTemporalResBlock, merge_strategy='learned':
    out = a * spatial + (1 - a) * temporal, a = sigmoid(mix_factor)).
    Input [B*T, C, H, W] with a static num_frames."""

    def __init__(self, in_channels: int, out_channels: int, num_frames: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_frames = num_frames
        self.spatial_res_block = ResnetBlock(in_channels, out_channels, dtype)
        self.temporal_res_block = TemporalResnetBlock(out_channels,
                                                      out_channels, dtype)
        self.mix_factor = nn.Parameter(torch.full((1,), 0.5,
                                                  dtype=torch.float32))

    def forward(self, x):
        h = self.spatial_res_block(x)
        hv = _to_video(h, self.num_frames)
        ht = self.temporal_res_block(hv)
        a = torch.sigmoid(self.mix_factor[0]).to(h.dtype)
        return _to_frames(a * hv + (1.0 - a) * ht)


class TemporalDecoder(nn.Module):
    """SVD-style temporal VAE decoder: the spatial SD decoder topology with
    every resblock a SpatioTemporalResBlock, plus a (3, 1, 1) conv over
    frames on the RGB output (diffusers TemporalDecoder; vae.py:61-83).
    Input z [B*T, latent, h, w]; output [B*T, out_channels, 8h, 8w]."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, out_channels: int = 3,
                 num_frames: int = 1, latent_channels: int = 4,
                 dtype=torch.float32):
        super().__init__()
        T = num_frames
        self.num_frames = T
        rev = list(reversed(tuple(block_out_channels)))
        self.n_levels = len(rev)
        self.layers_per_block = layers_per_block
        ch = rev[0]
        self.conv_in = _conv(latent_channels, ch, 3, dtype, padding=1)
        self.mid_block_1 = SpatioTemporalResBlock(ch, ch, T, dtype)
        self.mid_attn = AttnBlock(ch, dtype)
        self.mid_block_2 = SpatioTemporalResBlock(ch, ch, T, dtype)
        prev = ch
        for i, c in enumerate(rev):
            for j in range(layers_per_block + 1):
                self.add_module(f"up_{i}_block_{j}",
                                SpatioTemporalResBlock(prev, c, T, dtype))
                prev = c
            if i < len(rev) - 1:
                self.add_module(f"up_{i}_upsample",
                                _conv(c, c, 3, dtype, padding=1))
        self.norm_out = GroupNorm(rev[-1], dtype=dtype)
        self.conv_out = _conv(rev[-1], out_channels, 3, dtype, padding=1)
        self.time_conv_out = nn.Conv3d(out_channels, out_channels, (3, 1, 1),
                                       padding=(1, 0, 0), dtype=dtype)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        for i in range(self.n_levels):
            for j in range(self.layers_per_block + 1):
                h = getattr(self, f"up_{i}_block_{j}")(h)
            if i < self.n_levels - 1:
                h = getattr(self, f"up_{i}_upsample")(_upsample2(h))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return _to_frames(self.time_conv_out(_to_video(h, self.num_frames)))


class VideoAutoencoderKLTemporalDecoder(nn.Module):
    """Reference VideoAutoencoderKLTemporalDecoder (vae.py:61-83): decode
    latents [B, C, T, H, W] through the SVD temporal decoder; encode is
    not implemented in the reference either."""

    def __init__(self, num_frames: int, latent_channels: int = 4,
                 scaling_factor: float = 0.18215,
                 patch_size: Tuple[int, int, int] = (1, 8, 8),
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, dtype=torch.float32):
        super().__init__()
        self.num_frames = num_frames
        self.scaling_factor = scaling_factor
        self.patch_size = tuple(patch_size)
        self.dtype = dtype
        self.decoder = TemporalDecoder(
            block_out_channels=block_out_channels,
            layers_per_block=layers_per_block, num_frames=num_frames,
            latent_channels=latent_channels, dtype=dtype)

    def encode(self, x, generator=None):
        raise NotImplementedError(
            "the reference temporal-decoder VAE is decode-only (vae.py:69)")

    def decode(self, z):
        B, C, T = z.shape[:3]
        if T != self.num_frames:
            raise ValueError(f"latent has {T} frames, the decoder "
                             f"{self.num_frames}")
        out = self.decoder(_to_frames((z / self.scaling_factor)
                                      .to(self.dtype)))
        return _to_video(out, T)

    def forward(self, z):
        return self.decode(z)

    def get_latent_size(self, input_size):
        return [input_size[i] // self.patch_size[i] for i in range(3)]


class VideoAutoencoderKL(nn.Module):
    """Frame-wise video wrapper (vae.py:10-59): [B, C, T, H, W] <->
    [(B T), C, H, W] with micro-batched encode/decode. decoder=False: the
    encoder alone (`AutoencoderKL`)."""

    def __init__(self, micro_batch_size: Optional[int] = None,
                 patch_size: Tuple[int, int, int] = (1, 8, 8),
                 dtype=torch.float32, decoder: bool = True):
        super().__init__()
        self.micro_batch_size = micro_batch_size
        self.patch_size = tuple(patch_size)
        self.module = AutoencoderKL(dtype=dtype, decoder=decoder)

    def _framewise(self, fn, x):
        B, C, T = x.shape[:3]
        flat = _to_frames(x)
        mb = self.micro_batch_size
        if mb is None or flat.shape[0] <= mb:
            out = fn(flat)
        else:
            out = torch.cat([fn(flat[i:i + mb])
                             for i in range(0, flat.shape[0], mb)])
        return _to_video(out, T)

    def encode(self, x, generator: Optional[torch.Generator] = None):
        """x [B, 3, T, H, W] -> [B, 4, T, H/8, W/8]; with a generator each
        micro-batch's posterior draw in order."""
        return self._framewise(lambda f: self.module.encode(f, generator), x)

    def decode(self, z):
        return self._framewise(self.module.decode, z)

    def forward(self, x, generator=None):
        return self.decode(self.encode(x, generator))

    def get_latent_size(self, input_size):
        """vae.py:54-59."""
        return [input_size[i] // self.patch_size[i] for i in range(3)]
