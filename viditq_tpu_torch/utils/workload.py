"""Workload entry: config files, model and sampler construction (port of
`viditq_tpu/utils/workload.py:25-110`).

A workload config is a python file exec'd into a plain dict
(`load_py_config`; `model = dict(type=...)`, `scheduler = dict(type=...)`,
`image_size` or `num_frames`, `dtype`), as in the JAX package.
`build_model` puts the model on the card unless the caller passes
`device="cpu"`; without CUDA it raises rather than fall back to the CPU.
`build_sampler` takes the CLI's `--sampler_type` choices. `random_init_`
is the port's seeded parameter draw for inference (bench.py's N(0, 0.02));
`jax_init_` draws each parameter from the distribution its JAX module's
initialiser uses (flax's `model.init`), where training starts, and where
a VAE without a checkpoint starts. `build_vae` builds the config's VAE
(`models/vae.py`).
"""

from __future__ import annotations

import runpy
from typing import Any, Dict, Optional, Tuple

import torch

import viditq_tpu_torch.samplers  # noqa: F401  (registers the schedulers)
from viditq_tpu_torch.models import MODELS, SCHEDULERS, build_module

_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16,
           "fp32": torch.float32, "float16": torch.bfloat16,
           "float32": torch.float32}


def load_py_config(path: str) -> Dict[str, Any]:
    """A python config file's top-level names, but the private ones."""
    ns = runpy.run_path(path)
    return {k: v for k, v in ns.items() if not k.startswith("_")}


def model_dtype(cfg: Dict[str, Any]):
    return _DTYPES.get(str(cfg.get("dtype", "bf16")).lower(), torch.bfloat16)


def latent_size(cfg: Dict[str, Any]) -> Tuple[int, ...]:
    """(T, H/8, W/8) for a video workload, (H/8, W/8) for an image one."""
    if "num_frames" in cfg:
        t = cfg["num_frames"]
        h, w = cfg.get("image_size", (512, 512))
        return (t, h // 8, w // 8)
    size = cfg.get("image_size", 512)
    if isinstance(size, (tuple, list)):
        size = size[0]
    return (size // 8, size // 8)


def build_model(cfg: Dict[str, Any], resolver=None, dtype=None,
                device: str = "cuda"):
    """The config's model on `device` (the card by default), in eval mode,
    with its fp weights at their initial values and its quant tables
    uncalibrated (calibrate and pack before a quantized run)."""
    dev = _device(device)
    mcfg = dict(cfg["model"])
    for key in ("from_pretrained", "enable_flashattn",
                "enable_layernorm_kernel"):
        mcfg.pop(key, None)
    ls = latent_size(cfg)
    mcfg.setdefault("input_size", ls if len(ls) == 3 else ls[0])
    if resolver is not None:
        mcfg["resolver"] = resolver
    mcfg["dtype"] = dtype or model_dtype(cfg)
    with dev:
        model = build_module(mcfg, MODELS)
    return model.to(dev).eval()  # the static sincos tables start on the host


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "build the model on the CPU")
    return dev


def build_vae(cfg: Dict[str, Any], device: str = "cuda",
              decoder: bool = True):
    """The config's `vae` (JAX workload.py:98-110), in float32 on `device`
    (the card by default), in eval mode, with PyTorch's default parameters
    (draw them with `jax_init_` or load a checkpoint):
    'VideoAutoencoderKL' (the default) with the config's
    `micro_batch_size`, 'VideoAutoencoderKLTemporalDecoder' at the
    config's `num_frames` (16 without one), any other kind a frame
    `AutoencoderKL`. decoder=False builds the KL autoencoders' encoder
    alone (training encodes only)."""
    from viditq_tpu_torch.models.vae import (
        AutoencoderKL, VideoAutoencoderKL, VideoAutoencoderKLTemporalDecoder)
    dev = _device(device)
    vcfg = dict(cfg.get("vae", {"type": "VideoAutoencoderKL"}))
    kind = vcfg.pop("type", "VideoAutoencoderKL")
    with dev:
        if kind == "VideoAutoencoderKL":
            vae = VideoAutoencoderKL(
                micro_batch_size=vcfg.get("micro_batch_size"),
                decoder=decoder)
        elif kind == "VideoAutoencoderKLTemporalDecoder":
            vae = VideoAutoencoderKLTemporalDecoder(
                num_frames=cfg.get("num_frames", 16))
        else:
            vae = AutoencoderKL(decoder=decoder)
    return vae.eval()


def random_init_(model, seed: int = 0, scale: float = 0.02):
    """normal x scale for every float parameter (bench.py:149-152 uses
    0.02), in `named_parameters` order from a seeded generator on the
    model's device. The quant tables are not drawn (calibration and packing
    write them all), so every plan draws the same fp weights from the same
    seed, whichever layers it quantizes. The draws are not those of the
    JAX package's flax initialisers."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for _, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * scale)
    return model


# flax's truncated normal (variance_scaling 'truncated_normal'): a unit
# normal cut at +-2, rescaled by this to keep the asked variance
TRUNC_STD = 0.87962566103423978


def _jax_draw(module, leaf: str, p: torch.Tensor, g: torch.Generator):
    """The draw of parameter `leaf` of `module` from its JAX initialiser."""
    from viditq_tpu_torch.models.layers import (AffineLayerNorm,
                                                CaptionEmbedder,
                                                DepthwiseQuantConv,
                                                LabelEmbedder)
    from viditq_tpu_torch.quant.qlinear import QuantLinear

    def normal(std):
        return torch.randn(p.shape, generator=g, device=p.device) * std

    def lecun_normal(fan_in):
        t = torch.empty_like(p)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        return t * (fan_in ** -0.5 / TRUNC_STD)
    if leaf == "bias" or (isinstance(module, AffineLayerNorm)
                          and leaf == "scale"):
        # every bias zeros_init; the affine LayerNorm's scale ones
        return (torch.ones_like(p) if leaf == "scale"
                else torch.zeros_like(p))
    # the VAE's flax modules (models/vae.py): nn.Conv and nn.Dense kernels
    # lecun-normal over their fan in (kh * kw * C_in, C_in), GroupNorm's
    # scale ones, the temporal blocks' mix_factor the constant 0.5
    if (isinstance(module, (torch.nn.Conv2d, torch.nn.Conv3d,
                            torch.nn.Linear)) and leaf == "weight"):
        return lecun_normal(p[0].numel())
    if isinstance(module, torch.nn.GroupNorm) and leaf == "weight":
        return torch.ones_like(p)
    if leaf == "mix_factor":
        return torch.full_like(p, 0.5)
    if isinstance(module, QuantLinear) and leaf == "kernel":
        fan_in, fan_out = p.shape  # the JAX [in, out] layout
        if module.kernel_init == "xavier_uniform":
            limit = (6.0 / (fan_in + fan_out)) ** 0.5
            return (torch.rand(p.shape, generator=g, device=p.device)
                    * 2 - 1) * limit
        if module.kernel_init == "lecun_normal":
            return lecun_normal(fan_in)
        raise ValueError(f"unknown kernel_init {module.kernel_init!r}")
    if isinstance(module, DepthwiseQuantConv) and leaf == "kernel":
        return torch.full_like(p, 1.0 / module.ratio ** 2)  # layers.py:258
    if leaf == "scale_shift_table":
        return normal(p.shape[-1] ** -0.5)  # stdit.py:55, layers.py:963
    if isinstance(module, CaptionEmbedder) and leaf == "y_embedding":
        return normal(p.shape[-1] ** -0.5)  # layers.py:857
    if isinstance(module, LabelEmbedder) and leaf == "embedding":
        return normal(0.02)  # layers.py:876
    raise NotImplementedError(
        f"no JAX initialiser known for {type(module).__name__}.{leaf}")


def jax_init_(model, seed: int = 0):
    """Every parameter drawn from the distribution of its JAX module's
    initialiser, as the JAX `train` command starts from `model.init`
    (pipelines/train.py:78-83): QuantLinear kernels xavier-uniform over
    their [in, out] fans (qlinear.py:211), where the JAX model builds a
    flax `nn.Dense` or patchify conv lecun-normal (flax's truncated normal,
    `kernel_init`), biases zero, the affine LayerNorm's scale one, the
    KV-compress `sr` kernel the constant 1 / r^2, the adaLN tables
    N(0, C^-1/2), the null caption N(0, C_cap^-1/2), the label table
    N(0, 0.02); the VAE's (`models/vae.py`) conv and Dense kernels
    lecun-normal, its GroupNorm scales one, its `mix_factor` 0.5. The
    draws come from a generator seeded by seed on the
    model's device, in `named_parameters` order (torch's, not threefry's:
    the distributions are JAX's, the values are not). The quant tables are
    buffers and keep their initial constants."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    owners = {}
    for mname, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            owners[f"{mname}.{leaf}" if mname else leaf] = (mod, leaf)
    with torch.no_grad():
        for name, p in model.named_parameters():
            mod, leaf = owners[name]
            p.copy_(_jax_draw(mod, leaf, p, g))
    return model


# --sampler_type (reference t2i quant_txt2img.py:138-182): 'ddim' and
# 'iddpm' keep the config's scheduler; these names replace it
SAMPLER_ALIASES = {"dpms": "dpm-solver", "dpm-solver": "dpm-solver",
                   "sa-solver": "sa-solver", "lcm": "lcm", "edm": "edm"}
SAMPLER_TYPES = ("ddim", "iddpm", "dpms", "dpm-solver", "sa-solver", "lcm",
                 "edm")


def build_sampler(cfg: Dict[str, Any], cfg_split: bool = False,
                  override_type: Optional[str] = None):
    """The config's scheduler, CFG 4.0 unless the config sets it.
    override_type: the CLI's `--sampler_type` (JAX workload.py:70-95):
    'ddim' and 'iddpm' keep the config's scheduler (the IDDPM wrapper
    samples by either loop, the name going to its `sample`); a solver name
    replaces a scheduler of another type, keeping its step count, scale
    and channels. `cfg_split` reaches the IDDPM and DPM-Solver samplers
    only: SA-Solver, LCM and EDM take none."""
    scfg = dict(cfg.get("scheduler", {"type": "iddpm"}))
    scfg.setdefault("cfg_scale", 4.0)
    if override_type is not None and override_type not in SAMPLER_TYPES:
        raise ValueError(f"unknown sampler type {override_type!r}")
    target = SAMPLER_ALIASES.get(override_type)
    if target is not None and scfg.get("type") != target:
        scfg = {"type": target,
                **{k: scfg[k] for k in
                   ("num_sampling_steps", "cfg_scale", "in_channels")
                   if k in scfg}}
    if scfg.get("type", "iddpm") in ("iddpm", "dpm-solver"):
        scfg["cfg_split"] = cfg_split
    return build_module(scfg, SCHEDULERS)
