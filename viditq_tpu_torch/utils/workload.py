"""Workload entry: model and sampler construction from a workload config
(port of `viditq_tpu/utils/workload.py:41-110`).

A workload config is the JAX package's dict (`model = dict(type=...)`,
`scheduler = dict(type=...)`, `image_size` or `num_frames`, `dtype`).
`build_model` puts the model on the card unless the caller passes
`device="cpu"`; without CUDA it raises rather than fall back to the CPU.
The CLI's sampler aliases (`override_type`) and the VAE are not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

import viditq_tpu_torch.samplers  # noqa: F401  (registers the schedulers)
from viditq_tpu_torch.models import MODELS, SCHEDULERS, build_module

_DTYPES = {"fp16": torch.bfloat16, "bf16": torch.bfloat16,
           "fp32": torch.float32, "float16": torch.bfloat16,
           "float32": torch.float32}


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
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "build the model on the CPU")
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


def build_sampler(cfg: Dict[str, Any], cfg_split: bool = False):
    """The config's scheduler ('iddpm' or 'dpm-solver'), CFG 4.0 unless the
    config sets it."""
    scfg = dict(cfg.get("scheduler", {"type": "iddpm"}))
    scfg.setdefault("cfg_scale", 4.0)
    scfg["cfg_split"] = cfg_split
    return build_module(scfg, SCHEDULERS)
