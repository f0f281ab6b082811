"""Sample saving (a copy of `viditq_tpu/utils/media.py`; reference
`opensora/datasets/utils.py save_sample:15`).

Videos are written as GIF + raw npz (no mp4 codec is assumed), images as
PNG, with the reference's normalization (value_range (-1, 1)): the same
files and bytes as the JAX package's `save_sample`."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _to_uint8(x: np.ndarray) -> np.ndarray:
    x = np.clip((np.asarray(x, np.float32) + 1.0) / 2.0, 0.0, 1.0)
    return (x * 255).astype(np.uint8)


def save_sample(x, save_path: str, fps: int = 8):
    """x: [C, H, W] image or [C, T, H, W] video, values in [-1, 1]."""
    from PIL import Image
    x = np.asarray(x)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    if x.ndim == 3:
        Image.fromarray(_to_uint8(x).transpose(1, 2, 0)).save(
            save_path + ".png")
        return save_path + ".png"
    frames = _to_uint8(x).transpose(1, 2, 3, 0)  # [T, H, W, C]
    np.savez_compressed(save_path + ".npz", video=frames)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(save_path + ".gif", save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
    return save_path + ".gif"
