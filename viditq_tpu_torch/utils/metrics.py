"""Generation-quality metrics (port of `viditq_tpu/utils/metrics.py:17-56,
186-226`): frame MSE, PSNR and the CLIP-free proxies of the reference's
clip_temp and flow axes, and the sensitivity metrics built on them. Inputs
are tensors or arrays of samples; every statistic is taken in float32.
The CLIP score needs CLIP weights and `transformers`, so 'clip' raises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def _f32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float()
    return torch.as_tensor(np.asarray(x, np.float32))


def frame_mse(a, b) -> float:
    """MSE between generations (metric.ipynb cell 2)."""
    a, b = _f32(a), _f32(b)
    return float(((a - b.to(a.device)) ** 2).mean())


def psnr(a, b, data_range: float = 2.0) -> float:
    """PSNR over [-1, 1] images or videos."""
    mse = frame_mse(a, b)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _video(video) -> torch.Tensor:
    v = _f32(video)
    return v[None] if v.ndim == 4 else v


def temporal_consistency(video) -> float:
    """Mean cosine similarity of consecutive frames of [C, T, H, W] or
    [B, C, T, H, W]: a proxy of the VBench clip_temp axis without a CLIP
    model."""
    v = _video(video)
    f = v.permute(0, 2, 1, 3, 4).reshape(v.shape[0], v.shape[2], -1)
    a, b = f[:, :-1], f[:, 1:]
    num = (a * b).sum(-1)
    den = a.norm(dim=-1) * b.norm(dim=-1) + 1e-8
    return float((num / den).mean())


def motion_magnitude(video) -> float:
    """Mean absolute inter-frame difference: a proxy of the flow score
    (the reference's needs an optical-flow model)."""
    v = _video(video)
    return float((v[:, :, 1:] - v[:, :, :-1]).abs().mean())


def make_sensitivity_metric(name: str, prompts: Optional[List[str]] = None,
                            clip_model_path: Optional[str] = None):
    """metric_fn(out, fp_reference) -> float, higher = more sensitive:
    'mse' frame MSE against the fp generation; 'clip_temp' the drop in
    temporal consistency; 'flow' |motion(out) - motion(fp)|. 'clip'
    raises NotImplementedError (no CLIP weights)."""
    if name == "mse":
        return frame_mse
    if name == "flow":
        def flow_degradation(out, ref) -> float:
            return abs(motion_magnitude(out) - motion_magnitude(ref))
        return flow_degradation
    if name == "clip_temp":
        def tempcons_degradation(out, ref) -> float:
            return temporal_consistency(ref) - temporal_consistency(out)
        return tempcons_degradation
    if name == "clip":
        raise NotImplementedError(
            "the 'clip' sensitivity metric needs CLIP weights and "
            "transformers, which the port does not have (ROADMAP queue 5)")
    raise ValueError(f"unknown sensitivity metric {name!r} "
                     "(expected 'mse', 'clip', 'clip_temp' or 'flow')")
