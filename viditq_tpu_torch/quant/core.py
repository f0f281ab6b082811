"""Quantizer math: min-max qparams (port of `viditq_tpu/quant/core.py`).

Only what the weight tables of an inference plan need: group-wise min/max
with the reference's sign clamps and the 'min_max' scale init
(reference `qdiff/quantizer/base_quantizer.py:168-228`). Same formulas,
same float32 arithmetic order as the JAX package, so the tables are equal
bit for bit on equal inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from viditq_tpu_torch.quant.spec import QuantSpec

EPS_DELTA = 1e-6      # base_quantizer.py:220


def _reduce_dims(ndim: int, spec: QuantSpec) -> Tuple[int, ...]:
    if spec.granularity == "tensor":
        return tuple(range(ndim))
    if spec.granularity == "channel":
        keep = spec.channel_axis % ndim
        return tuple(a for a in range(ndim) if a != keep)
    if spec.granularity == "token":
        if ndim < 2:
            raise ValueError("token granularity needs >=2 dims")
        keep = ndim - 2
        return tuple(a for a in range(ndim) if a != keep)
    raise ValueError(spec.granularity)


def minmax(x: torch.Tensor, spec: QuantSpec
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise (min, max), x_min <= 0 <= x_max, keepdims
    (base_quantizer.py:168-194)."""
    dims = _reduce_dims(x.ndim, spec)
    x = x.float()
    x_min = torch.clamp(torch.amin(x, dim=dims, keepdim=True), max=0.0)
    x_max = torch.clamp(torch.amax(x, dim=dims, keepdim=True), min=0.0)
    return x_min, x_max


def qparams_minmax(x_min: torch.Tensor, x_max: torch.Tensor,
                   spec: QuantSpec, n_bits: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """'min_max' scale init (base_quantizer.py:213-228)."""
    n_levels = spec.n_levels(n_bits)
    if spec.sym:
        absmax = torch.maximum(x_min.abs(), x_max.abs())
        delta = absmax / n_levels
    else:
        delta = (x_max - x_min) / (n_levels - 1)
    delta = torch.clamp(delta, min=EPS_DELTA)
    if spec.always_zero or spec.sym:
        zero_point = torch.zeros_like(delta)
    else:
        zero_point = torch.round(-x_min / delta)
    return delta, zero_point


def compute_qparams(x: torch.Tensor, spec: QuantSpec,
                    n_bits: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibrate one (delta, zero_point) slice from data ('min_max' only;
    the grid search is not ported)."""
    if spec.scale_method != "min_max":
        raise NotImplementedError(
            f"scale_method {spec.scale_method!r} is not ported")
    x_min, x_max = minmax(x, spec)
    return qparams_minmax(x_min, x_max, spec, n_bits)
