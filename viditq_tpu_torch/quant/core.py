"""Quantizer math: min-max qparams (port of `viditq_tpu/quant/core.py`).

What the weight tables of an inference plan and the simulate-semantics
PixArt-Σ `sr` conv need: group-wise min/max with the reference's sign
clamps, the 'min_max' scale init (reference
`qdiff/quantizer/base_quantizer.py:168-228`), fake quant with
nearest rounding, static or dynamic, and the channel-balancing scale. Same formulas,
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


def fake_quant(x: torch.Tensor, delta: torch.Tensor,
               zero_point: torch.Tensor, spec: QuantSpec,
               n_bits: Optional[int] = None) -> torch.Tensor:
    """Quantize-dequantize with given parameters, in float32, returned in
    x's dtype (core.py:260-280). Rounding 'nearest' and 'nearest_ste' (the
    same forward; the port has no training path); code x / delta as a
    division."""
    if spec.round_mode not in ("nearest", "nearest_ste"):
        raise NotImplementedError(
            f"round_mode {spec.round_mode!r} is not ported")
    n_levels = spec.n_levels(n_bits)
    delta = delta.float()
    zero_point = zero_point.float()
    x_int = torch.round(x.float() / delta) + zero_point
    if spec.sym:
        x_quant = torch.clamp(x_int, -n_levels - 1, n_levels)
    else:
        x_quant = torch.clamp(x_int, 0, n_levels - 1)
    return ((x_quant - zero_point) * delta).to(x.dtype)


def fake_quant_dynamic(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Calibrate from the live tensor, then fake-quant (core.py:283-291)."""
    delta, zero_point = compute_qparams(x, spec)
    return fake_quant(x, delta, zero_point, spec)


def smooth_quant_scale(a_absmax: torch.Tensor, w_absmax: torch.Tensor,
                       alpha: float) -> torch.Tensor:
    """Per-channel channel-balancing scale cs = a_max^alpha /
    w_max^(1-alpha) (quant_layer.py:108-140; JAX `core.py:366-378`), with
    the reference's clamps: act 1e-5 (quant_layer.py:130-134), weight
    1e-12. The one definition calibration, packing and the forward use."""
    a = torch.clamp(a_absmax.float(), min=1e-5)
    w = torch.clamp(w_absmax.float(), min=1e-12)
    return (a ** alpha) / (w ** (1 - alpha))
