"""Quantizer math: min-max qparams (port of `viditq_tpu/quant/core.py`).

Group-wise min/max with the reference's sign clamps, the momentum blend
of static act ranges, the 'min_max' scale init (reference
`qdiff/quantizer/base_quantizer.py:168-228`), the shape of one group's
table slice, fake quant with nearest rounding (the forward of
'nearest_ste' too: the port has no training path, so no straight-through
gradient), static or dynamic, and the channel-balancing scale. Same
formulas, same float32 arithmetic order as the JAX package. The
'grid_search_lp' scale method and the 'stochastic' and AdaRound
('learned_hard_sigmoid') roundings raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from viditq_tpu_torch.kernels._common import divc
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


def update_running_minmax(state: Optional[Tuple[torch.Tensor, torch.Tensor]],
                          x_min: torch.Tensor, x_max: torch.Tensor,
                          momentum: float, initialized: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Momentum accumulation of act ranges (base_quantizer.py:196-207; JAX
    core.py:92-110): the first observation is stored as it is, later ones
    blended as old * momentum + new * (1 - momentum)."""
    if state is None or not initialized:
        return x_min, x_max
    old_min, old_max = state
    return (old_min * momentum + x_min * (1.0 - momentum),
            old_max * momentum + x_max * (1.0 - momentum))


def group_shape_of(x_shape: Tuple[int, ...], spec: QuantSpec
                   ) -> Tuple[int, ...]:
    """Broadcastable shape of one (delta, zero_point) group slice of an
    array of shape x_shape (JAX core.py:353-363)."""
    if spec.granularity == "tensor":
        return (1,) * len(x_shape)
    if spec.granularity == "channel":
        keep = spec.channel_axis % len(x_shape)
        return tuple(n if a == keep else 1 for a, n in enumerate(x_shape))
    if spec.granularity == "token":
        keep = len(x_shape) - 2
        return tuple(n if a == keep else 1 for a, n in enumerate(x_shape))
    raise ValueError(spec.granularity)


def qparams_minmax(x_min: torch.Tensor, x_max: torch.Tensor,
                   spec: QuantSpec, n_bits: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """'min_max' scale init (base_quantizer.py:213-228). The divisions by
    the level count are true divisions on every device (`divc`: on CUDA,
    `tensor / c` multiplies by 1 / c)."""
    n_levels = spec.n_levels(n_bits)
    if spec.sym:
        absmax = torch.maximum(x_min.abs(), x_max.abs())
        delta = divc(absmax, float(n_levels))
    else:
        delta = divc(x_max - x_min, float(n_levels - 1))
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
                       alpha) -> torch.Tensor:
    """Per-channel channel-balancing scale cs = a_max^alpha /
    w_max^(1-alpha) (quant_layer.py:108-140; JAX `core.py:366-378`), with
    the reference's clamps: act 1e-5 (quant_layer.py:130-134), weight
    1e-12. The one definition calibration, packing and the forward use.
    alpha: a Python float (1 - alpha then taken in double, as JAX takes a
    weakly typed constant) or a float32 tensor (1 - alpha in float32). Each
    power is taken in float64 and rounded to float32: PyTorch's float32 pow
    is an ulp off the rounded result at ~2% of entries, XLA's at ~0.02%."""
    a = torch.clamp(a_absmax.float(), min=1e-5)
    w = torch.clamp(w_absmax.float(), min=1e-12)

    def power(base, e):
        e = torch.as_tensor(e, dtype=torch.float32, device=base.device)
        return (base.double() ** e.double()).float()
    return power(a, alpha) / power(w, 1 - alpha)
