"""Quantizer math (port of `viditq_tpu/quant/core.py`).

Group-wise min/max with the reference's sign clamps, the momentum blend
of static act ranges, the 'min_max' and 'grid_search_lp' scale inits
(reference `qdiff/quantizer/base_quantizer.py:168-249`), the shape of one
group's table slice, fake quant, static or dynamic, in every rounding mode
of the reference (`_int_code`: 'nearest'; 'nearest_ste', the same forward
with the straight-through gradient of `round_ste`; 'stochastic', floor
plus a Bernoulli draw of the rest; AdaRound's 'learned_hard_sigmoid',
floor plus the soft target h(alpha) under reconstruction or alpha >= 0 at
inference), AdaRound's alpha init and soft targets, and the
channel-balancing scale. Same formulas, same float32 arithmetic order as
the JAX package. Under `pooled_over(group)` (batch-sharded sampling) a
dynamic act statistic that pools a view's batch rows takes every rank's
rows, as GSPMD computes it on JAX's global batch. Stochastic rounding
draws its uniforms from an explicit `torch.Generator` in place of JAX's
threefry key, so it matches JAX in distribution, not draw for draw; a
rest of exactly 0 or 1 rounds the same.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from viditq_tpu_torch.kernels._common import divc, rdiv
from viditq_tpu_torch.quant.spec import QuantSpec

EPS_DELTA = 1e-6      # base_quantizer.py:220
EPS_GRID = 1e-4       # base_quantizer.py:302
EPS_ZP = 1e-5         # base_quantizer.py:232
# AdaRound's stretched sigmoid (base_quantizer.py:91-110)
ADAROUND_GAMMA = -0.1
ADAROUND_ZETA = 1.1
# the process group whose ranks hold the other rows of the batch
_POOL: contextvars.ContextVar = contextvars.ContextVar("pool", default=None)


@contextlib.contextmanager
def pooled_over(group):
    """Within it, `fake_quant_dynamic` pools its statistics over the batch
    rows of every rank of `group` (None: this rank's rows alone)."""
    token = _POOL.set(group)
    try:
        yield
    finally:
        _POOL.reset(token)


def pool_group():
    """The group of the innermost `pooled_over`, or None."""
    return _POOL.get()


def clip(x: torch.Tensor, lo: Optional[float] = None,
         hi: Optional[float] = None) -> torch.Tensor:
    """torch.clamp(x, lo, hi) with JAX's gradient where one is taken:
    `jnp.clip`, `jnp.maximum` and `jnp.minimum` pass half the gradient
    where a value sits on a bound, `torch.clamp` all of it
    (torch.maximum/minimum split ties as JAX's do). The forward is
    clamp's."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.clamp(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, torch.full((), lo, dtype=x.dtype,
                                        device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.full((), hi, dtype=x.dtype,
                                        device=x.device))
    return x


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


def minmax(x: torch.Tensor, spec: QuantSpec, group=None, batch_axis: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise (min, max), x_min <= 0 <= x_max, keepdims
    (base_quantizer.py:168-194). With a group, a reduction over the batch
    rows (axis batch_axis of x) spans every rank's rows: one all-reduce
    max of (-min, max)."""
    dims = _reduce_dims(x.ndim, spec)
    x = x.float()
    x_min = clip(torch.amin(x, dim=dims, keepdim=True), hi=0.0)
    x_max = clip(torch.amax(x, dim=dims, keepdim=True), lo=0.0)
    if group is not None and batch_axis % x.ndim in dims:
        from viditq_tpu_torch.parallel.comm import all_reduce_
        both = all_reduce_(torch.stack([-x_min, x_max]), group,
                           dist.ReduceOp.MAX)
        x_min, x_max = -both[0], both[1]
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
    delta = clip(delta, lo=EPS_DELTA)
    if spec.always_zero or spec.sym:
        zero_point = torch.zeros_like(delta)
    else:
        zero_point = torch.round(-x_min / delta)
    return delta, zero_point


def _quantize_with_range(x, x_max, x_min, n_bits: int, n_levels: int,
                         always_zero: bool):
    """The grid search's inner quantize (base_quantizer.py:292-316; JAX
    core.py:131-145), x and one candidate's range."""
    if always_zero:
        delta = divc(x_max, float(2 ** n_bits - 1))
        zero_point = torch.zeros_like(delta)
    else:
        delta = divc(x_max - x_min, float(2 ** n_bits - 1))
        zero_point = torch.round(-x_min / (delta + EPS_ZP))
    x_int = torch.round(x / (delta + EPS_GRID))
    x_quant = clip(x_int + zero_point, 0, n_levels - 1)
    return (x_quant - zero_point) * delta


def qparams_grid_search(x: torch.Tensor, x_min: torch.Tensor,
                        x_max: torch.Tensor, spec: QuantSpec,
                        n_bits: Optional[int] = None, n_steps: int = 100,
                        group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """'grid_search_lp' scale init (base_quantizer.py:230-249; JAX
    core.py:148-187): the range (x_min, x_max) shrunk by s in {0, 1/n, ...,
    (n-1)/n}, each candidate fake-quantized, and the one candidate of least
    L2 loss over the whole tensor (the reference's single global argmin;
    the first of equal losses) gives every group its tables. One candidate
    is in flight at a time, as JAX's `lax.map` keeps it. With a group the
    losses are summed over its ranks' rows too."""
    b = spec.n_bits if n_bits is None else n_bits
    n_levels = spec.n_levels(n_bits)
    x = x.float()
    scalings = (torch.arange(n_steps, dtype=torch.float32, device=x.device)
                / n_steps)
    losses = torch.stack([
        torch.sum((x - _quantize_with_range(x, x_max * s, x_min * s, b,
                                            n_levels, spec.always_zero))
                  ** 2) for s in scalings])
    if group is not None:
        from viditq_tpu_torch.parallel.comm import all_reduce_
        all_reduce_(losses, group)
    s_best = scalings[torch.argmin(losses)]
    best_max, best_min = x_max * s_best, x_min * s_best
    if spec.always_zero:
        delta = divc(best_max, float(2 ** b - 1))
        zero_point = torch.zeros_like(delta)
    else:
        delta = divc(best_max - best_min, float(2 ** b - 1))
        zero_point = torch.round(-best_min / (delta + EPS_ZP))
    return delta, zero_point


def compute_qparams(x: torch.Tensor, spec: QuantSpec,
                    n_bits: Optional[int] = None, group=None,
                    batch_axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibrate one (delta, zero_point) slice from data by the spec's
    scale method (JAX core.py:190-203); a group pools the batch rows of
    its ranks (`minmax`)."""
    x_min, x_max = minmax(x, spec, group, batch_axis)
    if spec.scale_method == "min_max":
        return qparams_minmax(x_min, x_max, spec, n_bits)
    if spec.scale_method == "grid_search_lp":
        return qparams_grid_search(x, x_min, x_max, spec, n_bits,
                                   group=group)
    raise NotImplementedError(spec.scale_method)


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Straight-through rounding (base_quantizer.py:361-365): round(x) in
    the forward, the identity's gradient in the backward. JAX's `x +
    stop_gradient(round(x) - x)` equals round(x) bit for bit (round(x) - x
    is exact, and so is the sum), so where no gradient is taken the
    forward is round(x) alone, without the two extra passes."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return torch.round(x)
    return x + (torch.round(x) - x).detach()


def adaround_soft_targets(alpha: torch.Tensor) -> torch.Tensor:
    """h(alpha) = clip(sigmoid(alpha) * (zeta - gamma) + gamma, 0, 1)
    (base_quantizer.py:108-110)."""
    return clip(torch.sigmoid(alpha) * (ADAROUND_ZETA - ADAROUND_GAMMA)
                + ADAROUND_GAMMA, 0, 1)


def adaround_init_alpha(x: torch.Tensor, delta: torch.Tensor
                        ) -> torch.Tensor:
    """AdaRound's alpha with h(alpha) equal to the rounding rest of x /
    delta, clipped to [1e-4, 1 - 1e-4] (base_quantizer.py:255-264). The
    constant over the rest is a true division, as JAX's; the log is
    PyTorch's, an ulp from XLA's at a few percent of entries."""
    rest = x / delta - torch.floor(x / delta)
    rest = torch.clamp(rest, 1e-4, 1 - 1e-4)
    return -torch.log(rdiv(ADAROUND_ZETA - ADAROUND_GAMMA,
                           rest - ADAROUND_GAMMA) - 1.0)


def _int_code(x: torch.Tensor, delta: torch.Tensor, spec: QuantSpec, *,
              generator: Optional[torch.Generator] = None,
              alpha: Optional[torch.Tensor] = None,
              soft_targets: bool = True) -> torch.Tensor:
    """x / delta rounded by the spec's mode, unclamped (JAX core.py:
    211-237)."""
    scaled = x / delta
    mode = spec.round_mode
    if mode == "nearest":
        return torch.round(scaled)
    if mode == "nearest_ste":
        return round_ste(scaled)
    if mode == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding needs a generator")
        floor = torch.floor(scaled)
        rest = scaled - floor
        u = torch.rand(scaled.shape, generator=generator,
                       device=scaled.device, dtype=scaled.dtype)
        return floor + (u < rest).to(scaled.dtype)
    if mode == "learned_hard_sigmoid":
        if alpha is None:
            raise ValueError("learned_hard_sigmoid needs alpha")
        floor = torch.floor(scaled)
        if soft_targets:
            return floor + adaround_soft_targets(alpha)
        return floor + (alpha >= 0).to(scaled.dtype)
    raise ValueError(f"Wrong rounding mode {mode}")


def fake_quant(x: torch.Tensor, delta: torch.Tensor,
               zero_point: torch.Tensor, spec: QuantSpec,
               n_bits: Optional[int] = None, *,
               generator: Optional[torch.Generator] = None,
               alpha: Optional[torch.Tensor] = None,
               soft_targets: bool = True) -> torch.Tensor:
    """Quantize-dequantize with given parameters, in float32, returned in
    x's dtype (core.py:260-280), rounded by the spec's mode (`_int_code`:
    the generator of stochastic rounding, AdaRound's alpha and whether its
    targets are soft)."""
    n_levels = spec.n_levels(n_bits)
    delta = delta.float()
    zero_point = zero_point.float()
    x_int = _int_code(x.float(), delta, spec, generator=generator,
                      alpha=alpha, soft_targets=soft_targets) + zero_point
    if spec.sym:
        x_quant = clip(x_int, -n_levels - 1, n_levels)
    else:
        x_quant = clip(x_int, 0, n_levels - 1)
    return ((x_quant - zero_point) * delta).to(x.dtype)


def fake_quant_dynamic(x: torch.Tensor, spec: QuantSpec, *,
                       generator: Optional[torch.Generator] = None,
                       batch_axis: int = 0) -> torch.Tensor:
    """Calibrate from the live tensor, then fake-quant (core.py:283-291).
    batch_axis: the axis of x that holds the batch rows, which
    `pooled_over` pools across ranks."""
    delta, zero_point = compute_qparams(x, spec, group=pool_group(),
                                        batch_axis=batch_axis)
    return fake_quant(x, delta, zero_point, spec, generator=generator)


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
