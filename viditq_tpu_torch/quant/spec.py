"""Quantization specifications (static config objects).

The port's own copy of `viditq_tpu/quant/spec.py` (pure Python; importing
the JAX package's copy would import jax through `viditq_tpu.quant`). A
frozen dataclass describes *what* to quantize; the calibrated tables live
as buffers on the port's `QuantLinear` modules. Field names and defaults
are identical to the JAX package's, so a plan resolves to equal specs in
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Granularity of the quantization groups.
#   "tensor"  - one (delta, zero_point) for the whole array
#   "channel" - one per output channel (reduce over every axis except
#               `channel_axis`; reference `per_group='channel'` with
#               channel_dim=0 on a [C_out, C_in] torch weight == axis=-1 on a
#               JAX [C_in, C_out] kernel)
#   "token"   - one per token row (reduce over every axis except -2; the
#               reference reshapes activations to [B, N_token, C] first,
#               `base_quantizer.py:177-185`)
GRANULARITIES = ("tensor", "channel", "token")

SCALE_METHODS = ("min_max", "grid_search_lp")

ROUND_MODES = ("nearest", "nearest_ste", "stochastic", "learned_hard_sigmoid")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a single quantizer.

    Mirrors the reference config keys (`base_quantizer.py:29-59`) as a
    frozen, hashable value.
    """

    n_bits: int = 8
    granularity: str = "tensor"          # reference `per_group` (False/'channel'/'token')
    channel_axis: int = -1               # reference `channel_dim` (on JAX layout)
    scale_method: str = "min_max"
    round_mode: str = "nearest_ste"
    sym: bool = False
    always_zero: bool = False            # x_min pinned at 0 (softmax quant)
    dynamic: bool = False                # recompute qparams online per call
    running_stat: bool = False           # momentum-accumulate min/max during calib
    momentum: float = 0.95               # reference hardcodes 0.95 (base_quantizer.py:47)
    # Mixed precision: tuple of candidate bitwidths. When set, calibrated
    # tables carry a leading [n_bitwidth] axis and `bit_idx` selects at run
    # time (reference `mixed_precision` + `bit_idx`, base_quantizer.py:32-36).
    mixed_precision: Optional[Tuple[int, ...]] = None
    # Timestep-wise static act tables: the number of calibrated timestep
    # slots (the calibration step count under `timestep_wise`, else 1);
    # `QuantCtx.act_slot` selects one.
    timestep_wise: bool = False
    n_timestep: int = 1
    # Timerange-gathered mixed precision: weight bits per smooth-quant
    # timerange (each timerange's slab packs at its own bits; the layer
    # then holds per-timerange dequant tables, `QuantLinear.w_mp_scale`).
    mp_bits: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"granularity must be one of {GRANULARITIES}")
        if self.scale_method not in SCALE_METHODS:
            raise ValueError(f"scale_method must be one of {SCALE_METHODS}")
        if self.round_mode not in ROUND_MODES:
            raise ValueError(f"round_mode must be one of {ROUND_MODES}")
        if not (2 <= self.n_bits <= 16):
            raise ValueError("bitwidth not supported")
        if self.mixed_precision is not None and self.n_bits not in self.mixed_precision:
            raise ValueError("n_bits must be a member of mixed_precision")
        if self.mp_bits is not None:
            bad = [b for b in self.mp_bits if b not in self.bits_tuple]
            if bad:
                raise ValueError(
                    f"mp_bits {self.mp_bits}: bits {bad} not among the "
                    f"calibrated bitwidths {self.bits_tuple}")

    @property
    def n_bitwidth(self) -> int:
        return len(self.mixed_precision) if self.mixed_precision else 1

    @property
    def bit_idx(self) -> int:
        """Index of the active bitwidth in the table (base_quantizer.py:34)."""
        if self.mixed_precision is None:
            return 0
        return self.mixed_precision.index(self.n_bits)

    @property
    def bits_tuple(self) -> Tuple[int, ...]:
        return tuple(self.mixed_precision) if self.mixed_precision else (self.n_bits,)

    def n_levels(self, n_bits: Optional[int] = None) -> int:
        """Quantization level count, reference semantics (base_quantizer.py:131).

        Asymmetric: 2**b levels in [0, 2**b - 1].
        Symmetric: the reference sets n_levels = 2**(b-1) - 1 and clamps the
        integer code to [-n_levels - 1, n_levels], i.e. [-2**(b-1), 2**(b-1)-1].
        """
        b = self.n_bits if n_bits is None else n_bits
        return 2 ** b if not self.sym else 2 ** (b - 1) - 1

    def with_bits(self, n_bits: int) -> "QuantSpec":
        """Reference `bitwidth_refactor` (base_quantizer.py:319-325; JAX
        spec.py:112-125). A static quantizer's calibrated tables carry
        entries only for `bits_tuple`, so an uncalibrated bitwidth is
        refused; a dynamic quantizer computes its qparams online and
        switches freely."""
        if not self.dynamic and n_bits not in self.bits_tuple:
            raise ValueError(
                f"with_bits({n_bits}): not among calibrated bitwidths "
                f"{self.bits_tuple}; set mixed_precision to calibrate "
                f"multi-bit tables first")
        return dataclasses.replace(self, n_bits=n_bits)


@dataclasses.dataclass(frozen=True)
class SmoothQuantSpec:
    """Channel-balancing ("smooth quant", CB) config (reference
    `qdiff/models/quant_layer.py:79-97`): per input channel k a balancing
    scale cs[k] = a_max[k]^alpha / w_max[k]^(1-alpha) divides the layer's
    input and multiplies its weight rows, one cs per timerange of the
    diffusion schedule. The momentum types ('momentum_act_max': a_max is a
    momentum average of the per-channel input maxima over calibration
    forwards) run on every backend; the 'dynamic' type (a_max of the live
    input, every forward) only on the simulate backend."""

    enable: bool = False
    channel_wise_scale_type: str = "momentum_act_max"
    momentum: float = 0.95
    # One alpha per timerange (scalar broadcast if a single value given).
    alpha: Tuple[float, ...] = (0.5,)
    # Inclusive [start, end] diffusion-timestep ranges that must tile [0,1000]
    # (reference asserts contiguity, quant_layer.py:85-89).
    timerange: Tuple[Tuple[int, int], ...] = ((0, 1000,),)
    # True: every timerange quantizes its weights with timerange 0's tables,
    # as the reference's runtime does.
    frozen_tr0_weights: bool = True
    # One balancing scale shared by the sibling q/k/v projections.
    qkv_share_cs: bool = False

    def __post_init__(self):
        if not self.enable:
            return
        prev = -1
        for lo, hi in self.timerange:
            if lo != prev + 1:
                raise ValueError("smooth-quant timeranges must be contiguous")
            prev = hi
        if prev != 1000:
            raise ValueError("smooth-quant timeranges must cover [0, 1000]")

    @property
    def n_timerange(self) -> int:
        return len(self.timerange)

    def alpha_for_range(self, idx: int) -> float:
        if len(self.alpha) == 1:
            return self.alpha[0]
        return self.alpha[idx]


@dataclasses.dataclass(frozen=True)
class LayerQuantSpec:
    """Per-layer bundle: weight spec + act spec + smooth quant + flags.

    Replaces the reference's `QuantLayer` wrapper state
    (`qdiff/models/quant_layer.py:22-97`).
    """

    weight: Optional[QuantSpec] = QuantSpec(
        n_bits=8, granularity="channel", round_mode="nearest")
    act: Optional[QuantSpec] = QuantSpec(
        n_bits=8, granularity="token", round_mode="nearest_ste", dynamic=True)
    smooth_quant: SmoothQuantSpec = SmoothQuantSpec()
    weight_quant: bool = True            # reference set_quant_state(weight_quant, ...)
    act_quant: bool = True
    # 'simulate' = fake quant (the reference's semantics); 'native' = real
    # int8 execution (per-row act scales, prepacked weights), or int8-stored
    # weights dequantized into a dense product where act_quant is off.
    backend: str = "simulate"
    # Native execution implementation: 'fused' = the producer/consumer int8
    # kernel dataflow (kernels/fused_matmul.py); any other impl runs the
    # K7a -> K7b dataflow (kernels/int_matmul.py).
    impl: Optional[str] = None
    # Optional attention-internal quantizers (reference quant_block.py:
    # 181-236): post-projection q/k/v (attn_act) and the softmax output.
    attn_act: Optional[QuantSpec] = None
    softmax: Optional[QuantSpec] = None
    # Token layout for token-wise act quantization (unused by the resolver:
    # the models set `QuantLinear.token_layout` per call site).
    token_layout: Optional[str] = None
    # q-diffusion channel split (reference quant_layer.py:72,159-172):
    # input channels [:split] and [split:] quantized as separate groups, on
    # the simulate backend; 0 = off; exclusive with smooth quant.
    split: int = 0

    def __post_init__(self):
        if self.split > 0 and self.smooth_quant.enable:
            raise ValueError(
                "q-diffusion channel split cannot be combined with "
                "smooth-quant channel balancing: the split branch quantizes "
                "the raw kernel without the balancing rescale")

    def disabled(self) -> "LayerQuantSpec":
        return dataclasses.replace(self, weight_quant=False, act_quant=False)
