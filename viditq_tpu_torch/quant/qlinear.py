"""Quantization-aware linear layer (port of `viditq_tpu/quant/qlinear.py`).

`QuantLinear` holds its fp kernel in the JAX layout [K, N] and, for a layer
the plan quantizes, the calibrated tables as buffers: `w_delta`/`w_zp`
[n_bitwidth, n_timerange, 1, N] where the weights are quantized, and on
the native backend the packed `w_int` [n_timerange, K, N] int8 slabs with
`w_colsum` [n_timerange, 1, N] (qlinear.py:412-421, 584-591). `w_int` is
stored K-major ([n_timerange, N, K] in memory), the layout the int8 GEMM
kernels read; a weight-only layer with asym 4-bit weights packs two
unsigned codes a byte ([n_timerange, (K+1)//2, N], qlinear.py:406-418).
`w_zp_int` [n_timerange, N], not saved, is the zero point of the `w_int`
codes as the epilogues take them; the packing and `load_state_dict`
write it beside the slabs.

Static acts (qlinear.py:460-478): `a_delta`/`a_zp` [n_bitwidth,
n_timestep, 1, *group] and the calibration state `a_min`/`a_max`
[n_timestep, 1, *group], `a_init` [n_timestep]; the group shape is that
of the input's token view (one entry a tensor, or one a token position),
set by the first 'a_calib' forward or by a load. `QuantCtx.act_slot`
selects the timestep slot, clamped to the table as JAX's dynamic index
clamps it.

Token views (qlinear.py:214-241): token-wise act scales are pooled per
token position over batch x channels, on the view `token_layout` names:
'spatial' ([(B T), S, C] seen as [B, T*S, C]), 'temporal' ([(B S), T, C]
as [B, S*T, C]) or 'cross_kv' (dynamic acts on the packed [1, B*P, C],
static tables on the dense prompts [B, P, C] as they come); None takes the
input as it is.

Channel balancing (smooth quant, "CB"; qlinear.py:113-168, 497-591): a
layer whose spec enables it also holds `act_scale` [n_timerange, K] (the
momentum act maxima of the calibration forwards) and, for the momentum
scale types, `cb_scale` [n_timerange, K], the balancing scale cs made from
them, with one int8 slab per timerange of the weight times cs. The
timerange comes from `QuantCtx.t_id` (a Python int, so no device sync). A
forward divides its input by cs, folded where the JAX package folds it:
into K5's quantize (`col_scale` = 1/cs), or into the producer of a
prequant input (K1's adaLN vectors, K4, the attention's emission, K2's
emission), whose parent reads this layer's 1/cs through `inv_balance`;
otherwise a true f32 division. The weight tables of every timerange are
timerange 0's under `frozen_tr0_weights`. The 'dynamic' scale type
computes cs on every forward from the live input's maxima and the
kernel's (simulate backend only; ValueError on native, as in JAX).

Timerange-gathered mixed precision (qlinear.py:423-440, 575-582): a
native layer whose weight spec carries `mp_bits` (one bitwidth per
timerange, from `pipelines/mixed_precision.py`'s union of the CB
timeranges and the MP step ranges) packs each timerange's slab at its own
bits and holds saved per-timerange dequant tables `w_mp_scale` and
`w_mp_zp` [n_timerange, 1, N] (the zero point with the signed shift of
its bits folded in, 0 for sym weights). `_quant` reads those for the
call's timerange in place of the `w_delta`/`w_zp_int` pair; every table
is a view `[tr]` of the stored one, so no forward copies a slab.

Modes (`QuantCtx.mode`):
  * fp (no spec, nothing quantized and no CB, `qctx is None` or mode
    'fp'): `x @ kernel + bias` in the model dtype;
  * sq_stat: the fp output, and the input's per-channel act maxima blended
    into `act_scale` of the call's timerange (momentum CB types; the
    reference stat view: `seg_len` / `stat_layout`);
  * a_calib: the simulate path, its static act ranges blended into
    `a_min`/`a_max` of the slot (with the spec's momentum under
    `running_stat`, else the last forward's) and the act quantized with
    them (qlinear.py:790-808);
  * quant: by the layer's `path` (`layer_path`):
    - 'native' (dynamic int8 acts): impl 'fused' runs the fused kernels —
      with a `Prequant` input from a producer kernel, the int8 consumer
      matmul (K2, optionally emitting int8 for the next layer when sym x
      sym); otherwise the quantize-in matmul (K5); a residual (+ gate)
      `epilogue` runs inside either (`_epilogue_fusable`). Any other impl:
      with a `Prequant` input from `shared_prequant` (K7a), the int8
      matmul with the zero-point-corrected epilogue (K7b); otherwise
      `quantized_linear_native` (K7a then K7b);
    - 'native_static' (static acts, <= 8 bits; qlinear.py:645-727): the
      codes made elementwise from the calibrated slot (the reciprocal of
      its scale multiplied in, C6), in plain PyTorch as JAX makes them in
      XLA, then K2 under impl 'fused', else K7b;
    - 'weight_only' (qlinear.py:729-763): the slab dequantized into the
      model dtype, then the dense product;
    - 'simulate' (qlinear.py:784-846): fake quant in float32 — the act
      dynamic on its token view or from the static slot's tables, the
      weight (times cs under CB) from the timerange's tables, or from
      tables made on the fly under the 'dynamic' CB type — then the dense
      product of the dequantized values (an fp-listed layer under CB runs
      `(x / cs) @ (kernel * cs)` this way, quant_layer.py:188-189); a
      q-diffusion `split` layer quantizes input channels [:split] and
      [split:] as two groups, acts dynamic (qlinear.py:765-782).

An `epilogue` (residual, gate) the kernels do not take is applied after
the layer with the JAX package's bf16 roundings (`apply_epilogue`). The
'stochastic' and AdaRound roundings and the grid-search scale method
raise NotImplementedError at construction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.kernels._common import rdiv
from viditq_tpu_torch.kernels.fused_matmul import (fused_dynq_int8_matmul,
                                                   int8_consumer_matmul,
                                                   quantize_rows)
from viditq_tpu_torch.kernels.int_matmul import (dynamic_quant_rows,
                                                 int8_matmul,
                                                 quantized_linear_native)
from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant.spec import (LayerQuantSpec, QuantSpec,
                                         SmoothQuantSpec)

# 'sq_stat': the smooth-quant act-statistic pass (reference ptq.py:
# 219-264); 'a_calib': the static act-range pass (ptq.py:296-361)
MODES = ("fp", "sq_stat", "a_calib", "quant")
# the static-act calibration tables, shaped by the input's token view
ACT_TABLES = ("a_delta", "a_zp", "a_min", "a_max")


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """Per-call quantization context (qlinear.py:47-76): the diffusion
    timestep (it selects the CB timerange), the static act-table slot and
    the execution mode. Both indices are Python ints, so reading them
    forces no device sync. The capture mode and the rounding rng are not
    ported."""

    t_id: int = 0
    mode: str = "quant"
    act_slot: int = 0

    def __post_init__(self):
        if self.mode not in MODES:
            raise NotImplementedError(f"QuantCtx mode {self.mode!r}")


class Prequant(NamedTuple):
    """An input quantized once by a producer kernel: int8 codes [M, K] and
    float32 scales, one per row ([M, 1]) or, from K2's emission, one per
    row and k-group ([M, G], group_wise=True); with asym codes the per-row
    zero points, and the per-row code sums where a consumer needs them
    (asym acts or asym weights), [M, 1] f32, else None. The field order
    is the producers' return order (K1, K4, K7a, the attention emission)."""

    codes: torch.Tensor
    scale: torch.Tensor
    zp: Optional[torch.Tensor] = None
    rowsum: Optional[torch.Tensor] = None
    group_wise: bool = False


def is_native_dynamic(lspec: Optional[LayerQuantSpec]) -> bool:
    """The native dynamic-act int8 backend, any impl (qlinear.py:387-388)."""
    return (lspec is not None and lspec.backend == "native"
            and lspec.act is not None and lspec.act.dynamic
            and lspec.act_quant and lspec.weight is not None
            and lspec.weight_quant)


def is_fused_dynamic(lspec: Optional[LayerQuantSpec]) -> bool:
    """The fused-native dynamic-act dataflow (impl 'fused')."""
    return is_native_dynamic(lspec) and lspec.impl == "fused"


@functools.lru_cache(maxsize=None)
def timerange_lookup(smooth: SmoothQuantSpec) -> np.ndarray:
    """[1001] map: diffusion timestep -> timerange index (qlinear.py:
    159-168; the reference's `find_interval`, quant_layer.py:15-19)."""
    table = np.zeros(1001, np.int32)
    for i, (lo, hi) in enumerate(smooth.timerange):
        table[lo:hi + 1] = i
    return table


def timerange_of(smooth: SmoothQuantSpec, t_id: int) -> int:
    """The timerange of diffusion timestep t_id, clipped to [0, 1000]
    (`resolve_tr_id`, qlinear.py:148-156)."""
    return int(timerange_lookup(smooth)[min(max(int(t_id), 0), 1000)])


def abs_max_per_channel(x: torch.Tensor) -> torch.Tensor:
    """Mean over the leading dims of (max |x| over the token axis) -> [C]
    (qlinear.py:171-178; reference `input.abs().max(dim=-2)[0].mean(0)`,
    quant_layer.py:117,120)."""
    m = x.float().abs().amax(dim=-2)
    return m.reshape(-1, m.shape[-1]).mean(dim=0)


def divide_cols(x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """x / cs per input channel as a true f32 division, cast back to x's
    dtype (qlinear.py:541-544): the rescale where no producer or kernel
    takes the fold."""
    return (x.float() / cs).to(x.dtype)


def layer_path(lspec: Optional[LayerQuantSpec]) -> Optional[str]:
    """How a layer's quant mode runs (qlinear.py:386-411): None (nothing
    quantized, no CB), 'native' (dynamic int8 acts x packed weights),
    'native_static' (static acts of <= 8 bits x packed weights),
    'weight_only' (packed weights, fp acts) or 'simulate' (fake quant:
    the simulate backend, and the native backend's other combinations)."""
    if lspec is None or not (lspec.weight_quant or lspec.act_quant
                             or lspec.smooth_quant.enable):
        return None
    if lspec.backend == "native" and lspec.weight is not None \
            and lspec.weight_quant:
        if lspec.act is None or not lspec.act_quant:
            return "weight_only"
        if lspec.act.dynamic:
            return "native"
        if lspec.act.n_bits <= 8:
            return "native_static"
    return "simulate"


def _check_ported(lspec: LayerQuantSpec) -> None:
    smooth = lspec.smooth_quant
    if lspec.backend == "native":
        if smooth.enable and smooth.channel_wise_scale_type == "dynamic":
            # as the JAX package (qlinear.py:367-378): packed slabs cannot
            # follow a per-forward balancing scale
            raise ValueError(
                "backend='native' requires a momentum smooth-quant scale "
                "type (packed weight slabs can't track per-forward dynamic "
                "channel balancing); use backend='simulate' for "
                "channel_wise_scale_type='dynamic'")
        if lspec.split:
            raise ValueError(
                "backend='native' does not implement q-diffusion channel "
                "split (split>0); use backend='simulate'")
    if is_native_dynamic(lspec) and lspec.act.n_bits != 8:
        # the dynamic-quant kernels take int8 code ranges
        # (qlinear.py:548-554)
        raise ValueError(
            f"native dynamic-act backend requires 8-bit acts, got "
            f"{lspec.act.n_bits}; use backend='simulate' for A<8")
    used = [lspec.weight] if lspec.weight_quant else []
    if lspec.act_quant and not is_native_dynamic(lspec):
        used.append(lspec.act)  # the dynamic kernels read no act rounding
    for q in used:
        if q is None:
            continue
        if q.round_mode not in ("nearest", "nearest_ste"):
            raise NotImplementedError(
                f"round_mode {q.round_mode!r} (stochastic rounding and "
                f"AdaRound belong to the PTQ slice) is not ported")
        if q.scale_method != "min_max":
            raise NotImplementedError(
                f"scale_method {q.scale_method!r} is not ported")


def shared_prequant(x: torch.Tensor, lspec: Optional[LayerQuantSpec],
                    col_scale: Optional[torch.Tensor] = None
                    ) -> Optional[Prequant]:
    """Quantize an input ONCE for sibling native linears (q/k/v share their
    input; qlinear.py:79-110): K4 under impl 'fused' (the code row sum
    too where the weights are asym), K7a otherwise. Under channel
    balancing the siblings' shared 1/cs (`col_scale`, under
    `qkv_share_cs`) is applied first, inside K4, or as one f32 pass before
    K7a; without it a CB layer's rescale is its own, so there is no shared
    pass. None when the spec is not one shared pass."""
    if (not is_native_dynamic(lspec)
            or (lspec.smooth_quant.enable and col_scale is None)):
        return None
    _check_ported(lspec)
    x2 = x.reshape(-1, x.shape[-1])
    if lspec.impl == "fused":
        return Prequant(*quantize_rows(x2, sym=lspec.act.sym,
                                       need_rowsum=not lspec.weight.sym,
                                       col_scale=col_scale))
    if col_scale is not None:
        x2 = (x2.float() * col_scale.reshape(1, -1)).to(x2.dtype)
    return Prequant(*dynamic_quant_rows(x2.contiguous(), sym=lspec.act.sym))


def apply_epilogue(out: torch.Tensor, res: torch.Tensor,
                   gate: Optional[torch.Tensor]) -> torch.Tensor:
    """The residual (+ gate) epilogue outside the kernels (qlinear.py:
    320-331): `res + gate * out` in out's dtype, each batch's gate row over
    its M / G rows; returns out's shape and dtype."""
    if gate is None:
        return (res.reshape(out.shape) + out).to(out.dtype)
    G, F = gate.shape
    o2 = out.reshape(G, -1, F)
    return (res.reshape(o2.shape) + gate[:, None].to(o2.dtype) * o2
            ).reshape(out.shape).to(out.dtype)


def _refresh_after_load(mod: "QuantLinear", _incompatible_keys) -> None:
    if mod.native:
        mod.refresh_w_zp_int()


class QuantLinear(nn.Module):
    """Dense layer [K] -> [features] with every execution path of the JAX
    package's `_quant_core`. seg_len / stat_layout: the reference call
    site's layout for the CB act statistic (qlinear.py:228-250): seg_len >
    0 views the input as segments of seg_len tokens (STDiT's packed
    temporal attention); 'packed_prompt' views it as one [1, B*P, C] row
    (cross_attn.kv_linear). token_layout / d_t / d_s: the token view of
    token-wise act quantization (qlinear.py:184-241)."""

    def __init__(self, in_features: int, features: int,
                 lspec: Optional[LayerQuantSpec] = None,
                 use_bias: bool = True, dtype=torch.bfloat16,
                 seg_len: int = 0, stat_layout: Optional[str] = None,
                 token_layout: Optional[str] = None, d_t: int = 1,
                 d_s: int = 1):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.lspec = lspec
        self.dtype = dtype
        self.seg_len = seg_len
        self.stat_layout = stat_layout
        self.token_layout = token_layout
        self.d_t, self.d_s = d_t, d_s
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.path = layer_path(lspec)
        self.smooth = (lspec.smooth_quant if lspec is not None
                       and lspec.smooth_quant.enable else None)
        # packed int slabs: the native backend's three paths
        self.native = self.path in ("native", "native_static",
                                    "weight_only")
        self.fused = self.path == "native" and lspec.impl == "fused"
        self.momentum_cb = (self.smooth is not None and "momentum"
                            in self.smooth.channel_wise_scale_type)
        self._balance_cache = {}
        if self.path is not None:
            _check_ported(lspec)
        n_tr = self.smooth.n_timerange if self.smooth is not None else 1
        if self.smooth is not None:
            self.register_buffer("act_scale",
                                 torch.zeros((n_tr, in_features)))
            self.register_buffer("sq_init",
                                 torch.zeros(n_tr, dtype=torch.bool),
                                 persistent=False)
        if self.momentum_cb:
            self.register_buffer("cb_scale",
                                 torch.zeros((n_tr, in_features)))
        self.mp = (self.path in ("native", "native_static")
                   and lspec.weight.mp_bits is not None)
        if self.mp and len(lspec.weight.mp_bits) != n_tr:
            raise ValueError(
                f"mp_bits length {len(lspec.weight.mp_bits)} != "
                f"n_timerange {n_tr} (mp_bits are per smooth-quant "
                f"timerange)")
        if self.path is not None and lspec.weight_quant \
                and lspec.weight is not None:
            wshape = (lspec.weight.n_bitwidth, n_tr, 1, features)
            self.register_buffer("w_delta", torch.full(wshape, -1.0))
            self.register_buffer("w_zp", torch.full(wshape, -1.0))
        # two unsigned 4-bit codes a byte on the weight-only path (asym
        # W4; sym codes are signed and stay one a byte)
        self.pack4 = (self.path == "weight_only" and lspec.weight.n_bits == 4
                      and not lspec.weight.sym)
        if self.native:
            rows = (in_features + 1) // 2 if self.pack4 else in_features
            # [n_tr, rows, N] view of [n_tr, N, rows] storage: the K-major
            # weight the int8 GEMM kernels read; load_state_dict,
            # pack_native_weights and .to() copy into it and keep its
            # strides
            self.register_buffer(
                "w_int", torch.zeros((n_tr, features, rows),
                                     dtype=torch.int8).transpose(1, 2))
            self.register_buffer("w_colsum",
                                 torch.zeros((n_tr, 1, features)))
            self.register_buffer("w_zp_int", torch.zeros((n_tr, features)),
                                 persistent=False)
        if self.mp:
            self.register_buffer("w_mp_scale",
                                 torch.ones((n_tr, 1, features)))
            self.register_buffer("w_mp_zp", torch.zeros((n_tr, 1, features)))
        self.static_act = (self.path is not None and lspec.act_quant
                           and lspec.act is not None
                           and not lspec.act.dynamic)
        if self.static_act:
            # the group shape of a 3-D token view until the first a_calib
            # forward (or a load) gives the table its own
            self._alloc_act_tables((1, 1, 1))
        self.register_load_state_dict_post_hook(_refresh_after_load)

    # ---- static act tables ----

    def _alloc_act_tables(self, gshape) -> None:
        aspec = self.lspec.act
        n_ts = aspec.n_timestep
        dev = self.kernel.device
        ashape = (aspec.n_bitwidth, n_ts) + tuple(gshape)
        for name, val in (("a_delta", -1.0), ("a_zp", -1.0)):
            self.register_buffer(name, torch.full(ashape, val, device=dev))
        for name in ("a_min", "a_max"):
            self.register_buffer(name, torch.zeros((n_ts,) + tuple(gshape),
                                                   device=dev))
        self.register_buffer("a_init", torch.zeros(n_ts, dtype=torch.bool,
                                                   device=dev))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # static act tables take the group shape of the tables loaded
        if self.static_act:
            key = prefix + "a_delta"
            if key in state_dict and (state_dict[key].shape
                                      != self.a_delta.shape):
                self._alloc_act_tables(tuple(state_dict[key].shape[2:]))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def act_group_shape(self, xv: torch.Tensor) -> tuple:
        """Batch-agnostic group shape of one static act table slot for the
        token view xv (qlinear.py:463-466)."""
        return (1,) + core.group_shape_of(tuple(xv.shape),
                                          self.lspec.act)[1:]

    def act_slot(self, qctx: QuantCtx) -> int:
        """The static table slot of qctx, clamped to [0, n_timestep) as
        JAX's dynamic index clamps it: a plan without timestep-wise tables
        has one slot, which every calibration step and every step of the
        run share."""
        return min(max(int(qctx.act_slot), 0),
                   self.lspec.act.n_timestep - 1)

    def token_view(self, x: torch.Tensor, dynamic: bool = False
                   ) -> torch.Tensor:
        """The [B, n_token, C] view of token-wise act quantization
        (`_to_token_view`, qlinear.py:214-238): a token's scale is pooled
        over its position's batch rows and channels, so the batch split of
        the view is part of the semantics. cross_kv dynamic acts run on the
        reference's packed [1, B*P, C] view, its static tables on the
        dense [B, P, C] prompts as they come."""
        C = x.shape[-1]
        if self.token_layout == "spatial":
            return x.reshape(x.shape[0] // self.d_t, self.d_t * self.d_s, C)
        if self.token_layout == "temporal":
            return x.reshape(x.shape[0] // self.d_s, self.d_s * self.d_t, C)
        if self.token_layout == "cross_kv" and dynamic:
            return x.reshape(1, -1, C)
        return x

    def dense(self, x: torch.Tensor,
              kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
        kernel = self.kernel if kernel is None else kernel
        y = torch.matmul(x.to(self.dtype), kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    # ---- channel balancing ----

    def stat_view(self, x: torch.Tensor) -> torch.Tensor:
        """The reference call site's layout for the CB act statistic
        (`_to_stat_view`, qlinear.py:243-250)."""
        if self.seg_len > 0:
            return x.reshape(-1, self.seg_len, x.shape[-1])
        if self.stat_layout == "packed_prompt":
            return x.reshape(1, -1, x.shape[-1])
        return x

    @torch.no_grad()
    def accumulate_act_scale(self, x: torch.Tensor, tr: int) -> None:
        """The sq_stat pass (qlinear.py:497-512): blend this call's
        per-channel act maxima into act_scale[tr] with the spec's momentum
        (the first call of a timerange takes them as they are)."""
        cur = abs_max_per_channel(self.stat_view(x))
        m = self.smooth.momentum
        if bool(self.sq_init[tr]):
            cur = self.act_scale[tr] * m + cur * (1 - m)
        self.act_scale[tr] = cur
        self.sq_init[tr] = True

    def balance_tables(self, tr: int):
        """(cs, 1/cs) of timerange tr, f32 [K]: an uncalibrated (0) entry
        reads as 1 (qlinear.py:527-533), 1/cs one true division. Kept
        between calls while `cb_scale` is the same tensor, unmodified
        (its storage and version counter): the tables change only at
        calibration or a load."""
        key = (tr, self.cb_scale.data_ptr(), self.cb_scale._version)
        hit = self._balance_cache.get(tr)
        if hit is None or hit[0] != key:
            cs = self.cb_scale[tr]
            cs = torch.where(cs > 0, cs, torch.ones_like(cs))
            hit = (key, cs, rdiv(1.0, cs))
            self._balance_cache[tr] = hit
        return hit[1], hit[2]

    def dynamic_balance(self, x: torch.Tensor, tr: int) -> torch.Tensor:
        """cs of the 'dynamic' CB type (qlinear.py:518-526): from this
        input's per-channel act maxima (stat view) and the kernel's, with
        timerange tr's alpha as a float32 scalar, as JAX gathers it."""
        alpha = torch.tensor(self.smooth.alpha_for_range(tr),
                             dtype=torch.float32, device=self.kernel.device)
        return core.smooth_quant_scale(
            abs_max_per_channel(self.stat_view(x)),
            self.kernel.float().abs().amax(dim=-1), alpha)

    def inv_balance(self, qctx: Optional[QuantCtx]) -> Optional[torch.Tensor]:
        """This layer's 1/cs (f32 [K], one true division) for qctx's
        timerange, for a parent producer to fold in; None unless the layer
        is a momentum-CB native dynamic layer in quant mode. The JAX
        package keeps a copy of the child's `cb_scale` in the parent's
        scope for this (`cbshare_inv_cs`, qlinear.py:113-145); a parent
        module here reads the child's table itself."""
        if (not self.momentum_cb or self.path != "native" or qctx is None
                or qctx.mode != "quant"):
            return None
        return self.balance_tables(timerange_of(self.smooth, qctx.t_id))[1]

    def table_timerange(self, tr: int) -> int:
        """The timerange whose weight tables (scale, zero point) dequantize
        slab tr: 0 under `frozen_tr0_weights` (qlinear.py:580-591)."""
        if self.smooth is not None and self.smooth.frozen_tr0_weights:
            return 0
        return tr

    # ---- forward ----

    def _epilogue_fusable(self, qctx: Optional[QuantCtx]) -> bool:
        """Whether a residual (+ gate) epilogue runs inside the int8 kernel
        (K2 on a prequant, else K5): the conditions of JAX
        `_epilogue_fusable` (qlinear.py:273-295), quant mode on the fused
        native dynamic path without channel balancing or a split (capture
        mode is not ported). JAX's environment switch has no counterpart:
        a model passes an epilogue only where its `fuse_epilogue` flag asks
        for one."""
        return (qctx is not None and qctx.mode == "quant" and self.fused
                and self.smooth is None)

    def forward(self, x: Optional[torch.Tensor],
                qctx: Optional[QuantCtx] = None,
                prequant: Optional[Prequant] = None,
                emit: Optional[dict] = None, epilogue=None):
        """x [..., K]. `prequant`: the input already quantized (and, under
        channel balancing, rescaled) by a producer (x may then be None; the
        output is [M, features]). `emit`: {'gelu': bool, 'col_scale': next
        layer's 1/cs or None} — return the output as a group-wise
        `Prequant` for the next linear instead (K2's int8-emitting
        epilogue). `epilogue`: (residual shaped like the output, gate
        [G, features] or None) — return `residual + gate * output` (each
        batch's gate row over its M / G rows), inside the kernel where
        `_epilogue_fusable`, else after it (`apply_epilogue`)."""
        if epilogue is None:
            return self._forward(x, qctx, prequant, emit, None)
        if emit is not None:
            raise ValueError("emit replaces the output epilogue")
        if self._epilogue_fusable(qctx):
            return self._forward(x, qctx, prequant, None, epilogue)
        return apply_epilogue(self._forward(x, qctx, prequant, None, None),
                              *epilogue)

    def _forward(self, x, qctx, prequant, emit, epilogue):
        mode = "fp" if qctx is None else qctx.mode
        quant = mode == "quant"
        if emit is not None and not (quant and self.fused
                                     and prequant is not None):
            raise ValueError(
                "emit requires the fused-native consumer path in quant mode")
        if mode == "fp" or self.path is None:
            return self.dense(x)
        tr = 0 if self.smooth is None else timerange_of(self.smooth,
                                                        qctx.t_id)
        if mode == "sq_stat":
            if self.momentum_cb:
                self.accumulate_act_scale(x, tr)
            return self.dense(x)
        cs = fold = None
        if self.smooth is not None:
            if self.momentum_cb:
                cs, inv_cs = self.balance_tables(tr)
            else:
                cs, inv_cs = self.dynamic_balance(x, tr), None
            if prequant is None:
                if quant and self.fused:
                    fold = inv_cs  # into K5's quantize
                else:
                    x = divide_cols(x, cs)
        if quant:
            if self.path == "native":
                return self._quant(x, tr, prequant, emit, fold, epilogue)
            if self.path == "native_static":
                return self._native_static(x, tr, self.act_slot(qctx))
            if self.path == "weight_only":
                return self._weight_only(x, tr)
            if self.lspec.split > 0:
                return self._split(x)
        return self._simulate(x, tr, cs, qctx)

    def weight_tables(self, tr: int):
        """(scale, zero point) [1, N] of the codes of slab tr as the native
        epilogues take them: the span's `w_mp_*` tables under mp_bits,
        else the active bitwidth's `w_delta` and `w_zp_int` of the
        timerange that dequantizes slab tr (`table_timerange`)."""
        if self.mp:  # this timerange's bits (qlinear.py:575-582)
            return self.w_mp_scale[tr], self.w_mp_zp[tr]
        tw = self.table_timerange(tr)
        return (self.w_delta[self.lspec.weight.bit_idx, tw].reshape(1, -1),
                self.w_zp_int[tw].reshape(1, -1))

    def _quant(self, x, tr, prequant, emit, fold, epilogue=None):
        wspec = self.lspec.weight
        w_q = self.w_int[tr]
        w_scale, w_zp = self.weight_tables(tr)
        w_colsum = self.w_colsum[tr]
        if not self.fused:
            return self._native(x, prequant, w_q, w_scale, w_zp, w_colsum)
        # sym weights: no zero point (JAX qlinear.py:603-605, 614-616)
        tables = dict(w_zp=None if wspec.sym else w_zp, w_colsum=w_colsum)
        if epilogue is not None:  # in the kernel (qlinear.py:609-618, 632)
            tables.update(residual=epilogue[0].reshape(-1, self.features),
                          gate=epilogue[1])
        if prequant is not None:
            pre = dict(x_zp=prequant.zp, x_rowsum=prequant.rowsum, **tables)
            if emit is not None:
                codes, scales = int8_consumer_matmul(
                    prequant.codes, prequant.scale, w_q, w_scale, self.bias,
                    out_dtype=self.dtype, group_scales=prequant.group_wise,
                    emit=emit, **pre)
                return Prequant(codes, scales, group_wise=True)
            out = int8_consumer_matmul(
                prequant.codes, prequant.scale, w_q, w_scale, self.bias,
                out_dtype=self.dtype, group_scales=prequant.group_wise, **pre)
            return out if x is None else out.reshape(*x.shape[:-1], -1)
        out = fused_dynq_int8_matmul(
            x.reshape(-1, self.in_features), w_q, w_scale, self.bias,
            out_dtype=self.dtype, sym=self.lspec.act.sym, sym_w=wspec.sym,
            col_scale=fold, **tables)
        return out.reshape(*x.shape[:-1], self.features)

    @torch.no_grad()
    def refresh_w_zp_int(self) -> None:
        """Derive `w_zp_int` from the `w_zp` tables: asym codes are stored
        shifted into signed int8, so their zero points shift with them; sym
        codes have zero point 0."""
        wspec = self.lspec.weight
        shift = 0.0 if wspec.sym else float(2 ** (wspec.n_bits - 1))
        self.w_zp_int = self.w_zp[wspec.bit_idx, :, 0] - shift

    def _native(self, x, prequant, w_q, w_scale, w_zp, w_colsum):
        """The native int8 path of impl None/'xla'/'mixed'/'pallas'
        (qlinear.py:572-643): K7b on a prequant input, else K7a -> K7b."""
        wspec, aspec = self.lspec.weight, self.lspec.act
        if prequant is not None:
            if prequant.zp is None or prequant.group_wise:
                raise ValueError("the native path takes a K7a prequant")
            out = int8_matmul(prequant.codes, w_q, prequant.scale,
                              prequant.zp, prequant.rowsum, w_scale, w_zp,
                              w_colsum, out_dtype=self.dtype, bias=self.bias)
            return out if x is None else out.reshape(*x.shape[:-1], -1)
        packed = {"w_q": w_q, "w_scale": w_scale, "w_zp": w_zp,
                  "w_colsum": w_colsum}
        out = quantized_linear_native(x, packed, bias=self.bias,
                                      act_sym=aspec.sym, w_sym=wspec.sym,
                                      out_dtype=self.dtype,
                                      impl=self.lspec.impl)
        return out.reshape(*x.shape[:-1], self.features)

    def _native_static(self, x, tr, slot):
        """Static acts on the packed weights (qlinear.py:645-727): the
        codes from the slot's tables, made elementwise as JAX makes them
        in XLA (the scale's reciprocal multiplied in, C6), then K2 under
        impl 'fused' (the row sums only where a side is asym), else K7b
        with the bias added in the model dtype."""
        wspec, aspec = self.lspec.weight, self.lspec.act
        w_scale, w_zp = self.weight_tables(tr)
        d_a = self.a_delta[aspec.bit_idx, slot]
        z_a = self.a_zp[aspec.bit_idx, slot]
        xv = self.token_view(x).float()
        if tuple(d_a.shape) != self.act_group_shape(xv):
            raise ValueError(
                f"static act tables of group shape {tuple(d_a.shape)} do "
                f"not fit this input's token view {tuple(xv.shape)}")
        n_levels = aspec.n_levels()
        inv_d = rdiv(1.0, d_a)
        if aspec.sym:
            codes = torch.clamp(torch.round(xv * inv_d), -n_levels - 1,
                                n_levels)
            zp_rows = torch.zeros_like(d_a)
        else:
            shift = float(2 ** (aspec.n_bits - 1))
            codes = torch.clamp(torch.round(xv * inv_d) + z_a, 0,
                                n_levels - 1) - shift
            zp_rows = z_a - shift
        Bv, Nv, Cv = xv.shape
        x_q = codes.to(torch.int8).reshape(-1, Cv)

        def rows(t):
            return t.expand(Bv, Nv, 1).reshape(-1, 1).contiguous()
        xs, xzp = rows(d_a), rows(zp_rows)
        xrs = (torch.zeros_like(xs) if wspec.sym
               else codes.sum(dim=-1, keepdim=True).reshape(-1, 1))
        if self.lspec.impl == "fused":
            out = int8_consumer_matmul(
                x_q, xs, self.w_int[tr], w_scale, self.bias,
                out_dtype=self.dtype, x_zp=None if aspec.sym else xzp,
                x_rowsum=None if aspec.sym and wspec.sym else xrs,
                w_zp=None if wspec.sym else w_zp,
                w_colsum=self.w_colsum[tr])
        else:
            out = int8_matmul(x_q, self.w_int[tr], xs, xzp, xrs, w_scale,
                              w_zp, self.w_colsum[tr], out_dtype=self.dtype,
                              bias=self.bias)
        return out.reshape(*x.shape[:-1], self.features)

    def _weight_only(self, x, tr):
        """Int8-stored weights, fp acts (qlinear.py:729-763): slab tr's
        codes dequantized in the model dtype, `(code - zp) * scale` (asym
        codes are stored shifted by 2^(b-1), the nibble codes unsigned),
        then the dense product."""
        wspec = self.lspec.weight
        tw = self.table_timerange(tr)
        d = self.w_delta[wspec.bit_idx, tw].reshape(1, -1).to(self.dtype)
        z = self.w_zp[wspec.bit_idx, tw].reshape(1, -1).to(self.dtype)
        stored = self.w_int[tr]
        if self.pack4:
            b = stored.to(torch.int32) & 0xFF
            codes = torch.stack([(b & 0x0F).to(self.dtype),
                                 ((b >> 4) & 0x0F).to(self.dtype)], dim=1)
            codes = codes.reshape(-1, self.features)[:self.in_features]
            w_deq = (codes - z) * d
        else:
            shift = 0.0 if wspec.sym else float(2 ** (wspec.n_bits - 1))
            w_deq = (stored.to(self.dtype) - (z - shift)) * d
        return self.dense(x, w_deq)

    def _split(self, x):
        """The q-diffusion channel split (qlinear.py:765-782): input
        channels [:split] and [split:] and the matching kernel rows
        quantized as separate groups, acts dynamic on the input as it is,
        weight qparams on the fly."""
        s = self.lspec.split
        wspec, aspec = self.lspec.weight, self.lspec.act
        xa, xb = x[..., :s], x[..., s:]
        if aspec is not None and self.lspec.act_quant:
            xa = core.fake_quant_dynamic(xa, aspec)
            xb = core.fake_quant_dynamic(xb, aspec)
        x = torch.cat([xa, xb], dim=-1)
        w_eff = self.kernel.float()
        if wspec is not None and self.lspec.weight_quant:
            parts = []
            for wpart in (w_eff[:s], w_eff[s:]):
                d, z = core.compute_qparams(wpart, wspec)
                parts.append(core.fake_quant(wpart, d, z, wspec))
            w_eff = torch.cat(parts, dim=0)
        return self.dense(x, w_eff)

    @torch.no_grad()
    def _calibrate_slot(self, xv, slot):
        """The a_calib update of one slot (qlinear.py:790-806): the view's
        group min/max blended into a_min/a_max[slot] (the spec's momentum
        under running_stat, else the new range replaces the old); returns
        the blended (min, max), shaped as one group slice."""
        aspec = self.lspec.act
        gshape = self.act_group_shape(xv)
        if tuple(self.a_min.shape[1:]) != gshape:
            if bool(self.a_init.any()):
                raise ValueError(
                    f"static act tables of group shape "
                    f"{tuple(self.a_min.shape[1:])} were calibrated on "
                    f"another token view than {tuple(xv.shape)}")
            self._alloc_act_tables(gshape)
        cmin, cmax = core.minmax(xv, aspec)
        m = aspec.momentum if aspec.running_stat else 0.0
        nmin, nmax = core.update_running_minmax(
            (self.a_min[slot], self.a_max[slot]), cmin[0], cmax[0], m,
            bool(self.a_init[slot]))
        self.a_min[slot] = nmin.reshape(gshape)
        self.a_max[slot] = nmax.reshape(gshape)
        self.a_init[slot] = True
        return self.a_min[slot], self.a_max[slot]

    def _simulate(self, x, tr, cs, qctx):
        """Fake quant (qlinear.py:784-846): the act on its token view
        (dynamic, a_calib or the slot's static tables), the weight (times
        cs under CB) from the tables of its timerange (timerange 0's under
        `frozen_tr0_weights`) or on the fly under the 'dynamic' CB type;
        then the dense product. Both quantize in float32 and return to
        their dtype."""
        lspec = self.lspec
        wspec, aspec = lspec.weight, lspec.act
        if aspec is not None and lspec.act_quant:
            orig = x.shape
            xv = self.token_view(x, dynamic=aspec.dynamic)
            if aspec.dynamic:
                xv = core.fake_quant_dynamic(xv, aspec)
            else:
                slot = self.act_slot(qctx)
                if qctx.mode == "a_calib":
                    amin, amax = self._calibrate_slot(xv, slot)
                    d, z = core.qparams_minmax(amin, amax, aspec)
                else:
                    d = self.a_delta[aspec.bit_idx, slot]
                    z = self.a_zp[aspec.bit_idx, slot]
                xv = core.fake_quant(xv, d, z, aspec)
            x = xv.reshape(orig)
        w_eff = self.kernel.float()
        if cs is not None:
            w_eff = w_eff * cs[:, None]  # input channels (quant_layer.py:183)
        if wspec is not None and lspec.weight_quant:
            if self.smooth is not None and not self.momentum_cb:
                # the balanced weight follows the live acts: qparams on
                # the fly (the reference's per-forward weight init)
                d, z = core.compute_qparams(w_eff, wspec)
            else:
                tw = self.table_timerange(tr)
                d = self.w_delta[wspec.bit_idx, tw]
                z = self.w_zp[wspec.bit_idx, tw]
            w_eff = core.fake_quant(w_eff, d, z, wspec)
        return self.dense(x, w_eff)
