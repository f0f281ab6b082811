"""Quantization-aware linear layer (port of `viditq_tpu/quant/qlinear.py`).

`QuantLinear` holds its fp kernel in the JAX layout [K, N] and, for a layer
the plan quantizes, the calibrated tables as buffers: `w_delta`/`w_zp`
[n_bitwidth, n_timerange, 1, N] and the packed `w_int` [n_timerange, K, N]
int8 slabs with `w_colsum` [n_timerange, 1, N] (qlinear.py:412-421,
584-591). `w_int` is stored K-major ([n_timerange, N, K] in memory), the
layout the int8 GEMM kernels read. `w_zp_int` [n_timerange, N], not saved,
is the zero point of the `w_int` codes as the epilogues take them; the
packing and `load_state_dict` write it beside the slabs.

Channel balancing (smooth quant, "CB"; qlinear.py:113-168, 497-591): a
layer whose spec enables it also holds `act_scale` and `cb_scale`
[n_timerange, K] (the momentum act maxima of the calibration forwards and
the balancing scale cs made from them) and one int8 slab per timerange of
the weight times cs. The timerange comes from `QuantCtx.t_id` (a Python
int, so no device sync). A forward divides its input by cs, folded where
the JAX package folds it: into K5's quantize (`col_scale` = 1/cs), or into
the producer of a prequant input (K1's adaLN vectors, K4, the attention's
emission, K2's emission), whose parent reads this layer's 1/cs through
`inv_balance`; otherwise a true f32 division. The weight tables of every
timerange are timerange 0's under `frozen_tr0_weights`.

Timerange-gathered mixed precision (qlinear.py:423-440, 575-582): a
native layer whose weight spec carries `mp_bits` (one bitwidth per
timerange, from `pipelines/mixed_precision.py`'s union of the CB
timeranges and the MP step ranges) packs each timerange's slab at its own
bits and holds saved per-timerange dequant tables `w_mp_scale` and
`w_mp_zp` [n_timerange, 1, N] (the zero point with the signed shift of
its bits folded in, 0 for sym weights). `_quant` reads those for the
call's timerange in place of the `w_delta`/`w_zp_int` pair; every table
is a view `[tr]` of the stored one, so no forward copies a slab.

Modes:
  * fp (no spec, an fp-listed layer, `qctx is None` or mode 'fp'):
    `x @ kernel + bias` in the model dtype;
  * sq_stat: the fp output, and the input's per-channel act maxima blended
    into `act_scale` of the call's timerange (the reference stat view:
    `seg_len` / `stat_layout`);
  * quant: an fp-listed layer under a CB plan runs `(x / cs) @ (kernel *
    cs)` unquantized (qlinear.py:744-747); a quantized layer runs
    - native fused (impl 'fused'): sym or asym dynamic per-token int8 acts
      x sym or asym per-channel int8 weights through the fused kernels —
      with a `Prequant` input from a producer kernel, the int8 consumer
      matmul (K2, optionally emitting int8 for the next layer when sym x
      sym); otherwise the quantize-in matmul (K5); a residual (+ gate)
      `epilogue` runs inside either (`_epilogue_fusable`);
    - native (any other impl): with a `Prequant` input from
      `shared_prequant` (K7a), the int8 matmul with the zero-point-
      corrected epilogue (K7b); otherwise `quantized_linear_native` (K7a
      then K7b).

An `epilogue` (residual, gate | None) the kernels do not take is applied
after the layer with the JAX package's bf16 roundings (`apply_epilogue`).

Other backends (simulate fake quant, weight-only, static acts), the
q-diffusion split and the 'dynamic' CB scale raise at construction.
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
from viditq_tpu_torch.quant.spec import LayerQuantSpec, SmoothQuantSpec

# 'sq_stat': the smooth-quant act-statistic pass (reference ptq.py:219-264)
MODES = ("fp", "sq_stat", "quant")


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """Per-call quantization context (qlinear.py:47-76): the diffusion
    timestep (it selects the CB timerange) and the execution mode. The
    static-act calibration and capture modes and the act-table slot are
    not ported."""

    t_id: int = 0
    mode: str = "quant"

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


def _check_ported(lspec: LayerQuantSpec) -> None:
    smooth = lspec.smooth_quant
    if (smooth.enable and smooth.channel_wise_scale_type == "dynamic"
            and lspec.backend == "native"):
        # as the JAX package (qlinear.py:367-378): packed slabs cannot
        # follow a per-forward balancing scale
        raise ValueError(
            "backend='native' requires a momentum smooth-quant scale type "
            "(packed weight slabs can't track per-forward dynamic channel "
            "balancing); use backend='simulate' for "
            "channel_wise_scale_type='dynamic'")
    if smooth.enable and "momentum" not in smooth.channel_wise_scale_type:
        raise NotImplementedError(
            f"smooth-quant scale type {smooth.channel_wise_scale_type!r}")
    if lspec.split:
        raise NotImplementedError("q-diffusion channel split")
    if not (lspec.weight_quant or lspec.act_quant):
        return  # an fp-listed layer: channel balancing alone
    if not is_native_dynamic(lspec):
        raise NotImplementedError(
            f"only the native dynamic-act backend is ported "
            f"(backend={lspec.backend!r}, act_quant={lspec.act_quant})")
    if lspec.act.n_bits != 8:
        raise ValueError(
            f"native dynamic-act backend requires 8-bit acts, got "
            f"{lspec.act.n_bits}")


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
    """Dense layer [K] -> [features] with the native int8 path and channel
    balancing. seg_len / stat_layout: the reference call site's layout for
    the CB act statistic (qlinear.py:228-250): seg_len > 0 views the input
    as segments of seg_len tokens (STDiT's packed temporal attention);
    'packed_prompt' views it as one [1, B*P, C] row (cross_attn.kv_linear)."""

    def __init__(self, in_features: int, features: int,
                 lspec: Optional[LayerQuantSpec] = None,
                 use_bias: bool = True, dtype=torch.bfloat16,
                 seg_len: int = 0, stat_layout: Optional[str] = None):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.lspec = lspec
        self.dtype = dtype
        self.seg_len = seg_len
        self.stat_layout = stat_layout
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.smooth = (lspec.smooth_quant if lspec is not None
                       and lspec.smooth_quant.enable else None)
        self.native = lspec is not None and (lspec.weight_quant
                                             or lspec.act_quant)
        self.fused = self.native and is_fused_dynamic(lspec)
        self._balance_cache = {}
        if self.native or self.smooth is not None:
            _check_ported(lspec)
        n_tr = self.smooth.n_timerange if self.smooth is not None else 1
        if self.smooth is not None:
            self.register_buffer("act_scale",
                                 torch.zeros((n_tr, in_features)))
            self.register_buffer("cb_scale",
                                 torch.zeros((n_tr, in_features)))
            self.register_buffer("sq_init",
                                 torch.zeros(n_tr, dtype=torch.bool),
                                 persistent=False)
        self.mp = self.native and lspec.weight.mp_bits is not None
        if self.mp and len(lspec.weight.mp_bits) != n_tr:
            raise ValueError(
                f"mp_bits length {len(lspec.weight.mp_bits)} != "
                f"n_timerange {n_tr} (mp_bits are per smooth-quant "
                f"timerange)")
        if self.native:
            wshape = (lspec.weight.n_bitwidth, n_tr, 1, features)
            self.register_buffer("w_delta", torch.full(wshape, -1.0))
            self.register_buffer("w_zp", torch.full(wshape, -1.0))
            # [n_tr, K, N] view of [n_tr, N, K] storage: the K-major weight
            # the int8 GEMM kernels read; load_state_dict,
            # pack_native_weights and .to() copy into it and keep its
            # strides
            self.register_buffer(
                "w_int", torch.zeros((n_tr, features, in_features),
                                     dtype=torch.int8).transpose(1, 2))
            self.register_buffer("w_colsum",
                                 torch.zeros((n_tr, 1, features)))
            self.register_buffer("w_zp_int", torch.zeros((n_tr, features)),
                                 persistent=False)
        if self.mp:
            self.register_buffer("w_mp_scale",
                                 torch.ones((n_tr, 1, features)))
            self.register_buffer("w_mp_zp", torch.zeros((n_tr, 1, features)))
        self.register_load_state_dict_post_hook(_refresh_after_load)

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

    def inv_balance(self, qctx: Optional[QuantCtx]) -> Optional[torch.Tensor]:
        """This layer's 1/cs (f32 [K], one true division) for qctx's
        timerange, for a parent producer to fold in; None unless the layer
        is a channel-balanced native dynamic layer in quant mode. The JAX
        package keeps a copy of the child's `cb_scale` in the parent's
        scope for this (`cbshare_inv_cs`, qlinear.py:113-145); a parent
        module here reads the child's table itself."""
        if (self.smooth is None or not self.native or qctx is None
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
        quant = self.native and mode == "quant"
        if emit is not None and not (quant and self.fused
                                     and prequant is not None):
            raise ValueError(
                "emit requires the fused-native consumer path in quant mode")
        if mode == "fp" or (self.smooth is None and not self.native):
            return self.dense(x)
        tr = 0 if self.smooth is None else timerange_of(self.smooth,
                                                        qctx.t_id)
        if mode == "sq_stat":
            if self.smooth is not None:
                self.accumulate_act_scale(x, tr)
            return self.dense(x)
        fold = None
        if self.smooth is not None:
            cs, inv_cs = self.balance_tables(tr)
            if not self.native:
                # an fp-listed layer keeps the balanced fp weight
                # (qlinear.py:744-747; quant_layer.py:188-189)
                return self.dense(divide_cols(x, cs),
                                  self.kernel.float() * cs[:, None])
            if prequant is None:
                if self.fused:
                    fold = inv_cs  # into K5's quantize
                else:
                    x = divide_cols(x, cs)
        return self._quant(x, tr, prequant, emit, fold, epilogue)

    def _quant(self, x, tr, prequant, emit, fold, epilogue=None):
        wspec = self.lspec.weight
        w_q = self.w_int[tr]
        if self.mp:  # this timerange's bits (qlinear.py:575-582)
            w_scale = self.w_mp_scale[tr]
            w_zp = self.w_mp_zp[tr]
        else:
            tw = self.table_timerange(tr)
            w_scale = self.w_delta[wspec.bit_idx, tw].reshape(1, -1)
            w_zp = self.w_zp_int[tw].reshape(1, -1)
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
