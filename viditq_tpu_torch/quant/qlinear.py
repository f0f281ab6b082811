"""Quantization-aware linear layer (port of `viditq_tpu/quant/qlinear.py`).

`QuantLinear` holds its fp kernel in the JAX layout [K, N] and, for a layer
the plan quantizes, the calibrated tables as buffers: `w_delta`/`w_zp`
[n_bitwidth, n_timerange, 1, N] and the packed `w_int` [n_timerange, K, N]
int8 slab with `w_colsum` [n_timerange, 1, N] (qlinear.py:412-421,
584-591). `w_int` is stored K-major ([n_timerange, N, K] in memory), the
layout the int8 GEMM kernels read. `w_zp_int` [1, N], not saved, is the
zero point of the `w_int` codes as the epilogues take them; the packing
and `load_state_dict` write it beside the slab. It runs three paths:

  * fp (no spec, an fp-listed layer, `qctx is None` or mode 'fp'):
    `x @ kernel + bias` in the model dtype;
  * native fused (mode 'quant', impl 'fused'): sym or asym dynamic
    per-token int8 acts x sym or asym per-channel int8 weights through the
    fused kernels — with a `Prequant` input from a producer kernel, the int8
    consumer matmul (K2, optionally emitting int8 for the next layer when
    sym x sym); otherwise the quantize-in matmul (K5);
  * native (mode 'quant', any other impl): sym or asym dynamic per-token
    int8 acts x sym or asym per-channel int8 weights — with a `Prequant`
    input from `shared_prequant` (K7a), the int8 matmul with the
    zero-point-corrected epilogue (K7b); otherwise
    `quantized_linear_native` (K7a then K7b).

Other backends (simulate fake quant, weight-only, static acts), the
q-diffusion split and smooth quant are not ported and raise
NotImplementedError at construction.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from viditq_tpu_torch.kernels.fused_matmul import (fused_dynq_int8_matmul,
                                                   int8_consumer_matmul,
                                                   quantize_rows)
from viditq_tpu_torch.kernels.int_matmul import (dynamic_quant_rows,
                                                 int8_matmul,
                                                 quantized_linear_native)
from viditq_tpu_torch.quant.spec import LayerQuantSpec

MODES = ("fp", "quant")


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """Per-call quantization context (qlinear.py:47-76): the diffusion
    timestep and the execution mode. Calibration and capture modes and the
    static-act table slot are not ported."""

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


def is_quantized(lspec: Optional[LayerQuantSpec]) -> bool:
    return lspec is not None and (lspec.weight_quant or lspec.act_quant
                                  or lspec.smooth_quant.enable)


def is_native_dynamic(lspec: Optional[LayerQuantSpec]) -> bool:
    """The native dynamic-act int8 backend, any impl (qlinear.py:387-388)."""
    return (lspec is not None and lspec.backend == "native"
            and lspec.act is not None and lspec.act.dynamic
            and lspec.act_quant and lspec.weight is not None
            and lspec.weight_quant)


def is_fused_dynamic(lspec: Optional[LayerQuantSpec]) -> bool:
    """The fused-native dynamic-act dataflow (impl 'fused')."""
    return is_native_dynamic(lspec) and lspec.impl == "fused"


def _check_ported(lspec: LayerQuantSpec) -> None:
    if lspec.smooth_quant.enable:
        raise NotImplementedError("smooth-quant channel balancing")
    if lspec.split:
        raise NotImplementedError("q-diffusion channel split")
    if not is_native_dynamic(lspec):
        raise NotImplementedError(
            f"only the native dynamic-act backend is ported "
            f"(backend={lspec.backend!r}, act_quant={lspec.act_quant})")
    if lspec.act.n_bits != 8:
        raise ValueError(
            f"native dynamic-act backend requires 8-bit acts, got "
            f"{lspec.act.n_bits}")


def shared_prequant(x: torch.Tensor, lspec: Optional[LayerQuantSpec]
                    ) -> Optional[Prequant]:
    """Quantize an input ONCE for sibling native linears (q/k/v share their
    input; qlinear.py:79-110): K4 under impl 'fused' (the code row sum
    too where the weights are asym), K7a otherwise. None when the spec is
    not one shared pass (not the native dynamic-act backend, or smooth
    quant, whose per-layer rescale precedes the quantize)."""
    if not is_native_dynamic(lspec) or lspec.smooth_quant.enable:
        return None
    _check_ported(lspec)
    x2 = x.reshape(-1, x.shape[-1])
    if lspec.impl == "fused":
        return Prequant(*quantize_rows(x2, sym=lspec.act.sym,
                                       need_rowsum=not lspec.weight.sym))
    return Prequant(*dynamic_quant_rows(x2.contiguous(), sym=lspec.act.sym))


def _refresh_after_load(mod: "QuantLinear", _incompatible_keys) -> None:
    mod.refresh_w_zp_int()


class QuantLinear(nn.Module):
    """Dense layer [K] -> [features] with the native int8 path."""

    def __init__(self, in_features: int, features: int,
                 lspec: Optional[LayerQuantSpec] = None,
                 use_bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.lspec = lspec
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(in_features, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.native = is_quantized(lspec)
        self.fused = self.native and is_fused_dynamic(lspec)
        if self.native:
            _check_ported(lspec)
            n_bw = lspec.weight.n_bitwidth
            wshape = (n_bw, 1, 1, features)
            self.register_buffer("w_delta", torch.full(wshape, -1.0))
            self.register_buffer("w_zp", torch.full(wshape, -1.0))
            # [1, K, N] view of [1, N, K] storage: the K-major weight the
            # int8 GEMM kernels read; load_state_dict, pack_native_weights
            # and .to() copy into it and keep its strides
            self.register_buffer(
                "w_int", torch.zeros((1, features, in_features),
                                     dtype=torch.int8).transpose(1, 2))
            self.register_buffer("w_colsum", torch.zeros((1, 1, features)))
            self.register_buffer("w_zp_int", torch.zeros((1, features)),
                                 persistent=False)
            self.register_load_state_dict_post_hook(_refresh_after_load)

    def dense(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y

    def forward(self, x: Optional[torch.Tensor],
                qctx: Optional[QuantCtx] = None,
                prequant: Optional[Prequant] = None,
                emit: Optional[dict] = None):
        """x [..., K]. `prequant`: the input already quantized by a producer
        (x may then be None; the output is [M, features]). `emit`:
        {'gelu': bool} — return the output as a group-wise `Prequant` for
        the next linear instead (K2's int8-emitting epilogue)."""
        quant = self.native and qctx is not None and qctx.mode == "quant"
        if emit is not None and not (quant and self.fused
                                     and prequant is not None):
            raise ValueError(
                "emit requires the fused-native consumer path in quant mode")
        if not quant:
            return self.dense(x)
        wspec = self.lspec.weight
        w_q = self.w_int[0]
        w_scale = self.w_delta[wspec.bit_idx, 0].reshape(1, -1)
        if not self.fused:
            return self._native(x, prequant, w_q, w_scale)
        # sym weights: no zero point (JAX qlinear.py:603-605, 614-616)
        tables = dict(w_zp=None if wspec.sym else self.w_zp_int,
                      w_colsum=self.w_colsum[0])
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
            **tables)
        return out.reshape(*x.shape[:-1], self.features)

    @torch.no_grad()
    def refresh_w_zp_int(self) -> None:
        """Derive `w_zp_int` from the `w_zp` table: asym codes are stored
        shifted into signed int8, so their zero point shifts with them; sym
        codes have zero point 0."""
        wspec = self.lspec.weight
        shift = 0.0 if wspec.sym else float(2 ** (wspec.n_bits - 1))
        self.w_zp_int = self.w_zp[wspec.bit_idx, 0].reshape(1, -1) - shift

    def _native(self, x, prequant, w_q, w_scale):
        """The native int8 path of impl None/'xla'/'mixed'/'pallas'
        (qlinear.py:572-643): K7b on a prequant input, else K7a -> K7b."""
        wspec, aspec = self.lspec.weight, self.lspec.act
        w_zp = self.w_zp_int
        w_colsum = self.w_colsum[0]
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
