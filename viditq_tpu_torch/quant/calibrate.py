"""Offline calibration (port of `calibrate_weight_tables` and
`finalize_act_tables`, `viditq_tpu/quant/calibrate.py:101-313`: min-max
weight and static act tables), and the smooth-quant statistic pass that
precedes them under channel balancing.

The JAX function maps (params, quant) trees to a new quant tree; the port
fills the buffers of every `QuantLinear` of a model in place. The PTQ
phase order of a channel-balancing (CB) plan (`pipelines/ptq.py:127-150`):

  1. `smooth_quant_stats`: 'sq_stat' forwards -> each layer's `act_scale`
     [n_timerange, K] (momentum act maxima, one forward per timerange at
     least);
  2. `calibrate_weight_tables`: `cb_scale` = smooth_quant_scale(act_scale,
     weight absmax, alpha) per timerange (pooled over q/k/v under
     `qkv_share_cs`), then `w_delta`/`w_zp` per timerange on kernel * cs;
  3. `native_pack.pack_native_weights`: the int8 slabs (native layers);
  4. for static acts, 'a_calib' forwards (`pipelines/ptq.py`), then
     `finalize_act_tables`: `a_delta`/`a_zp` from the blended ranges.

On a timestep-wise mixed-precision union model (`pipelines/
mixed_precision.py`, its act statistics gathered from the CB model by CB
timerange) the same calibration gives every union span its cb_scale with
its CB range's alpha, and tables at every bitwidth of `bits_tuple`, which
the packing reads at each span's `mp_bits`.

Scanned stacks and AdaRound alphas are not ported (the port's models are
unrolled).
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear


@torch.no_grad()
def smooth_quant_stats(model: nn.Module, x: torch.Tensor, y: torch.Tensor,
                       mask, t_ids: Iterable[int]) -> nn.Module:
    """Phase 1: one 'sq_stat' forward of the model on (x, y, mask) at each
    diffusion timestep of t_ids (the model's timestep input and the
    context's t_id, which selects the timerange whose `act_scale` the
    forward accumulates). The forwards are the fp model's."""
    for t in t_ids:
        tt = torch.full((x.shape[0],), float(t), device=x.device)
        model(x, tt, y, mask, qctx=QuantCtx(t_id=int(t), mode="sq_stat"))
    return model


def _absmax(kernel: torch.Tensor) -> torch.Tensor:
    return kernel.float().abs().amax(dim=-1)


def _pooled_absmax(model: nn.Module, name: str, mod: QuantLinear):
    """Per-input-channel weight absmax; under `qkv_share_cs` for a q/k/v
    sibling, the max over the three kernels (calibrate.py:176-189: the
    fused-qkv granularity of the upstream attention)."""
    parent, _, leaf = name.rpartition(".")
    if not mod.smooth.qkv_share_cs or leaf not in ("q", "k", "v"):
        return _absmax(mod.kernel)
    owner = model.get_submodule(parent) if parent else model
    sibs = [getattr(owner, n, None) for n in ("q", "k", "v")]
    if not all(isinstance(s, QuantLinear) for s in sibs):
        return _absmax(mod.kernel)
    return torch.stack([_absmax(s.kernel) for s in sibs]).amax(dim=0)


@torch.no_grad()
def calibrate_weight_tables(model: nn.Module) -> nn.Module:
    """Fill every CB layer's cb_scale [n_tr, K] from its act_scale, then
    every quantized layer's w_delta/w_zp [n_bw, n_tr, 1, F] from its fp
    kernel (times cs of each timerange under CB)."""
    layers = [(n, m) for n, m in model.named_modules()
              if isinstance(m, QuantLinear)]
    # cs first: pooled siblings' tables depend on each other's kernels
    # (calibrate.py:154-219); fp-listed layers get theirs too. The
    # 'dynamic' CB type has no table: its forward computes cs.
    for name, mod in layers:
        if not mod.momentum_cb:
            continue
        smooth = mod.smooth
        wmax = _pooled_absmax(model, name, mod)
        mod.cb_scale.copy_(torch.stack([
            core.smooth_quant_scale(mod.act_scale[tr], wmax,
                                    smooth.alpha_for_range(tr))
            for tr in range(smooth.n_timerange)]))
    for _, mod in layers:
        if not hasattr(mod, "w_delta"):
            continue
        wspec = mod.lspec.weight
        kernel = mod.kernel.float()
        n_tr = mod.w_delta.shape[1]
        deltas, zps = [], []
        for b in wspec.bits_tuple:
            d_tr, z_tr = [], []
            for tr in range(n_tr):
                w_eff = (kernel * mod.cb_scale[tr][:, None]
                         if mod.momentum_cb else kernel)
                d, z = core.compute_qparams(w_eff, wspec, n_bits=b)
                d_tr.append(d)
                z_tr.append(z)
            deltas.append(torch.stack(d_tr))
            zps.append(torch.stack(z_tr))
        mod.w_delta.copy_(torch.stack(deltas))
        mod.w_zp.copy_(torch.stack(zps))
    return model


@torch.no_grad()
def finalize_act_tables(model: nn.Module) -> nn.Module:
    """Every static-act layer's a_delta/a_zp [n_bw, n_ts, 1, *group] from
    its blended a_min/a_max, at every bitwidth of `bits_tuple`
    (calibrate.py:286-313; 'min_max' only, as every reference act plan)."""
    for _, mod in model.named_modules():
        if not (isinstance(mod, QuantLinear) and mod.static_act):
            continue
        aspec = mod.lspec.act
        d, z = zip(*(core.qparams_minmax(mod.a_min, mod.a_max, aspec,
                                         n_bits=b)
                     for b in aspec.bits_tuple))
        mod.a_delta = torch.stack(d)
        mod.a_zp = torch.stack(z)
    return model
