"""Offline weight calibration (port of `calibrate_weight_tables`,
`viditq_tpu/quant/calibrate.py:101-283`, min-max weight tables only).

The JAX function maps (params, quant) trees to a new quant tree; the port
fills the `w_delta`/`w_zp` buffers of every quantized `QuantLinear` of a
model in place. Smooth-quant tables, scanned stacks and AdaRound alphas
are not ported (the port's models are unrolled and reject smooth-quant
plans at construction).
"""

from __future__ import annotations

import torch
from torch import nn

from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant.qlinear import QuantLinear


@torch.no_grad()
def calibrate_weight_tables(model: nn.Module) -> nn.Module:
    """Fill w_delta/w_zp [n_bw, 1, 1, F] from each layer's fp kernel."""
    for _, mod in model.named_modules():
        if not isinstance(mod, QuantLinear) or not mod.native:
            continue
        wspec = mod.lspec.weight
        kernel = mod.kernel.float()
        deltas, zps = [], []
        for b in wspec.bits_tuple:
            d, z = core.compute_qparams(kernel, wspec, n_bits=b)
            deltas.append(d)
            zps.append(z)
        mod.w_delta.copy_(torch.stack(deltas)[:, None])
        mod.w_zp.copy_(torch.stack(zps)[:, None])
    return model
