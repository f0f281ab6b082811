"""Offline packing into the native int8 layout (port of
`pack_native_weights`, `viditq_tpu/quant/native_pack.py:80-286`).

Fills each quantized `QuantLinear`'s `w_int` [1, K, N] int8 slab, its
`w_colsum` [1, 1, N] and the codes' zero points `w_zp_int` from the fp
kernel and the calibrated `w_delta`/`w_zp`. Same code formula as the JAX package (`round(w / d)`,
clipped): symmetric codes are signed with zero point 0; asymmetric codes
are shifted into signed int8. Timerange slabs, mixed precision and int4
packing are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from viditq_tpu_torch.quant.qlinear import QuantLinear


@torch.no_grad()
def pack_native_weights(model: nn.Module) -> nn.Module:
    for _, mod in model.named_modules():
        if not isinstance(mod, QuantLinear) or not mod.native:
            continue
        wspec = mod.lspec.weight
        bi = wspec.bit_idx
        shift = float(2 ** (wspec.n_bits - 1))
        kernel = mod.kernel.float()
        d = mod.w_delta[bi, 0].reshape(1, -1)
        if wspec.sym:
            code = torch.clamp(torch.round(kernel / d), -shift, shift - 1)
        else:
            z = mod.w_zp[bi, 0].reshape(1, -1)
            code = torch.clamp(torch.round(kernel / d) + z, 0,
                               float(2 ** wspec.n_bits) - 1) - shift
        mod.w_int.copy_(code.to(torch.int8)[None])
        mod.w_colsum.copy_(code.sum(dim=0, keepdim=True)[None])
        mod.refresh_w_zp_int()
    return model
