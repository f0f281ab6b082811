"""Offline packing into the native int8 layout (port of
`pack_native_weights`, `viditq_tpu/quant/native_pack.py:80-286`).

Fills each quantized `QuantLinear`'s `w_int` [n_tr, K, N] int8 slabs, its
`w_colsum` [n_tr, 1, N] and the codes' zero points `w_zp_int` from the fp
kernel and the calibrated `w_delta`/`w_zp`. One slab per channel-balancing
timerange, of kernel * cs[tr] (`cb_scale`), quantized with timerange tr's
tables, or timerange 0's under `frozen_tr0_weights` (native_pack.py:
208-286). Same code formula as the JAX package (`round(w / d)`, clipped):
symmetric codes are signed with zero point 0; asymmetric codes are
shifted by 2^(b-1) into signed int8 (4-bit codes too: one code a byte, as
the full-native path reads them). Mixed-precision slabs and the int4
nibble packing of weight-only layers are not ported.
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
        for tr in range(mod.w_int.shape[0]):
            w_eff = (kernel if mod.smooth is None
                     else kernel * mod.cb_scale[tr][:, None])
            tw = mod.table_timerange(tr)
            d = mod.w_delta[bi, tw].reshape(1, -1)
            if wspec.sym:
                code = torch.clamp(torch.round(w_eff / d), -shift, shift - 1)
            else:
                z = mod.w_zp[bi, tw].reshape(1, -1)
                code = torch.clamp(torch.round(w_eff / d) + z, 0,
                                   float(2 ** wspec.n_bits) - 1) - shift
            mod.w_int[tr].copy_(code.to(torch.int8))
            mod.w_colsum[tr].copy_(code.sum(dim=0, keepdim=True))
        mod.refresh_w_zp_int()
    return model
