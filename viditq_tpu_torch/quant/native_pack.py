"""Offline packing into the native int8 layout (port of
`pack_native_weights`, `viditq_tpu/quant/native_pack.py:80-286`).

Fills each quantized `QuantLinear`'s `w_int` [n_tr, K, N] int8 slabs, its
`w_colsum` [n_tr, 1, N] and the codes' zero points `w_zp_int` from the fp
kernel and the calibrated `w_delta`/`w_zp`. One slab per channel-balancing
timerange, of kernel * cs[tr] (`cb_scale`), quantized with timerange tr's
tables, or timerange 0's under `frozen_tr0_weights` (native_pack.py:
208-286). Same code formula as the JAX package (`round(w / d)`, clipped;
a layer with AdaRound's `w_alpha` rounds by it, `floor(w / d) + (alpha >=
0)`, native_pack.py:136-146, :200-205, so the native paths keep what the
reconstruction learned):
symmetric codes are signed with zero point 0; asymmetric codes are
shifted by 2^(b-1) into signed int8 (4-bit codes too: one code a byte, as
the full-native path reads them). Static-act native layers pack as the
dynamic ones. Weight-only layers pack as well, their asym 4-bit codes
unsigned and two a byte (the even row's code in the low nibble,
native_pack.py:212-216), with the unsigned codes' column sums.

Timerange-gathered mixed precision (native_pack.py:111-126, 208-286): a
layer whose spec carries `mp_bits` packs timerange tr at mp_bits[tr] (its
tables at that bitwidth, shift 2^(bits-1), 2^bits levels) and fills its
per-timerange dequant tables `w_mp_scale` = d and `w_mp_zp` = z - shift (0
for sym). Every other layer packs each timerange at `n_bits`. The port
packs each module from its own spec, so the JAX package's check that a
packing resolver agrees with the model's slots has no counterpart.
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
        n_tr = mod.w_int.shape[0]
        bits_tr = wspec.mp_bits or (wspec.n_bits,) * n_tr
        kernel = mod.kernel.float()
        for tr in range(n_tr):
            bits = bits_tr[tr]
            bi = wspec.bits_tuple.index(bits)
            shift = float(2 ** (bits - 1))
            w_eff = (kernel * mod.cb_scale[tr][:, None]
                     if mod.momentum_cb else kernel)
            tw = mod.table_timerange(tr)
            d = mod.w_delta[bi, tw].reshape(1, -1)
            rounded = _round_codes(w_eff, d, mod.w_alpha if mod.adaround
                                   else None)
            if wspec.sym:
                code = torch.clamp(rounded, -shift, shift - 1)
                zp = torch.zeros_like(d)
            elif mod.pack4:
                z = mod.w_zp[bi, tw].reshape(1, -1)
                code = torch.clamp(rounded + z, 0, float(2 ** bits) - 1)
                mod.w_int[tr].copy_(_nibbles(code))
                mod.w_colsum[tr].copy_(code.sum(dim=0, keepdim=True))
                continue
            else:
                z = mod.w_zp[bi, tw].reshape(1, -1)
                code = torch.clamp(rounded + z, 0,
                                   float(2 ** bits) - 1) - shift
                zp = z - shift
            mod.w_int[tr].copy_(code.to(torch.int8))
            mod.w_colsum[tr].copy_(code.sum(dim=0, keepdim=True))
            if mod.mp:
                mod.w_mp_scale[tr].copy_(d)
                mod.w_mp_zp[tr].copy_(zp)
        mod.refresh_w_zp_int()
    return model


def _round_codes(w_eff: torch.Tensor, d: torch.Tensor, w_alpha):
    """Nearest, or AdaRound's learned hard rounding where alphas exist
    (native_pack.py:200-205)."""
    scaled = w_eff / d
    if w_alpha is None:
        return torch.round(scaled)
    return torch.floor(scaled) + (w_alpha >= 0).to(scaled.dtype)


def _nibbles(code: torch.Tensor) -> torch.Tensor:
    """Unsigned 4-bit codes [K, N] -> [(K+1)//2, N] bytes as int8: row 2i
    in the low nibble, row 2i+1 in the high one (K padded with a zero
    row)."""
    c = code.to(torch.int32)
    if c.shape[0] % 2:
        c = torch.cat([c, torch.zeros_like(c[:1])])
    pairs = c.reshape(-1, 2, c.shape[-1])
    b = pairs[:, 0] | (pairs[:, 1] << 4)
    return torch.where(b > 127, b - 256, b).to(torch.int8)
