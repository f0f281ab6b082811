"""Plain int8 oracles (port of `viditq_tpu/kernels/int_matmul.py:224-358`).

`pack_weight`, `dynamic_quant_rows_ref` and `int8_matmul_ref` are the
JAX package's jnp reference implementations, written as plain tensor
functions. They are oracles: the port's execution path runs the fused
kernels in `fused_matmul.py`. Note the quantize form here is
`round(x / scale)`, the JAX site's own (C6 in ROADMAP.md); the fused
kernels use `round(x * (1 / scale))`.
"""

from __future__ import annotations

import torch


def pack_weight(kernel: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                n_bits: int = 8, sym: bool = False) -> dict:
    """Quantize a [K, N] kernel offline into the int8 layout; delta/zp
    broadcast as [1, N]. Asym codes are shifted by -2^(b-1) into signed
    int8; sym codes are signed with zero point 0."""
    kernel = kernel.float()
    delta = delta.reshape(1, -1).float()
    zp = zp.reshape(1, -1).float()
    if sym:
        half = float(2 ** (n_bits - 1))
        code = torch.clamp(torch.round(kernel / delta), -half, half - 1)
        w_zp = torch.zeros_like(delta)
    else:
        shift = float(2 ** (n_bits - 1))
        n_levels = float(2 ** n_bits)
        code = torch.clamp(torch.round(kernel / delta) + zp, 0,
                           n_levels - 1) - shift
        w_zp = zp - shift
    colsum = code.sum(dim=0, keepdim=True)
    return {"w_q": code.to(torch.int8), "w_scale": delta, "w_zp": w_zp,
            "w_colsum": colsum}


def dynamic_quant_rows_ref(x: torch.Tensor, sym: bool = False):
    """Per-row dynamic int8 quantize -> (codes, scale, zp, rowsum)."""
    x = x.float()
    if sym:
        absmax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(absmax / 127.0, min=1e-6)
        zp = torch.zeros_like(scale)
        q = torch.clamp(torch.round(x / scale), -128, 127)
    else:
        x_min = torch.clamp(x.amin(dim=-1, keepdim=True), max=0.0)
        x_max = torch.clamp(x.amax(dim=-1, keepdim=True), min=0.0)
        scale = torch.clamp((x_max - x_min) / 255.0, min=1e-6)
        zp = torch.round(-x_min / scale) - 128.0
        q = torch.clamp(torch.round(x / scale) + zp, -128, 127)
    return q.to(torch.int8), scale, zp, q.sum(dim=-1, keepdim=True)


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two int8 matrices as float32-convertible
    values: float64 is exact below 2^53, which covers any K the models use
    (|acc| <= 128 * 128 * K). float32 is not: at K=4608, |acc| can pass
    2^24."""
    return torch.matmul(a.double(), b.double())


def int8_matmul_ref(x_q, w_q, x_scale, x_zp, x_rowsum, w_scale, w_zp,
                    w_colsum, out_dtype=torch.float32):
    acc = exact_int_matmul(x_q, w_q).float()
    K = x_q.shape[1]
    corrected = acc - x_zp * w_colsum - w_zp * x_rowsum + K * x_zp * w_zp
    return (corrected * x_scale * w_scale).to(out_dtype)
