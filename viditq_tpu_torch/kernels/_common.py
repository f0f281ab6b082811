"""Helpers shared by the kernel wrappers: device dispatch, argument checks,
correctly rounded divisions by a constant and the exact int8 product of
the plain versions."""

from __future__ import annotations

import torch


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"unsupported device {dev}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as a correctly rounded division (`c / tensor` in PyTorch is
    `tensor.reciprocal() * c`, a different rounding)."""
    return torch.full_like(t, c) / t


def divc(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as a correctly rounded division (on CUDA tensors, `tensor / c`
    with a Python scalar is `tensor * (1 / c)`, a different rounding)."""
    return t / torch.full_like(t, c)


def is_bf16(t: torch.Tensor) -> int:
    require(t.dtype in (torch.bfloat16, torch.float32),
            f"expected bfloat16 or float32, got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def k_major(w: torch.Tensor) -> torch.Tensor:
    """The same [K, N] values as a view of [N, K] storage: the layout the
    int8 GEMM kernels read (the s8 wgmma and TMA take the weight K-major)."""
    return w.t().contiguous().t()


def require_k_major(w_q: torch.Tensor) -> None:
    """The CUDA int8 GEMMs read w_q [K, N] as its [N, K] storage; a
    row-major weight raises (no per-call transpose on the card)."""
    if w_q.dim() == 2 and (w_q.stride() == (1, w_q.shape[0])
                           or w_q.t().is_contiguous()):
        return
    raise ValueError(
        f"w_q must be K-major, a [K, N] view of [N, K] storage "
        f"(QuantLinear.w_int's layout; `k_major(w)` makes one), got shape "
        f"{tuple(w_q.shape)} strides {w_q.stride()}")


def f32_flat(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous float32 (its elements in order, for a kernel that
    reads them as a flat array); t itself when it already is."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def col_scale_arg(cs, n: int):
    """A column scale (the channel-balancing 1/cs of the consuming layer)
    as the kernels read it: n contiguous float32 values at a 16-byte
    aligned address (a copy where cs is not), or None."""
    if cs is None:
        return None
    t = f32_flat(cs)
    require(t.numel() == n, f"col_scale must have {n} elements, got "
            f"{t.numel()}")
    return t if t.data_ptr() % 16 == 0 else t.clone()


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two int8 matrices as float32-convertible
    values: float64 is exact below 2^53, which covers any K the models use
    (|acc| <= 128 * 128 * K). float32 is not: at K=4608, |acc| can pass
    2^24."""
    return torch.matmul(a.double(), b.double())
