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


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product of two int8 matrices as float32-convertible
    values: float64 is exact below 2^53, which covers any K the models use
    (|acc| <= 128 * 128 * K). float32 is not: at K=4608, |acc| can pass
    2^24."""
    return torch.matmul(a.double(), b.double())
