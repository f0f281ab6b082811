"""Fused int8 dataflow: the W8A8 execution path's kernels (K1, K2, K4, K5).

Port of `viditq_tpu/kernels/fused_matmul.py`. Each public function is a
wrapper: on CPU tensors it runs its plain PyTorch version (`*_plain`, same
module, same numerics as the TPU kernel); on CUDA tensors it launches the
hand-written kernel from `viditq_tpu_torch/csrc` or raises. There is no
fallback between the two.

  K1 `ln_modulate_quantize`   csrc/ln_mod_quant.cu
  K2 `int8_consumer_matmul`   csrc/int8_gemm.cu (plain, gw_x, emit)
  K4 `quantize_rows`          csrc/quant_rows.cu
  K5 `fused_dynq_int8_matmul` served as a K4 launch then a K2 launch: it
     computes exactly what K4 followed by K2 computes (same row quantizer,
     same sym x sym epilogue).

Only the symmetric-act x symmetric-weight modes are ported. The asym zero
point terms, the residual/gate epilogue, the column scales and K4's GELU
raise NotImplementedError.

The three quantize forms stay as the JAX sites write them (C6):
K1/K4/K5 `round(x * (1/s))` with `s = max(absmax/127, 1e-6)`; K2's emit
`s = max(absmax * (1/127), 1e-6)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels._common import (exact_int_matmul, f32_flat,
                                              is_bf16, on_cuda, rdiv,
                                              require, require_k_major)
from viditq_tpu_torch.kernels._counters import COUNTERS, count_plain

_SQRT_2_OVER_PI = 0.7978845608028654


def emission_block_n(n: int, block_m: int = 512, block_k: int = 2304) -> int:
    """Column-group width of K2's int8 emission (`fused_matmul.py:98-115`).

    The TPU kernel's N-block sets the group of the emitted scales, so this
    rule fixes numerics, not just tiling (C1): at fc1 ([*, 1152] x
    [1152, 4608], called with block_k = min(2304, K) = 1152) it gives 1536,
    i.e. 3 groups. Returns 0 when no width qualifies."""
    for bn in range(min(n, 2304), 0, -128):
        if n % bn:
            continue
        if (4 * block_m * bn + 2 * block_k * bn + 2 * block_m * bn
                + 2 * block_m * block_k) <= 13_000_000:
            return bn
    return 0


def select_block_k(k: int, block_k: int) -> int:
    """Largest divisor of k not above block_k (`fused_matmul.py:89-95`)."""
    block_k = min(block_k, k)
    if k % block_k:
        block_k = next(d for d in range(block_k, 0, -1) if k % d == 0)
    return block_k


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def quantize_rows_f32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_quantize_rows_f32` (sym): float codes and [.., 1] scales."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-6)
    q = torch.clamp(torch.round(x * rdiv(1.0, scale)), -128, 127)
    return q, scale


def gelu_tanh(o: torch.Tensor) -> torch.Tensor:
    """tanh-GELU in the JAX kernel's operation order (o^3 as (o*o)*o)."""
    return 0.5 * o * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (o + 0.044715 * (o * o * o))))


def _sym_only(sym: bool = True, sym_w: bool = True, **unsupported):
    if not sym:
        raise NotImplementedError("asymmetric activation codes are not ported")
    if not sym_w:
        raise NotImplementedError("asymmetric weight codes are not ported")
    for name, val in unsupported.items():
        if val is not None and val is not False:
            raise NotImplementedError(f"{name} is not ported")


# ---------------------------------------------------------------------------
# K1: LayerNorm + t2i modulate + row quantize
# ---------------------------------------------------------------------------

def ln_modulate_quantize_plain(x: torch.Tensor, shift: torch.Tensor,
                               scale: torch.Tensor, eps: float = 1e-6):
    count_plain("ln_modulate_quantize", x)
    B, N, C = x.shape
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = (y * (1.0 + scale.float().reshape(B, 1, C))
         + shift.float().reshape(B, 1, C))
    q, s = quantize_rows_f32(y)
    return q.reshape(B * N, C).to(torch.int8), s.reshape(B * N, 1)


def ln_modulate_quantize(x: torch.Tensor, shift: torch.Tensor,
                         scale: torch.Tensor, sym: bool = True,
                         eps: float = 1e-6):
    """[B, N, C] -> (int8 codes [B*N, C], scales [B*N, 1] f32).

    shift/scale: [B, 1, C] per-batch adaLN vectors. Non-affine LN, eps
    1e-6, then `y*(1+scale)+shift`, then the sym row quantize."""
    _sym_only(sym=sym)
    if not on_cuda(x, shift, scale):
        return ln_modulate_quantize_plain(x, shift, scale, eps)
    B, N, C = x.shape
    shift = shift.reshape(B, 1, C).contiguous()
    scale = scale.reshape(B, 1, C).contiguous()
    require(x.is_contiguous(), "x must be contiguous")
    require(shift.dtype == x.dtype and scale.dtype == x.dtype,
            "shift/scale must have x's dtype")
    q = torch.empty((B * N, C), dtype=torch.int8, device=x.device)
    qs = torch.empty((B * N, 1), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().vq_ln_mod_quant(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), q.data_ptr(),
        qs.data_ptr(), B, N, C, float(eps), is_bf16(x),
        _build.stream_ptr(x)), "vq_ln_mod_quant")
    COUNTERS["ln_modulate_quantize"].launches += 1
    return q, qs


# ---------------------------------------------------------------------------
# K4: row quantize
# ---------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor):
    count_plain("quantize_rows", x)
    q, s = quantize_rows_f32(x.float())
    return q.to(torch.int8), s


def quantize_rows(x: torch.Tensor, sym: bool = True, gelu: bool = False,
                  col_scale: Optional[torch.Tensor] = None):
    """[M, K] -> (int8 codes [M, K], scales [M, 1] f32)."""
    _sym_only(sym=sym, gelu=gelu, col_scale=col_scale)
    if not on_cuda(x):
        return quantize_rows_plain(x)
    require(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [M, K]")
    M, K = x.shape
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    qs = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().vq_quant_rows(
        x.data_ptr(), q.data_ptr(), qs.data_ptr(), M, K, is_bf16(x),
        _build.stream_ptr(x)), "vq_quant_rows")
    COUNTERS["quantize_rows"].launches += 1
    return q, qs


# ---------------------------------------------------------------------------
# K2: int8 consumer matmul
# ---------------------------------------------------------------------------

def emit_groups(n: int, k: int) -> int:
    """Group width of the emission at an [*, k] x [k, n] consumer, taken
    from the runtime call (`fused_matmul.py:455-456`)."""
    bn = emission_block_n(n, 512, min(2304, k))
    if not bn:
        raise ValueError(f"no emission group width divides N={n}")
    return bn


def int8_consumer_matmul_plain(x_q, x_scale, w_q, w_scale, bias=None,
                               out_dtype=torch.bfloat16,
                               group_scales: bool = False, emit=None):
    count_plain("int8_consumer_matmul", x_q)
    M, K = x_q.shape
    N = w_q.shape[1]
    ws = w_scale.reshape(1, N).float()
    if group_scales:
        G = x_scale.shape[1]
        kg = K // G
        out = torch.zeros((M, N), dtype=torch.float32, device=x_q.device)
        for g in range(G):
            p = exact_int_matmul(x_q[:, g * kg:(g + 1) * kg],
                                 w_q[g * kg:(g + 1) * kg]).float()
            out = out + p * x_scale[:, g:g + 1].float()
        out = out * ws
    else:
        acc = exact_int_matmul(x_q, w_q).float()
        out = acc * (x_scale.reshape(M, 1).float() * ws)
    if bias is not None:
        out = out + bias.reshape(1, N).float()
    if emit is None:
        return out.to(out_dtype)
    if emit.get("gelu"):
        out = gelu_tanh(out)
    bn = emit_groups(N, K)
    y = out.reshape(M, N // bn, bn)
    absmax = y.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(absmax * (1.0 / 127.0), min=1e-6)
    codes = torch.clamp(torch.round(y * rdiv(1.0, s)), -128, 127)
    return codes.reshape(M, N).to(torch.int8), s.reshape(M, N // bn)


def int8_consumer_matmul(x_q: torch.Tensor, x_scale: torch.Tensor,
                         w_q: torch.Tensor, w_scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None,
                         out_dtype=torch.bfloat16,
                         group_scales: bool = False,
                         emit: Optional[dict] = None,
                         x_zp=None, w_zp=None, residual=None, gate=None):
    """x_q [M, K] int8 with per-row scales [M, 1] (or, with group_scales,
    one scale per row and k-group [M, G], as K2's emission writes them);
    w_q [K, N] int8 with per-column scales. Returns [M, N] out_dtype.

    On the card w_q must be K-major (`_common.k_major`, QuantLinear's
    `w_int`); the plain version takes either layout.

    emit {'gelu': bool}: instead of the output, apply tanh-GELU and
    quantize each row per group of `emit_groups(N, K)` columns; returns
    (codes [M, N] int8, scales [M, G] f32). The TPU kernel's lane-padded
    [M, G*128] scale layout is not kept: the port stores [M, G]."""
    _sym_only(x_zp=x_zp, w_zp=w_zp, residual=residual, gate=gate,
              col_scale=(emit or {}).get("col_scale"))
    if not on_cuda(x_q, x_scale, w_q, w_scale, bias):
        return int8_consumer_matmul_plain(x_q, x_scale, w_q, w_scale, bias,
                                          out_dtype, group_scales, emit)
    if emit is None:
        require(out_dtype in (torch.bfloat16, torch.float32),
                f"unsupported out_dtype {out_dtype}")
        kind = 0 if out_dtype == torch.bfloat16 else 1
    else:
        bn = emit_groups(w_q.shape[1], x_q.shape[1])
        kind = 2 if emit.get("gelu") else 1
    out = k2_gemm(x_q, x_scale, w_q, w_scale, bias, group_scales, kind)
    COUNTERS["int8_consumer_matmul"].launches += 1
    return out if emit is None else group_quant(out, bn)


def k2_gemm(x_q, x_scale, w_q, w_scale, bias, group_scales: bool,
            kind: int) -> torch.Tensor:
    """The GEMM launch of K2 on CUDA tensors (no count): kind 0 bf16 out, 1
    f32 out, 2 f32 tanh-GELU out (the emission's scratch)."""
    M, K = x_q.shape
    K2, N = w_q.shape
    require(K == K2, f"K mismatch {K} != {K2}")
    require(x_q.dtype == torch.int8 and w_q.dtype == torch.int8,
            "x_q and w_q must be int8")
    require_k_major(w_q)
    require(x_q.is_contiguous(), "x_q must be contiguous")
    G = x_scale.shape[1] if group_scales else 1
    require(x_scale.shape == (M, G) and x_scale.dtype == torch.float32,
            f"x_scale must be float32 [{M}, {G}]")
    require(K % 64 == 0 and (K // G) % 64 == 0 and N % 16 == 0,
            f"kernel needs K % 64 == 0, (K/G) % 64 == 0, N % 16 == 0 "
            f"(K={K}, G={G}, N={N})")
    require(x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0,
            "x_q and w_q must be 16-byte aligned")
    require(w_scale.numel() == N and (bias is None or bias.numel() == N),
            "w_scale and bias must have N elements")
    lib = _build.lib()
    xs = x_scale.contiguous()
    ws = f32_flat(w_scale)
    b = None if bias is None else f32_flat(bias)
    out = torch.empty((M, N), dtype=torch.bfloat16 if kind == 0
                      else torch.float32, device=x_q.device)
    _build.check(lib.vq_int8_gemm(
        x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(), G, ws.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), M, N, K,
        int(group_scales), kind, _build.stream_ptr(x_q)), "vq_int8_gemm")
    return out


def group_quant(y: torch.Tensor, bn: int):
    """The emission's second pass on CUDA tensors (no count): f32 [M, N]
    -> (codes [M, N] int8, scales [M, N / bn] f32), one scale per row and
    group of bn columns."""
    M, N = y.shape
    codes = torch.empty((M, N), dtype=torch.int8, device=y.device)
    scales = torch.empty((M, N // bn), dtype=torch.float32, device=y.device)
    _build.check(_build.lib().vq_group_quant(
        y.data_ptr(), codes.data_ptr(), scales.data_ptr(), M, N, bn,
        _build.stream_ptr(y)), "vq_group_quant")
    return codes, scales


# ---------------------------------------------------------------------------
# K5: quantize-in matmul, served as K4 -> K2
# ---------------------------------------------------------------------------

def fused_dynq_int8_matmul_plain(x, w_q, w_scale, bias=None,
                                 out_dtype=torch.bfloat16):
    count_plain("fused_dynq_int8_matmul", x)
    q, s = quantize_rows_plain(x)
    return int8_consumer_matmul_plain(q, s, w_q, w_scale, bias, out_dtype)


def fused_dynq_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype=torch.bfloat16, sym: bool = True,
                           sym_w: bool = True, residual=None, gate=None,
                           col_scale=None) -> torch.Tensor:
    """x [M, K] float -> [M, N]: quantize rows (K4), then the int8 matmul
    with the dequant epilogue and bias (K2). The TPU kernel does both in
    one pass (`fused_matmul.py:144-309`); a single-pass Hopper kernel is
    later work."""
    _sym_only(sym=sym, sym_w=sym_w, residual=residual, gate=gate,
              col_scale=col_scale)
    q, s = quantize_rows(x)
    out = int8_consumer_matmul(q, s, w_q, w_scale, bias, out_dtype)
    if x.is_cuda:
        COUNTERS["fused_dynq_int8_matmul"].launches += 1
    return out
