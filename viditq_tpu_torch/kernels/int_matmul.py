"""Native int8 linear: dynamic per-token quantize (K7a) and the int8 matmul
with the zero-point-corrected dequant epilogue (K7b). Port of
`viditq_tpu/kernels/int_matmul.py`.

  K7a `dynamic_quant_rows`  csrc/int_matmul.cu `vq_dyn_quant_rows`
  K7b `int8_matmul`         csrc/int_matmul.cu `vq_int8_matmul`

Each wrapper runs its plain version (`*_plain`: the JAX package's jnp
oracles `dynamic_quant_rows_ref` / `int8_matmul_ref` written as tensor
functions, plus the caller's bias add) on CPU tensors and launches its
kernel on CUDA tensors, or raises. The quantize form is `round(x / scale)`, the JAX site's own (C6 in
ROADMAP.md); the fused kernels of `fused_matmul.py` use
`round(x * (1 / scale))`. Every division by a constant is a true division
(`divc`), as in the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels._common import (divc, exact_int_matmul,
                                              f32_flat, is_bf16, k_major,
                                              on_cuda, require,
                                              require_k_major)
from viditq_tpu_torch.kernels._counters import COUNTERS, count_plain
from viditq_tpu_torch.kernels.fused_matmul import fused_dynq_int8_matmul

# the implementations `LayerQuantSpec.impl` names (None = the default)
IMPLS = (None, "xla", "mixed", "pallas", "fused")


def pack_weight(kernel: torch.Tensor, delta: torch.Tensor, zp: torch.Tensor,
                n_bits: int = 8, sym: bool = False) -> dict:
    """Quantize a [K, N] kernel offline into the int8 layout (w_q K-major,
    as the kernels read it); delta/zp broadcast as [1, N]. Asym codes are
    shifted by -2^(b-1) into signed int8; sym codes are signed with zero
    point 0."""
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
    return {"w_q": k_major(code.to(torch.int8)), "w_scale": delta,
            "w_zp": w_zp,
            "w_colsum": colsum}


# ---------------------------------------------------------------------------
# K7a: dynamic per-row quantize
# ---------------------------------------------------------------------------

def dynamic_quant_rows_plain(x: torch.Tensor, sym: bool = False):
    """Per-row dynamic int8 quantize -> (codes, scale, zp, rowsum)."""
    count_plain("dynamic_quant_rows", x)
    x = x.float()
    if sym:
        absmax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(divc(absmax, 127.0), min=1e-6)
        zp = torch.zeros_like(scale)
        q = torch.clamp(torch.round(x / scale), -128, 127)
    else:
        x_min = torch.clamp(x.amin(dim=-1, keepdim=True), max=0.0)
        x_max = torch.clamp(x.amax(dim=-1, keepdim=True), min=0.0)
        scale = torch.clamp(divc(x_max - x_min, 255.0), min=1e-6)
        zp = torch.round(-x_min / scale) - 128.0
        q = torch.clamp(torch.round(x / scale) + zp, -128, 127)
    return q.to(torch.int8), scale, zp, q.sum(dim=-1, keepdim=True)


def dynamic_quant_rows(x: torch.Tensor, sym: bool = False):
    """[M, K] bf16/f32 -> (codes int8 [M, K], scale, zp, rowsum: f32
    [M, 1]). Asym: `s = max((max(x, 0) - min(x, 0)) / 255, 1e-6)`,
    `zp = round(-min / s) - 128`, `q = clip(round(x / s) + zp)`; sym:
    `s = max(absmax / 127, 1e-6)`, `zp = 0`; rowsum = sum of the codes."""
    if not on_cuda(x):
        return dynamic_quant_rows_plain(x, sym)
    require(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [M, K]")
    M, K = x.shape
    bf16 = is_bf16(x)
    require((K * x.element_size()) % 16 == 0 and x.data_ptr() % 16 == 0,
            f"rows must be 16-byte aligned (K={K}, {x.dtype})")
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    scale, zp, rowsum = (torch.empty((M, 1), dtype=torch.float32,
                                     device=x.device) for _ in range(3))
    _build.check(_build.lib().vq_dyn_quant_rows(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), zp.data_ptr(),
        rowsum.data_ptr(), M, K, int(sym), bf16, _build.stream_ptr(x)),
        "vq_dyn_quant_rows")
    COUNTERS["dynamic_quant_rows"].launches += 1
    return q, scale, zp, rowsum


# ---------------------------------------------------------------------------
# K7b: int8 matmul with the zero-point-corrected dequant epilogue
# ---------------------------------------------------------------------------

def int8_matmul_plain(x_q, w_q, x_scale, x_zp, x_rowsum, w_scale, w_zp,
                      w_colsum, out_dtype=torch.bfloat16, bias=None):
    count_plain("int8_matmul", x_q)
    acc = exact_int_matmul(x_q, w_q).float()
    K = x_q.shape[1]
    corrected = acc - x_zp * w_colsum - w_zp * x_rowsum + K * x_zp * w_zp
    out = (corrected * x_scale * w_scale).to(out_dtype)
    if bias is not None:
        out = out + bias.to(out_dtype)
    return out


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                x_zp: torch.Tensor, x_rowsum: torch.Tensor,
                w_scale: torch.Tensor, w_zp: torch.Tensor,
                w_colsum: torch.Tensor, out_dtype=torch.bfloat16,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] out_dtype (bf16 or f32). On the
    card w_q must be K-major (`_common.k_major`); the plain version takes
    either layout.

    x_scale/x_zp/x_rowsum: [M, 1] f32; w_scale/w_zp/w_colsum: [1, N] f32.
    `out = ((acc - xzp*wcs - wzp*xrs + (K*xzp)*wzp) * xs) * ws` in f32,
    rounded to out_dtype; then `+ bias.to(out_dtype)` in out_dtype (the
    JAX caller's bias add, `int_matmul.py:325-326`), fused into the
    kernel's epilogue with the same two roundings."""
    tables = (x_scale, x_zp, x_rowsum, w_scale, w_zp, w_colsum)
    if not on_cuda(x_q, w_q, *tables, bias):
        return int8_matmul_plain(x_q, w_q, *tables, out_dtype, bias)
    M, K = x_q.shape
    K2, N = w_q.shape
    require(K == K2, f"K mismatch {K} != {K2}")
    require(x_q.dtype == torch.int8 and w_q.dtype == torch.int8,
            "x_q and w_q must be int8")
    require_k_major(w_q)
    require(x_q.is_contiguous(), "x_q must be contiguous")
    for name, t, shape in (("x_scale", x_scale, (M, 1)),
                           ("x_zp", x_zp, (M, 1)),
                           ("x_rowsum", x_rowsum, (M, 1)),
                           ("w_scale", w_scale, (1, N)),
                           ("w_zp", w_zp, (1, N)),
                           ("w_colsum", w_colsum, (1, N))):
        if not (t.shape == shape and t.dtype == torch.float32
                and t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"{list(shape)}")
    require(out_dtype in (torch.bfloat16, torch.float32),
            f"unsupported out_dtype {out_dtype}")
    require(bias is None or bias.numel() == N, "bias must have N elements")
    lib = _build.lib()
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    b = None if bias is None else f32_flat(bias)
    _build.check(lib.vq_int8_matmul(
        x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(), x_zp.data_ptr(),
        x_rowsum.data_ptr(), w_scale.data_ptr(), w_zp.data_ptr(),
        w_colsum.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), M, N, K, int(out_dtype == torch.float32),
        _build.stream_ptr(x_q)), "vq_int8_matmul")
    COUNTERS["int8_matmul"].launches += 1
    return out


# ---------------------------------------------------------------------------
# the quantized linear of the native backend
# ---------------------------------------------------------------------------

def quantized_linear_native(x: torch.Tensor, packed: dict,
                            bias: Optional[torch.Tensor] = None,
                            act_sym: bool = False, w_sym: bool = False,
                            out_dtype=torch.bfloat16,
                            impl: Optional[str] = None,
                            residual: Optional[torch.Tensor] = None,
                            gate: Optional[torch.Tensor] = None,
                            col_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """W8A8 linear (`int_matmul.py:270-327`): dynamic per-token int8 act
    quantize + int8 matmul. x [..., K]; `packed`: w_q [K, N] int8 and
    w_scale / w_zp / w_colsum [1, N] f32.

    impl 'fused' runs the fused kernels' quantize-in matmul (K5). The JAX
    package's other impls, None/'xla' (jnp oracles), 'mixed' (K7a + XLA
    dot) and 'pallas' (K7a + K7b), compute the same numbers, so the port
    runs them as one dataflow: K7a, then K7b with the bias added in
    out_dtype. col_scale [K] (the smooth-quant 1/cs of channel balancing):
    folded into K5's quantize under 'fused'; otherwise x times it in one
    f32 pass, kept in f32 for K7a (`int_matmul.py:307-308`: the JAX package
    computes it outside its kernels too). residual [M, N] (and gate [G, N])
    go to K5's residual (+ gate) epilogue; only impl 'fused' takes them
    (`:294-295`)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown native impl {impl!r}")
    assert residual is None or impl == "fused", \
        "residual epilogue only on the fused impl"
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    if impl == "fused":
        out = fused_dynq_int8_matmul(x2, packed["w_q"], packed["w_scale"],
                                     bias, out_dtype, sym=act_sym,
                                     sym_w=w_sym, w_zp=packed["w_zp"],
                                     w_colsum=packed["w_colsum"],
                                     residual=residual, gate=gate,
                                     col_scale=col_scale)
        return out.reshape(*lead, -1)
    if col_scale is not None:
        x2 = x2.float() * col_scale.reshape(1, K).float()
    x_q, xs, xzp, xrs = dynamic_quant_rows(x2, sym=act_sym)
    out = int8_matmul(x_q, packed["w_q"], xs, xzp, xrs, packed["w_scale"],
                      packed["w_zp"], packed["w_colsum"], out_dtype, bias)
    return out.reshape(*lead, -1)
