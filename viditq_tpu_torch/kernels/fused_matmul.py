"""Fused int8 dataflow: the W8A8 execution path's kernels (K1, K2, K4, K5).

Port of `viditq_tpu/kernels/fused_matmul.py`. Each public function is a
wrapper: on CPU tensors it runs its plain PyTorch version (`*_plain`, same
module, same numerics as the TPU kernel); on CUDA tensors it launches the
hand-written kernel from `viditq_tpu_torch/csrc` or raises. There is no
fallback between the two.

  K1 `ln_modulate_quantize`   csrc/ln_mod_quant.cu
  K2 `int8_consumer_matmul`   csrc/int8_gemm.cu (plain, gw_x, emit, the
     zero-point-corrected epilogues of asymmetric acts or weights, and the
     residual (+ gate) epilogue on all but the emission; the emission
     after either zero-point epilogue)
  K4 `quantize_rows`          csrc/quant_rows.cu (optionally tanh-GELU first)
  K5 `fused_dynq_int8_matmul` csrc/dynq_gemm.cu: one launch that quantizes
     each M tile's rows into shared memory and runs K2's GEMM and epilogues
     on them; its output equals K4 followed by K2 bit for bit (same row
     quantizer, same epilogue, the residual (+ gate) one included). It
     takes K <= 1152 (`K5_MAX_K`: the tile's codes stay resident in shared
     memory) and raises on wider K.

Both act quantizers are ported, symmetric and asymmetric (shifted-signed
codes with a zero point and the code row sum), and both weight kinds, and
the column scales of channel balancing (`col_scale`: the consuming
layer's smooth-quant 1/cs, multiplied in f32 before the row statistic, and
after the GELU where there is one): K4's, K5's (`has_csc`) and K2's
emission (`has_ecs`). The residual (+ gate) epilogue, `o = res + gate *
out` after the bias in f32 (`_consumer_kernel`, `fused_matmul.py:383-390`;
`_dynq_mm_kernel`, `:192-205`), runs inside K2 and K5; on the card it takes
bf16 residual, gate and output. K2's group-wise mode takes sym x sym
only, as in JAX.

The three quantize forms stay as the JAX sites write them (C6):
K1/K4/K5 `round(x * (1/s))` with `s = max(absmax/127, 1e-6)` or, asym,
`s = max((max(x, 0) - min(x, 0)) / 255, 1e-6)`; K2's emit
`s = max(absmax * (1/127), 1e-6)`.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels._common import (col_scale_arg, divc,
                                              exact_int_matmul, f32_flat,
                                              is_bf16, on_cuda, rdiv, require,
                                              require_k_major)
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

def quantize_rows_f32(x: torch.Tensor, sym: bool = True):
    """`_quantize_rows_f32` (`fused_matmul.py:118-137`): float codes and
    [.., 1] scales and zero points (None when sym). Asym codes are shifted
    into signed int8: `zp = round(-min * (1/s)) - 128`."""
    if sym:
        absmax = x.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(absmax / 127.0, min=1e-6)
        q = torch.clamp(torch.round(x * rdiv(1.0, scale)), -128, 127)
        return q, scale, None
    x_min = torch.clamp(x.amin(dim=-1, keepdim=True), max=0.0)
    x_max = torch.clamp(x.amax(dim=-1, keepdim=True), min=0.0)
    scale = torch.clamp(divc(x_max - x_min, 255.0), min=1e-6)
    inv = rdiv(1.0, scale)
    zp = torch.round(-x_min * inv) - 128.0
    q = torch.clamp(torch.round(x * inv) + zp, -128, 127)
    return q, scale, zp


def _row_outputs(q, scale, zp, need_rowsum: bool):
    """(int8 codes, scale, zp | None, rowsum | None) as the JAX producers
    return them: the code row sum (exact in f32) for asym codes or when
    asked for (sym acts feeding asym weights)."""
    rowsum = (q.sum(dim=-1, keepdim=True)
              if zp is not None or need_rowsum else None)
    return q.to(torch.int8), scale, zp, rowsum


def gelu_tanh(o: torch.Tensor) -> torch.Tensor:
    """tanh-GELU in the JAX kernel's operation order (o^3 as (o*o)*o)."""
    return 0.5 * o * (1.0 + torch.tanh(
        _SQRT_2_OVER_PI * (o + 0.044715 * (o * o * o))))


def _out_ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def residual_gate(out: torch.Tensor, residual, gate) -> torch.Tensor:
    """The residual (+ gate) epilogue of K2 and K5 in f32, after the bias:
    out [M, N] times gate[row // (M / G)] where a gate [G, N] is given,
    then plus residual [M, N] (each as f32); out itself without a
    residual."""
    if residual is None:
        return out
    M, N = out.shape
    if gate is not None:
        G = gate.shape[0]
        out = (out.reshape(G, M // G, N)
               * gate.float().reshape(G, 1, N)).reshape(M, N)
    return out + residual.reshape(M, N).float()


def _check_residual(M: int, N: int, residual, gate, emit=None) -> None:
    """The JAX wrappers' preconditions of the residual (+ gate) epilogue
    (`fused_matmul.py:438-440`, `select_mm_blocks`): a gate needs the
    residual, the emission takes neither, the gate's G rows split M
    evenly."""
    if residual is None and gate is None:
        return
    require(residual is not None,
            "gate is applied inside the residual epilogue; pass residual")
    require(emit is None, "int8 emission replaces the output epilogue")
    require(residual.numel() == M * N,
            f"residual must have {M} x {N} elements")
    if gate is not None:
        G = gate.shape[0]
        require(gate.dim() == 2 and gate.shape[1] == N and M % G == 0,
                f"gate must be [G, {N}] with M={M} a multiple of G")


def _res_gate_args(M: int, N: int, out_dtype, residual, gate):
    """The residual epilogue's kernel arguments on CUDA tensors: (res,
    gate, rows_per_gate) as contiguous bf16 tensors (None and 0 without a
    residual); raises on what the kernels do not take."""
    if residual is None:
        return None, None, 0
    require(out_dtype == torch.bfloat16 and residual.dtype == torch.bfloat16
            and (gate is None or gate.dtype == torch.bfloat16),
            "the residual epilogue takes a bf16 residual, gate and output on "
            "the card")
    res = residual.reshape(M, N).contiguous()
    if res.data_ptr() % 16:  # K2 reads it by TMA
        res = res.clone()
    g = None if gate is None else gate.contiguous()
    return res, g, 0 if g is None else M // g.shape[0]


def balance_cols(y: torch.Tensor, col_scale) -> torch.Tensor:
    """y [.., K] f32 times the column scales [K] in f32 (the plain versions'
    `RowQuant::balance`); y itself without them."""
    if col_scale is None:
        return y
    return y * col_scale.reshape(1, -1).float()


def _row_tables(n: int, device, sym: bool, need_rowsum: bool):
    """A row quantizer's [n, 1] f32 outputs as views of one allocation (one
    allocator call a launch, not three): the scale, the zero point (asym)
    and the code row sum (asym, or when asked for)."""
    with_rs = not sym or need_rowsum
    k = 1 + (not sym) + with_rs
    buf = torch.empty((k, n, 1), dtype=torch.float32, device=device)
    return (buf[0], None if sym else buf[1],
            buf[k - 1] if with_rs else None)


# ---------------------------------------------------------------------------
# K1: LayerNorm + t2i modulate + row quantize
# ---------------------------------------------------------------------------

def ln_modulate_quantize_plain(x: torch.Tensor, shift: torch.Tensor,
                               scale: torch.Tensor, sym: bool = True,
                               need_rowsum: bool = False, eps: float = 1e-6):
    count_plain("ln_modulate_quantize", x)
    B, N, C = x.shape
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    y = (y * (1.0 + scale.float().reshape(B, 1, C))
         + shift.float().reshape(B, 1, C))
    q, s, zp = quantize_rows_f32(y.reshape(B * N, C), sym)
    return _row_outputs(q, s, zp, need_rowsum)


def ln_modulate_quantize(x: torch.Tensor, shift: torch.Tensor,
                         scale: torch.Tensor, sym: bool = True,
                         need_rowsum: bool = False, eps: float = 1e-6):
    """[B, N, C] -> (int8 codes [B*N, C], scales, zp | None, rowsum | None),
    each [B*N, 1] f32.

    shift/scale: [B, 1, C] per-batch adaLN vectors. Non-affine LN, eps
    1e-6, then `y*(1+scale)+shift`, then the row quantize (sym, or asym
    with its zero point). The code row sum comes with asym codes, or with
    sym ones when need_rowsum (asym consumer weights)."""
    if not on_cuda(x, shift, scale):
        return ln_modulate_quantize_plain(x, shift, scale, sym, need_rowsum,
                                          eps)
    B, N, C = x.shape
    shift = shift.reshape(B, 1, C).contiguous()
    scale = scale.reshape(B, 1, C).contiguous()
    require(x.is_contiguous(), "x must be contiguous")
    require(shift.dtype == x.dtype and scale.dtype == x.dtype,
            "shift/scale must have x's dtype")
    q = torch.empty((B * N, C), dtype=torch.int8, device=x.device)
    qs, zp, rs = _row_tables(B * N, x.device, sym, need_rowsum)
    _build.check(_build.lib().vq_ln_mod_quant(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), q.data_ptr(),
        qs.data_ptr(), _out_ptr(zp), _out_ptr(rs), B, N, C, float(eps),
        is_bf16(x), _build.stream_ptr(x)), "vq_ln_mod_quant")
    COUNTERS["ln_modulate_quantize"].launches += 1
    return q, qs, zp, rs


# ---------------------------------------------------------------------------
# K4: (tanh-GELU then) row quantize
# ---------------------------------------------------------------------------

def quantize_rows_plain(x: torch.Tensor, sym: bool = True, gelu: bool = False,
                        need_rowsum: bool = False,
                        col_scale: Optional[torch.Tensor] = None):
    count_plain("quantize_rows", x)
    xf = x.float()
    if gelu:
        xf = gelu_tanh(xf)
    xf = balance_cols(xf, col_scale)
    return _row_outputs(*quantize_rows_f32(xf, sym), need_rowsum)


def quantize_rows(x: torch.Tensor, sym: bool = True, gelu: bool = False,
                  need_rowsum: bool = False,
                  col_scale: Optional[torch.Tensor] = None):
    """[M, K] -> (int8 codes [M, K], scales, zp | None, rowsum | None), each
    [M, 1] f32, as `quantize_rows_fused` returns them (`fused_matmul.py:
    651-653`). gelu: tanh-GELU of the f32 value first (the fc1 -> fc2
    handoff). col_scale [K] (or [1, K]): the consuming layer's
    channel-balancing 1/cs, multiplied in f32 after the GELU and before the
    quantize (`:593-596`). The row sum comes with asym codes, or when
    need_rowsum."""
    if not on_cuda(x, col_scale):
        return quantize_rows_plain(x, sym, gelu, need_rowsum, col_scale)
    require(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [M, K]")
    M, K = x.shape
    cs = col_scale_arg(col_scale, K)
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    qs, zp, rs = _row_tables(M, x.device, sym, need_rowsum)
    _build.check(_build.lib().vq_quant_rows(
        x.data_ptr(), _out_ptr(cs), q.data_ptr(), qs.data_ptr(), _out_ptr(zp),
        _out_ptr(rs), M, K, int(gelu), is_bf16(x), _build.stream_ptr(x)),
        "vq_quant_rows")
    COUNTERS["quantize_rows"].launches += 1
    return q, qs, zp, rs


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


def _zp_epilogue(acc, M, N, K, xs, ws, x_zp, x_rowsum, w_zp, w_colsum):
    """The zero-point-corrected epilogues of `_consumer_kernel`
    (`fused_matmul.py:356-362`) in f32 and in its operation order:
    sym acts x asym weights `(acc - wzp*xrs) * (xs*ws)`; asym acts
    `((acc - xzp*wcs - wzp*xrs + (K*xzp)*wzp) * xs) * ws`, with a missing
    weight zero point or act row sum read as zeros, as the JAX wrapper
    fills them (`:467-477`)."""
    wz = (torch.zeros((1, N), device=acc.device) if w_zp is None
          else w_zp.reshape(1, N).float())
    xr = (torch.zeros((M, 1), device=acc.device) if x_rowsum is None
          else x_rowsum.reshape(M, 1).float())
    if x_zp is None:
        return (acc - wz * xr) * (xs * ws)
    xz = x_zp.reshape(M, 1).float()
    corrected = (acc - xz * w_colsum.reshape(1, N).float() - wz * xr
                 + (float(K) * xz) * wz)
    return corrected * xs * ws


def _check_zero_points(x_zp, x_rowsum, w_zp, w_colsum, group_scales):
    """The JAX wrapper's preconditions (`fused_matmul.py:437-454`)."""
    if x_zp is None and w_zp is None:
        return
    require(not group_scales, "group-wise x_scale requires sym x sym")
    require(x_zp is not None or x_rowsum is not None,
            "sym acts on asym weights need x_rowsum for the w_zp term")
    require(x_zp is None or w_colsum is not None,
            "asym acts require w_colsum")


def int8_consumer_matmul_plain(x_q, x_scale, w_q, w_scale, bias=None,
                               out_dtype=torch.bfloat16,
                               group_scales: bool = False, emit=None,
                               x_zp=None, x_rowsum=None, w_zp=None,
                               w_colsum=None, residual=None, gate=None):
    count_plain("int8_consumer_matmul", x_q)
    _check_zero_points(x_zp, x_rowsum, w_zp, w_colsum, group_scales)
    M, K = x_q.shape
    N = w_q.shape[1]
    _check_residual(M, N, residual, gate, emit)
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
        xs = x_scale.reshape(M, 1).float()
        if x_zp is None and w_zp is None:
            out = acc * (xs * ws)
        else:
            out = _zp_epilogue(acc, M, N, K, xs, ws, x_zp, x_rowsum, w_zp,
                               w_colsum)
    if bias is not None:
        out = out + bias.reshape(1, N).float()
    if emit is None:
        return residual_gate(out, residual, gate).to(out_dtype)
    if emit.get("gelu"):
        out = gelu_tanh(out)
    out = balance_cols(out, emit.get("col_scale"))
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
                         x_zp: Optional[torch.Tensor] = None,
                         x_rowsum: Optional[torch.Tensor] = None,
                         w_zp: Optional[torch.Tensor] = None,
                         w_colsum: Optional[torch.Tensor] = None,
                         residual=None, gate=None):
    """x_q [M, K] int8 with per-row scales [M, 1] (or, with group_scales,
    one scale per row and k-group [M, G], as K2's emission writes them);
    w_q [K, N] int8 with per-column scales. Returns [M, N] out_dtype.

    On the card w_q must be K-major (`_common.k_major`, QuantLinear's
    `w_int`); the plain version takes either layout.

    Zero points, as in the JAX wrapper (`fused_matmul.py:394-407`): x_zp
    [M, 1] marks asym acts (then w_colsum [1, N] is needed), w_zp [1, N]
    asym weights (then, with sym acts, x_rowsum [M, 1]); either selects
    the zero-point-corrected epilogue, bf16 or f32 out, bias added in f32
    before the cast, or the emission after it (`fused_matmul.py:352-372`).
    Group-wise scales take sym x sym.

    emit {'gelu': bool, 'col_scale': [N] or None}: instead of the output,
    apply tanh-GELU, multiply by the next layer's channel-balancing column
    scales (`has_ecs`, `fused_matmul.py:372-374`) and quantize each row per
    group of `emit_groups(N, K)` columns; returns (codes [M, N] int8,
    scales [M, G] f32). The TPU kernel's lane-padded [M, G*128] scale
    layout is not kept: the port stores [M, G].

    residual [M, N] (and gate [G, N], G dividing M): instead of the output,
    `residual + gate[row // (M / G)] * output` taken in f32 after the bias
    (`residual_gate`), then one cast; not with the emission. On the card
    residual, gate and the output are bf16."""
    tables = (x_zp, x_rowsum, w_zp, w_colsum)
    ecs = (emit or {}).get("col_scale")
    if not on_cuda(x_q, x_scale, w_q, w_scale, bias, ecs, residual, gate,
                   *tables):
        return int8_consumer_matmul_plain(x_q, x_scale, w_q, w_scale, bias,
                                          out_dtype, group_scales, emit,
                                          *tables, residual=residual,
                                          gate=gate)
    _check_zero_points(*tables, group_scales)
    M, N = x_q.shape[0], w_q.shape[1]
    _check_residual(M, N, residual, gate, emit)
    rg = _res_gate_args(M, N, out_dtype, residual, gate)
    if emit is None:
        require(out_dtype in (torch.bfloat16, torch.float32),
                f"unsupported out_dtype {out_dtype}")
        kind = 0 if out_dtype == torch.bfloat16 else 1
    else:
        bn = emit_groups(w_q.shape[1], x_q.shape[1])
        kind = 2 if emit.get("gelu") else 1
    if x_zp is not None or w_zp is not None:
        out = k2_gemm_zp(x_q, x_scale, w_q, w_scale, bias, kind, *tables, rg)
    else:
        out = k2_gemm(x_q, x_scale, w_q, w_scale, bias, group_scales, kind,
                      rg)
    COUNTERS["int8_consumer_matmul"].launches += 1
    return out if emit is None else group_quant(out, bn, ecs)


def _require_gemm_operands(x_q, w_q):
    M, K = x_q.shape
    K2, N = w_q.shape
    require(K == K2, f"K mismatch {K} != {K2}")
    require(x_q.dtype == torch.int8 and w_q.dtype == torch.int8,
            "x_q and w_q must be int8")
    require_k_major(w_q)
    require(x_q.is_contiguous(), "x_q must be contiguous")
    require(K % 64 == 0 and N % 16 == 0,
            f"kernel needs K % 64 == 0 and N % 16 == 0 (K={K}, N={N})")
    require(x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0,
            "x_q and w_q must be 16-byte aligned")
    return M, K, N


def k2_gemm_zp(x_q, x_scale, w_q, w_scale, bias, kind: int, x_zp, x_rowsum,
               w_zp, w_colsum, rg=(None, None, 0)) -> torch.Tensor:
    """The launch of K2's zero-point-corrected epilogue on CUDA tensors (no
    count); a missing table is a null pointer the kernel reads as zeros.
    kind as `k2_gemm`'s: 0 bf16 out, 1 f32 out, 2 f32 tanh-GELU out (the
    emission's scratch). rg: the residual epilogue's (res, gate,
    rows_per_gate), `_res_gate_args`, with kind 0."""
    M, K, N = _require_gemm_operands(x_q, w_q)
    rows = [f32_flat(t) if t is not None else None
            for t in (x_scale, x_zp, x_rowsum)]
    cols = [f32_flat(t) if t is not None else None
            for t in (w_scale, w_zp, w_colsum, bias)]
    for name, t, n in zip(("x_scale", "x_zp", "x_rowsum"), rows, (M,) * 3):
        require(t is None or t.numel() == n, f"{name} must have {n} elements")
    for name, t in zip(("w_scale", "w_zp", "w_colsum", "bias"), cols):
        require(t is None or t.numel() == N, f"{name} must have {N} elements")
    lib = _build.lib()
    out = torch.empty((M, N), dtype=torch.bfloat16 if kind == 0
                      else torch.float32, device=x_q.device)
    _build.check(lib.vq_int8_gemm_zp(
        x_q.data_ptr(), w_q.data_ptr(), *(_out_ptr(t) for t in rows),
        *(_out_ptr(t) for t in cols), out.data_ptr(), M, N, K, kind,
        _out_ptr(rg[0]), _out_ptr(rg[1]), rg[2], _build.stream_ptr(x_q)),
        "vq_int8_gemm_zp")
    return out


def k2_gemm(x_q, x_scale, w_q, w_scale, bias, group_scales: bool,
            kind: int, rg=(None, None, 0)) -> torch.Tensor:
    """The GEMM launch of K2 on CUDA tensors (no count): kind 0 bf16 out, 1
    f32 out, 2 f32 tanh-GELU out (the emission's scratch); rg: the residual
    epilogue's (res, gate, rows_per_gate) with kind 0."""
    M, K, N = _require_gemm_operands(x_q, w_q)
    G = x_scale.shape[1] if group_scales else 1
    require(x_scale.shape == (M, G) and x_scale.dtype == torch.float32,
            f"x_scale must be float32 [{M}, {G}]")
    require((K // G) % 64 == 0,
            f"kernel needs (K/G) % 64 == 0 (K={K}, G={G})")
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
        int(group_scales), kind, _out_ptr(rg[0]), _out_ptr(rg[1]), rg[2],
        _build.stream_ptr(x_q)), "vq_int8_gemm")
    return out


def group_quant(y: torch.Tensor, bn: int, col_scale=None):
    """The emission's second pass on CUDA tensors (no count): f32 [M, N]
    (times the column scales [N], where given) -> (codes [M, N] int8,
    scales [M, N / bn] f32), one scale per row and group of bn columns."""
    M, N = y.shape
    cs = col_scale_arg(col_scale, N)
    codes = torch.empty((M, N), dtype=torch.int8, device=y.device)
    scales = torch.empty((M, N // bn), dtype=torch.float32, device=y.device)
    _build.check(_build.lib().vq_group_quant(
        y.data_ptr(), _out_ptr(cs), codes.data_ptr(), scales.data_ptr(), M,
        N, bn, _build.stream_ptr(y)), "vq_group_quant")
    return codes, scales


# ---------------------------------------------------------------------------
# K5: quantize-in matmul
# ---------------------------------------------------------------------------

# the kernel's tiles (csrc/dynq_gemm.cu BM, BN) and the widest K whose codes
# of one M tile stay resident in shared memory (MAX_KT k-tiles of 128);
# wider K runs the kernel's wide schedule
K5_BM, K5_BN, K5_MAX_K = 128, 192, 1152


def k5_padded(n: int, mult: int) -> int:
    """n rounded up to a multiple of mult (K5's padded N and row stride)."""
    return -(-n // mult) * mult


def _pad_cols(t: Optional[torch.Tensor], n: int):
    """t [.., m] zero-padded to [.., n] (K5's padded N or row stride)."""
    if t is None or t.shape[-1] == n:
        return t
    return torch.nn.functional.pad(t, (0, n - t.shape[-1]))


def k5_split(m: int, n: int, sms: int) -> int:
    """Runs of N tiles each M tile's work is split into: one run (x read
    once) where the M tiles fill the card, else about as many runs as make
    `sms` work units, each of ceil(tiles_n / runs) tiles, none empty. Each
    run quantizes its M tile again (from L2 after the first)."""
    m_tiles = -(-m // K5_BM)
    tiles_n = -(-n // K5_BN)
    want = min(tiles_n, max(1, sms // m_tiles))
    run = -(-tiles_n // want)
    return -(-tiles_n // run)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_dynq_int8_matmul_plain(x, w_q, w_scale, bias=None,
                                 out_dtype=torch.bfloat16, sym: bool = True,
                                 sym_w: bool = True, w_zp=None,
                                 w_colsum=None, col_scale=None,
                                 residual=None, gate=None):
    count_plain("fused_dynq_int8_matmul", x)
    q, s, zp, rs = quantize_rows_plain(x, sym,
                                       need_rowsum=not (sym and sym_w),
                                       col_scale=col_scale)
    return int8_consumer_matmul_plain(q, s, w_q, w_scale, bias, out_dtype,
                                      x_zp=zp, x_rowsum=rs,
                                      w_zp=None if sym_w else w_zp,
                                      w_colsum=w_colsum, residual=residual,
                                      gate=gate)


def fused_dynq_int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                           w_scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype=torch.bfloat16, sym: bool = True,
                           sym_w: bool = True,
                           w_zp: Optional[torch.Tensor] = None,
                           w_colsum: Optional[torch.Tensor] = None,
                           residual=None, gate=None,
                           col_scale=None) -> torch.Tensor:
    """x [M, K] float -> [M, N]: quantize each row (the code row sum too
    unless sym and sym_w, `fused_matmul.py:174-175`), then the int8 matmul
    with the dequant epilogue and bias, in one pass as the TPU kernel
    (`fused_matmul.py:144-309`). sym/sym_w flag act/weight symmetry as in
    the JAX kernel; asym weights take w_zp [1, N] (the shifted zero point),
    asym acts w_colsum [1, N]. col_scale [K] (or [1, K]): the layer's
    channel-balancing 1/cs, x * col_scale in f32 before the row statistic
    (`has_csc`, `:167-168`). residual [M, N] (and gate [G, N]): the
    residual (+ gate) epilogue after the bias, as K2's (`:192-205`).

    On the card: one launch of csrc/dynq_gemm.cu (x bf16 or f32, w_q
    K-major), whose output equals `quantize_rows` then
    `int8_consumer_matmul` bit for bit, at any K and N as JAX's K5 takes
    them: above `K5_MAX_K` (1152) the kernel's wide schedule; rows of x
    that are not 16 bytes (or not 16-byte aligned) are copied into padded
    rows, and N % 16 != 0 is padded with zero weight columns, the padding
    kept out of every row statistic and sliced off the output. With a
    residual it takes bf16 x, residual, gate and output and no column
    scale."""
    require(sym_w or w_zp is not None, "asym weights need w_zp")
    w_zp = None if sym_w else w_zp
    if not on_cuda(x, w_q, w_scale, bias, w_zp, w_colsum, col_scale,
                   residual, gate):
        return fused_dynq_int8_matmul_plain(x, w_q, w_scale, bias, out_dtype,
                                            sym, sym_w, w_zp, w_colsum,
                                            col_scale, residual=residual,
                                            gate=gate)
    require(sym or w_colsum is not None, "asym acts require w_colsum")
    require(out_dtype in (torch.bfloat16, torch.float32),
            f"unsupported out_dtype {out_dtype}")
    require(x.dim() == 2 and x.is_contiguous(), "x must be contiguous [M, K]")
    M, K = x.shape
    K2, N = w_q.shape
    require(K == K2, f"K mismatch {K} != {K2}")
    require(w_q.dtype == torch.int8, "w_q must be int8")
    require_k_major(w_q)
    bf16 = is_bf16(x)
    require(K > 0 and N > 0, f"K5 needs K, N > 0 (K={K}, N={N})")
    cols = [None if t is None else f32_flat(t)
            for t in (w_scale, w_zp, w_colsum, bias)]
    for name, t in zip(("w_scale", "w_zp", "w_colsum", "bias"), cols):
        require(t is None or t.numel() == N, f"{name} must have {N} elements")
    cs = col_scale_arg(col_scale, K)
    _check_residual(M, N, residual, gate)
    require(residual is None or (bf16 and cs is None),
            "K5's residual epilogue takes bf16 x and no column scale")
    # x's rows 16 bytes long and aligned (the padding zero, past K);
    # N a multiple of 16 (zero weight columns, sliced off the output)
    ldx = k5_padded(K, 16 // x.element_size())
    if ldx != K or x.data_ptr() % 16:
        x = _pad_cols(x, ldx).contiguous()
        if x.data_ptr() % 16:
            x = x.clone()
    cs = _pad_cols(cs, ldx)
    Np = k5_padded(N, 16)
    if Np != N:
        wt = w_q.new_zeros((Np, K))
        wt[:N] = w_q.t()
        w_q = wt.t()
        cols = [_pad_cols(t, Np) for t in cols]
        if residual is not None:
            residual = _pad_cols(residual.reshape(M, N), Np)
        gate = _pad_cols(gate, Np)
    rg = _res_gate_args(M, Np, out_dtype, residual, gate)
    lib = _build.lib()
    out = torch.empty((M, Np), dtype=out_dtype, device=x.device)
    _build.check(lib.vq_dynq_gemm(
        x.data_ptr(), _out_ptr(cs), w_q.data_ptr(),
        *(_out_ptr(t) for t in cols),
        out.data_ptr(), M, Np, K, ldx, bf16, int(sym),
        int(out_dtype == torch.float32),
        k5_split(M, Np, _sm_count(x.get_device())), _out_ptr(rg[0]),
        _out_ptr(rg[1]), rg[2], _build.stream_ptr(x)), "vq_dynq_gemm")
    COUNTERS["fused_dynq_int8_matmul"].launches += 1
    return out if Np == N else out[:, :N].contiguous()
