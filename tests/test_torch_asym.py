"""The asymmetric modes of the fused kernels (K1, K2, K4, K5, K3/K6
emission), as they run on CPU tensors (plain versions), against the JAX
package's Pallas kernels in interpret mode — the same inputs, made with
numpy from a seed — and the CUDA wrappers' argument rules.

Tolerances, each with its reason:
  * asym row quantizers (K1, K4, K5's quantize, the emissions): XLA on
    the CPU evaluates `(max - min) / 255` as a multiply by the reciprocal
    (C8), one ulp from the port's true division, so scales agree to one
    ulp (2.5e-7 relative; 1e-5 after K1's LayerNorm and the attention,
    whose float reductions run in another order) and a row's zero point
    may move by one; the unshifted codes `q - zp` are equal or off by one
    at no more than 0.1% of the entries; every row sum is the sum of its
    own package's codes;
  * K2: the int32 product is exact in both and the f32 epilogue is the
    same sequence of operations: f32 outputs at rtol 1e-5 / atol 1e-3, as
    `tests/test_torch_int_matmul.py` holds K7b;
  * K5 = K4 then K2: a moved zero point or code moves an output by one
    quantization step of one product term: 1e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import (CODE_FRAC, LAYOUTS, _attn_inputs, interp,
                                rel_err, t)
from test_torch_rules import _OnCard
from viditq_tpu.kernels import attention as jattn
from viditq_tpu.kernels import fused_matmul as jfm
from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels._common import k_major

ULP = 2.5e-7


def check_rows(got, want, sym=False, scale_rtol=ULP):
    """Row-quantizer outputs (codes, scale, zp | None, rowsum | None) of
    the port against JAX's, within the module's tolerances."""
    q, s, z, rs = got
    jq, js, jz, jrs = want
    assert q.dtype == torch.int8 and s.shape == (q.shape[0], 1)
    assert (z is None) == sym and (jz is None) == sym
    q, jq = np.asarray(q, np.int64), np.asarray(jq, np.int64)
    np.testing.assert_allclose(s.numpy(), js, rtol=scale_rtol)
    u, ju = q, jq
    if not sym:
        z, jz = z.numpy(), np.asarray(jz)
        dz = np.abs(z - jz)
        assert dz.max() <= 1 and (dz > 0).mean() <= 0.25
        u, ju = q - z, jq - jz
    diff = np.abs(u - ju)
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FRAC
    assert (rs is None) == (jrs is None)
    if rs is not None:
        np.testing.assert_array_equal(rs.numpy(), q.sum(1, keepdims=True))
        np.testing.assert_array_equal(jrs, jq.sum(1, keepdims=True))


# the models' full width (C = 1152) on 64 rows beside the narrow cases
@pytest.mark.parametrize("dtype,N,C", [("float32", 256, 64),
                                       ("bfloat16", 256, 64),
                                       ("bfloat16", 32, 1152)],
                         ids=["float32", "bfloat16", "bfloat16-C1152"])
def test_k1_asym(dtype, N, C):
    rng = np.random.default_rng(30)
    x = rng.standard_normal((2, N, C)).astype(np.float32) * 2 + 0.3
    sh = rng.standard_normal((2, 1, C)).astype(np.float32) * 0.2 + 0.3
    sc = rng.standard_normal((2, 1, C)).astype(np.float32) * 0.2
    jx, jsh, jsc = (jnp.asarray(a, jnp.dtype(dtype)) for a in (x, sh, sc))
    want = interp(jfm.ln_modulate_quantize, jx, jsh, jsc, sym=False,
                  block_m=min(256, N))
    got = FM.ln_modulate_quantize(
        *(t(np.asarray(a, np.float32)).to(getattr(torch, dtype))
          for a in (jx, jsh, jsc)), sym=False)
    assert got[0].shape == (2 * N, C)
    check_rows(got, want, scale_rtol=1e-5)


def test_k1_sym_rowsum():
    # sym acts feeding asym weights: the code row sum comes along
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 256, 64)).astype(np.float32)
    sh, sc = (rng.standard_normal((2, 1, 64)).astype(np.float32) * 0.2
              for _ in range(2))
    want = interp(jfm.ln_modulate_quantize, *map(jnp.asarray, (x, sh, sc)),
                  sym=True, need_rowsum=True)
    got = FM.ln_modulate_quantize(t(x), t(sh), t(sc), need_rowsum=True)
    check_rows(got, want, sym=True, scale_rtol=1e-5)


# f32 rows of 256, and the fc1 -> fc2 handoff's full width (K = 4608, bf16
# as fc1 writes it) on 32 rows
@pytest.mark.parametrize("sym,gelu,M,K,dtype", [
    (False, False, 96, 256, "float32"), (True, True, 96, 256, "float32"),
    (False, True, 96, 256, "float32"), (True, True, 32, 4608, "bfloat16"),
    (False, True, 32, 4608, "bfloat16")],
    ids=["asym", "gelu-sym", "gelu-asym", "gelu-sym-K4608-bf16",
         "gelu-asym-K4608-bf16"])
def test_k4_quantize_rows(sym, gelu, M, K, dtype):
    rng = np.random.default_rng(32)
    x = (rng.standard_normal((M, K)) * 2 + 0.4).astype(np.float32)
    x[5] = 0.0  # all-zero row: the 1e-6 scale floor
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want = interp(jfm.quantize_rows_fused, jx, sym=sym,
                  gelu=gelu, need_rowsum=False, block_m=32)
    got = FM.quantize_rows(t(np.asarray(jx, np.float32)).to(
        getattr(torch, dtype)), sym=sym, gelu=gelu)
    # the GELU's tanh differs by an ulp between the libraries, and the
    # scale is the row's largest GELU output over 127 or its range / 255
    check_rows(got, want, sym=sym, scale_rtol=1e-6 if gelu else ULP)


def test_k4_gelu_takes_bf16():
    # the fc1 -> fc2 handoff reads fc1's bf16 output
    rng = np.random.default_rng(33)
    x = jnp.asarray(rng.standard_normal((64, 128)) * 2, jnp.bfloat16)
    want = interp(jfm.quantize_rows_fused, x, sym=False, gelu=True,
                  need_rowsum=True, block_m=32)
    got = FM.quantize_rows(t(np.asarray(x, np.float32)).bfloat16(),
                           sym=False, gelu=True, need_rowsum=True)
    check_rows(got, want, scale_rtol=1e-6)


def _asym_tables(rng, M, K, N, act_sym=False, w_sym=False):
    """Quantized acts (the port's K4 on a float draw) and packed weights:
    codes, scales, zero points (None when sym), row and column sums."""
    x = (rng.standard_normal((M, K)) + 0.3).astype(np.float32)
    xq, xs, xzp, xrs = FM.quantize_rows_plain(t(x), act_sym,
                                              need_rowsum=True)
    w_q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    wzp = (None if w_sym
           else rng.integers(-20, 20, (1, N)).astype(np.float32))
    wcs = w_q.astype(np.float32).sum(0, keepdims=True)
    b = rng.standard_normal(N).astype(np.float32)
    return ([a.numpy() if a is not None else None
             for a in (xq, xs, xzp, xrs)], w_q, ws, wzp, wcs, b)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("act_sym,w_sym", [(True, False), (False, False),
                                           (False, True)],
                         ids=["sym-asym", "asym-asym", "asym-sym"])
def test_k2_zero_point_epilogues(act_sym, w_sym, layout):
    rng = np.random.default_rng(34)
    (xq, xs, xzp, xrs), w, ws, wzp, wcs, b = _asym_tables(
        rng, 64, 256, 192, act_sym, w_sym)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = interp(jfm.int8_consumer_matmul, j(xq), j(xs), j(w), j(ws),
                  x_zp=j(xzp), x_rowsum=j(xrs), w_zp=j(wzp),
                  w_colsum=j(wcs), bias=j(b), out_dtype=jnp.float32)
    p = lambda a: None if a is None else t(a)  # noqa: E731
    got = FM.int8_consumer_matmul(
        p(xq), p(xs), LAYOUTS[layout](p(w)), p(ws), p(b),
        out_dtype=torch.float32, x_zp=p(xzp), x_rowsum=p(xrs), w_zp=p(wzp),
        w_colsum=p(wcs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    # the zero-point terms really enter: without them the output moves
    plain = FM.int8_consumer_matmul(p(xq), p(xs), p(w), p(ws), p(b),
                                    out_dtype=torch.float32)
    assert rel_err(plain, want) > 1e-2


def test_k2_bias_is_added_in_f32_before_the_cast():
    # K2 adds the bias in f32 and rounds once (fused_matmul.py:363-364);
    # K7b's caller rounds the product first
    rng = np.random.default_rng(35)
    (xq, xs, xzp, xrs), w, ws, wzp, wcs, b = _asym_tables(rng, 40, 128, 64)
    args = [t(a) for a in (xq, xs, w, ws)]
    kw = dict(x_zp=t(xzp), x_rowsum=t(xrs), w_zp=t(wzp), w_colsum=t(wcs))
    f32 = FM.int8_consumer_matmul(*args, t(b), torch.float32, **kw)
    bf = FM.int8_consumer_matmul(*args, t(b), torch.bfloat16, **kw)
    assert torch.equal(bf, f32.to(torch.bfloat16))


@pytest.mark.parametrize("M", [240, 64])
def test_k5_asym(M):
    # M=240: the kv_linear row count (2 x 120 prompt tokens)
    rng = np.random.default_rng(36)
    K, N = 128, 256
    x = (rng.standard_normal((M, K)) + 0.3).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    wzp = rng.integers(-20, 20, (1, N)).astype(np.float32)
    wcs = w.astype(np.float32).sum(0, keepdims=True)
    b = rng.standard_normal(N).astype(np.float32)
    want = interp(jfm.fused_dynq_int8_matmul, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(ws), jnp.asarray(wzp), jnp.asarray(wcs),
                  sym=False, sym_w=False, bias=jnp.asarray(b),
                  out_dtype=jnp.float32)
    got = FM.fused_dynq_int8_matmul(t(x), k_major(t(w)), t(ws), t(b),
                                    torch.float32, sym=False, sym_w=False,
                                    w_zp=t(wzp), w_colsum=t(wcs))
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("mode", ["seg", "full", "mask"])
def test_k3_asym_emission(mode):
    H, D = 2, 16
    q, k, v, seg, mask = _attn_inputs(mode, H, D, seed=37)
    v += 0.5  # outputs off zero: a real zero point
    want = interp(jattn.attention_bnhd_int8out, jnp.asarray(q),
                  jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5,
                  seg_len=seg, kv_mask=None if mask is None
                  else jnp.asarray(mask), emit_sym=False, need_rowsum=True)
    got = A.attention_bnhd(t(q), t(k), t(v), D ** -0.5, seg_len=seg,
                           kv_mask=None if mask is None else t(mask),
                           emit=True, emit_sym=False, need_rowsum=True)
    assert [g.shape for g in got] == [w.shape for w in want]
    check_rows([g.reshape(-1, g.shape[-1]) for g in got],
               [w.reshape(-1, w.shape[-1]) for w in want], scale_rtol=1e-5)


def test_k3_sym_emission_rowsum():
    q, k, v, seg, _ = _attn_inputs("full", 2, 16, seed=38)
    want = interp(jattn.attention_bnhd_int8out, jnp.asarray(q),
                  jnp.asarray(k), jnp.asarray(v), scale=0.25,
                  need_rowsum=True)
    got = A.attention_bnhd(t(q), t(k), t(v), 0.25, emit=True,
                           need_rowsum=True)
    check_rows([None if g is None else g.reshape(-1, g.shape[-1])
                for g in got],
               [None if w is None else w.reshape(-1, w.shape[-1])
                for w in want], sym=True, scale_rtol=1e-5)


def test_k6_asym_emission():
    # K6's emission is K4's row quantize of the rounded output
    from test_torch_stream import D as SD
    from test_torch_stream import _inputs, _jax
    q, k, v, mask = _inputs(seed=39, masked=True)
    v += 0.5
    want = _jax(jattn.attention_bnhd_int8out, q, k, v, mask,
                emit_sym=False, need_rowsum=True)
    got = A.attention_bnhd(t(q), t(k), t(v), SD ** -0.5, kv_mask=t(mask),
                           emit=True, emit_sym=False, need_rowsum=True)
    check_rows([g.reshape(-1, g.shape[-1]) for g in got],
               [w.reshape(-1, w.shape[-1]) for w in want], scale_rtol=2e-6)


# ---------------------------------------------------------------------------
# the CUDA wrappers' argument rules (no card: the launch is intercepted)
# ---------------------------------------------------------------------------

class _Launched(Exception):
    pass


@pytest.fixture
def zp_gemm_args(monkeypatch):
    def lib():
        raise _Launched()
    monkeypatch.setattr(_build, "lib", lib)
    rng = np.random.default_rng(40)
    (xq, xs, xzp, xrs), w, ws, wzp, wcs, b = _asym_tables(rng, 32, 128, 64)
    card = lambda a: t(a).as_subclass(_OnCard)  # noqa: E731
    return ([card(xq), card(xs), card(k_major(t(w)).numpy()), card(ws)],
            dict(x_zp=card(xzp), x_rowsum=card(xrs), w_zp=card(wzp),
                 w_colsum=card(wcs)))


def test_cuda_k2_zero_point_modes_reach_the_launch(zp_gemm_args):
    args, kw = zp_gemm_args
    for drop in ((), ("x_zp",), ("w_zp", "x_rowsum")):
        with pytest.raises(_Launched):
            FM.int8_consumer_matmul(*args, **{k: v for k, v in kw.items()
                                              if k not in drop})


def test_cuda_k2_zero_points_refuse_group_scales_and_emission(zp_gemm_args):
    args, kw = zp_gemm_args
    with pytest.raises(ValueError, match="group-wise"):
        FM.int8_consumer_matmul(*args, group_scales=True, **kw)
    with pytest.raises(NotImplementedError):
        FM.int8_consumer_matmul(*args, emit={"gelu": True}, **kw)
    with pytest.raises(ValueError, match="w_colsum"):
        FM.int8_consumer_matmul(*args, **{**kw, "w_colsum": None})
    with pytest.raises(ValueError, match="x_rowsum"):
        FM.int8_consumer_matmul(*args, **{**kw, "x_zp": None,
                                          "x_rowsum": None})


def test_chip_smoke_carries_the_asym_cases_and_arms():
    import inspect
    import chip_smoke as cs
    from test_torch_fused import PLANS
    # the fused reference arm and its sym ablation run K1-K5, each on its
    # own model; the fused arm is held to its per-block launch counts: the
    # CPU audit's (tests/test_torch_fused.py) but for K5, one launch of its
    # own, where the plain K5 calls K4's and K2's plain versions
    for arm in ("fused", "sym"):
        assert cs.SLICE_KERNELS["stdit"][arm] == cs.FUSED_KERNELS
    assert cs.ARM_PLANS[("stdit", "fused")].name == PLANS["asym"].split("/")[-1]
    assert cs.ARM_PLANS[("stdit", "sym")].name == PLANS["sym"].split("/")[-1]
    per_block = cs.BLOCK_LAUNCHES[("stdit", "fused")]
    assert per_block == {"ln_modulate_quantize": 2, "int8_consumer_matmul": 11,
                         "attention_bnhd": 3, "quantize_rows": 2,
                         "fused_dynq_int8_matmul": 2}
    # over 20 steps of 28 blocks: K1 1120, K2 6160, K3 1680, K4 1120, K5 1120
    assert {k: n * 28 * cs.STEPS for k, n in per_block.items()} == {
        "ln_modulate_quantize": 1120, "int8_consumer_matmul": 6160,
        "attention_bnhd": 1680, "quantize_rows": 1120,
        "fused_dynq_int8_matmul": 1120}
    src = inspect.getsource(cs.asym_cases)
    for case in ('"asym [2,16384,1152]"', '"asym [32768,1152]"',
                 '"gelu asym [32768,4608]', '"asym q/k/v/proj',
                 '"asym fc1', '"asym fc2', '"sym x asym-weight',
                 '"asym kv_linear', 'fused asym emit'):
        assert case in src, case
    assert "exact=True" in src and "asym_cases(records)" in inspect.getsource(
        cs.phase_kernels)
    assert "FUSED_PLAN" in inspect.getsource(cs.phase_reference)
    # C11: the one-shot int8 PV at M = 2048 with emission; K6's asym emission
    edges = [(n, p) for n, _, p in cs.EDGE_CASES]
    assert any(n == "attention_bnhd" and p["N"] == p["M"] == 2048
               and p["int8_pv"] and p["emit"] for n, p in edges)
    assert any(n == "attention_bnhd_stream" and p["emit"]
               and p.get("emit_sym") is False for n, p in edges)


def test_weight_zero_points_follow_their_table():
    # w_zp_int, the zero point of the packed codes as the epilogues take
    # it, is written with the slab: by the packing and by load_state_dict
    # (of the layer or of a module holding it); it is not saved itself
    import copy
    import dataclasses
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.quant.qlinear import QuantLinear
    from viditq_tpu_torch.utils.config import load_quant_config
    spec = load_quant_config(
        "configs/opensora/w8a8_tpu_fused.yaml").resolver()("blocks.0.attn.q")
    lin = QuantLinear(64, 32, spec, dtype=torch.float32)
    lin.w_delta.fill_(0.01)
    lin.w_zp.fill_(130.0)
    pack_native_weights(lin)
    assert torch.equal(lin.w_zp_int, torch.full((1, 32), 2.0))
    assert "w_zp_int" not in lin.state_dict()
    lin.load_state_dict({**lin.state_dict(), "w_zp": torch.full_like(
        lin.w_zp, 100.0)})
    assert torch.equal(lin.w_zp_int, torch.full((1, 32), -28.0))
    holder = torch.nn.ModuleDict({"q": lin})
    holder.load_state_dict({**holder.state_dict(), "q.w_zp": torch.full_like(
        lin.w_zp, 128.0)})
    assert torch.equal(lin.w_zp_int, torch.zeros(1, 32))
    lin.w_zp.fill_(90.0)
    pack_native_weights(lin)
    assert torch.equal(copy.deepcopy(lin).w_zp_int, torch.full((1, 32), -38.0))
    sym = QuantLinear(64, 32, dataclasses.replace(
        spec, weight=dataclasses.replace(spec.weight, sym=True)),
        dtype=torch.float32)
    sym.w_delta.fill_(0.01)
    sym.w_zp.zero_()
    pack_native_weights(sym)
    assert torch.equal(sym.w_zp_int, torch.zeros(1, 32))


def test_chip_smoke_asym_row_check_compares_every_row():
    # chip_smoke's on-card check of an asym row quantizer: unshifted codes
    # in every row, every scale, zero points to one, row sums against the
    # kernel's own codes; a shift of every row's range by 0.5% shows in
    # the scales (its codes q - zp barely move)
    import chip_smoke as cs
    g = torch.Generator().manual_seed(5)
    x = torch.randn(64, 96, generator=g) + 0.2
    want = FM.quantize_rows_plain(x, sym=False, need_rowsum=True)
    assert cs.compare_asym_rows(want, want) == (0.0, 0.0, 0.0, 0.0, 0.0)
    shifted = FM.quantize_rows_plain(x * 1.005, sym=False, need_rowsum=True)
    _, _, deq, other, srel = cs.compare_asym_rows(shifted, want)
    assert other == 1.0 and srel > 4e-3 and deq > cs.ASYM_DEQ_REL
    assert all(srel > lim or other > frac
               for lim, frac in cs.ASYM_TOL.values())
    # a zero point one higher with its codes: q - zp unchanged
    q, s, z, r = want
    moved = (torch.clamp(q.float() + 1, -128, 127).to(torch.int8), s,
             z + 1, None)
    mx, frac, _, other, srel = cs.compare_asym_rows(moved, want)
    assert mx <= 1 and frac < 0.05 and other == 1.0 and srel == 0.0
    with pytest.raises(SystemExit, match="zero points"):
        cs.compare_asym_rows((q, s, z + 2, r), want)
    with pytest.raises(SystemExit, match="row sums"):
        cs.compare_asym_rows((q, s, z, r + 1), want)


@pytest.mark.parametrize("row", [3, 200, 511])
def test_chip_smoke_int8_pv_slack_bounds_one_softmax_flip(row):
    # C12: one softmax code moved to its other rounding moves the emitted
    # codes of its head by at most one plus `int8_pv_slack`; the row
    # recomputed by `flip_row` is the plain version's
    import chip_smoke as cs
    g = torch.Generator().manual_seed(row)
    B, N, H, D, seg = 1, 512, 2, 8, 16
    q, k, v = (torch.randn(B, N, H, D, generator=g).to(torch.bfloat16)
               for _ in range(3))
    vb, sc = A.seg_v_block(N, seg), D ** -0.5
    want = A.attention_bnhd_plain(q, k, v, sc, seg_len=seg, int8_pv=True,
                                  v_block=vb, emit=True)
    slack = cs.int8_pv_slack(q, k, v, sc, seg, None, vb, want[1])
    assert slack.shape == (B * N, H * D) and bool((slack > 0).all())
    for h in range(H):
        base, flipped, _, e127, r = cs.flip_row(q, k, v, sc, seg, vb, row, h)
        assert torch.equal(base[0], want[0].reshape(-1, H * D)[row].float())
        head = slice(h * D, (h + 1) * D)
        moved = (flipped - base)[0, head].abs()
        assert bool((moved <= 1 + slack[row, head]).all())
        assert r >= 1.0 and 0.0 <= e127 <= 127.0
