"""The column-scale modes of channel balancing (ViDiT-Q's timestep-aware
CB, smooth quant) in the PyTorch port's kernels, on CPU tensors (plain
versions), against the JAX package's kernels in interpret mode on the same
inputs, made with numpy from a seed: K4 (after the GELU), K5 (`has_csc`),
K3's emission in seg/full/masked modes (`out_col_scale`), K6's through K4,
K2's emission (`has_ecs`), `quantized_linear_native(col_scale)` for every
impl and `shared_prequant(col_scale)`. The model-level CB tests are in
`tests/test_torch_cb.py`.

Tolerances, each with its reason:
  * row quantizers (K4, K5's quantize, the emissions): as
    `tests/test_torch_asym.py` holds them — scales to one ulp (1e-5 after
    the attention, whose float reductions run in another order), zero
    points one apart, unshifted codes off by one at no more than 0.1% of
    entries; the column scale is one f32 multiply in both packages; K4's
    GELU cases to 3e-5 (see the test);
  * K5 = K4 then K2: 1e-4 relative (a moved code moves one product term).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_asym import check_rows
from test_torch_kernels import _attn_inputs, interp, rel_err, t
from torch_parity import CB, cb_plan, jax_kernel_path
from viditq_tpu.kernels import attention as jattn
from viditq_tpu.kernels import fused_matmul as jfm
from viditq_tpu.kernels import int_matmul as jim
from viditq_tpu.quant import core as jcore
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.kernels._common import k_major
from viditq_tpu_torch.quant import core, qlinear

CODE_FRAC = 1e-3


def col_scales(rng, k, edge=False):
    """1/cs as the model folds it: cs = smooth_quant_scale of random act and
    weight maxima at the recipe's alpha 0.11; edge: cs spanning 1e-3 to 1e3
    with some channels at exactly 1."""
    if edge:
        cs = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), k))
        cs[::7] = 1.0
    else:
        a = rng.uniform(0.01, 8.0, k)
        w = rng.uniform(1e-3, 0.1, k)
        cs = np.asarray(jcore.smooth_quant_scale(
            jnp.asarray(a, jnp.float32), jnp.asarray(w, jnp.float32), 0.11))
    return (1.0 / cs).astype(np.float32)


@pytest.mark.parametrize("sym,gelu,edge", [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, False), (False, False, True)],
    ids=["sym", "asym", "gelu-sym", "gelu-asym", "asym-edge"])
def test_k4_col_scale_matches_jax(sym, gelu, edge):
    rng = np.random.default_rng(50)
    M, K = 96, 256
    x = (rng.standard_normal((M, K)) * 2 + 0.4).astype(np.float32)
    x[5] = 0.0
    cs = col_scales(rng, K, edge)
    want = interp(jfm.quantize_rows_fused, jnp.asarray(x), sym=sym,
                  gelu=gelu, need_rowsum=not sym, block_m=32,
                  col_scale=jnp.asarray(cs))
    got = FM.quantize_rows(t(x), sym=sym, gelu=gelu, need_rowsum=not sym,
                           col_scale=t(cs))
    # GELU: XLA's CPU tanh is 2.4e-7 from the true tanh where PyTorch's is
    # 3e-8; where 1 + tanh(u) cancels (negative inputs, whose |gelu| a
    # column scale can make a row's largest) that moves the row's scale by
    # up to 1e-5 relative
    check_rows(got, want, sym=sym, scale_rtol=3e-5 if gelu else 2.5e-7)
    # the scale really enters
    plain = FM.quantize_rows(t(x), sym=sym, gelu=gelu)
    assert not torch.equal(plain[1], got[1])


@pytest.mark.parametrize("sym,sym_w", [(True, True), (False, False)],
                         ids=["sym", "asym"])
def test_k5_col_scale_matches_jax(sym, sym_w):
    # M = 240: cross_attn.kv_linear's rows (2 x 120 prompt tokens)
    rng = np.random.default_rng(51)
    M, K, N = 240, 128, 256
    x = (rng.standard_normal((M, K)) + 0.3).astype(np.float32)
    w = rng.integers(-8, 8, (K, N)).astype(np.int8)  # W4 codes
    ws = rng.uniform(1e-3, 1e-2, (1, N)).astype(np.float32)
    wzp = rng.integers(-4, 4, (1, N)).astype(np.float32)
    wcs = w.astype(np.float32).sum(0, keepdims=True)
    b = rng.standard_normal(N).astype(np.float32)
    cs = col_scales(rng, K)
    want = interp(jfm.fused_dynq_int8_matmul, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(ws), jnp.asarray(wzp), jnp.asarray(wcs),
                  sym=sym, sym_w=sym_w, bias=jnp.asarray(b),
                  out_dtype=jnp.float32, col_scale=jnp.asarray(cs))
    kw = dict(sym=sym, sym_w=sym_w, w_zp=t(wzp), w_colsum=t(wcs))
    got = FM.fused_dynq_int8_matmul(t(x), k_major(t(w)), t(ws), t(b),
                                    torch.float32, col_scale=t(cs), **kw)
    assert rel_err(got, want) < 1e-4
    # K5's function is K4 with the column scale, then K2
    q, s, zp, rs = FM.quantize_rows(t(x), sym, need_rowsum=not sym_w,
                                    col_scale=t(cs))
    route = FM.int8_consumer_matmul(
        q, s, t(w), t(ws), t(b), torch.float32, x_zp=zp, x_rowsum=rs,
        w_zp=None if sym_w else t(wzp), w_colsum=t(wcs))
    assert torch.equal(got, route)


@pytest.mark.parametrize("mode", ["seg", "full", "mask"])
@pytest.mark.parametrize("emit_sym", [True, False], ids=["sym", "asym"])
def test_k3_emission_col_scale_matches_jax(mode, emit_sym):
    rng = np.random.default_rng(52)
    H, D = 2, 16
    q, k, v, seg, mask = _attn_inputs(mode, H, D, seed=53)
    v += 0.5
    cs = col_scales(rng, H * D)
    jmask = None if mask is None else jnp.asarray(mask)
    want = interp(jattn.attention_bnhd_int8out, jnp.asarray(q),
                  jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5,
                  seg_len=seg, kv_mask=jmask, emit_sym=emit_sym,
                  need_rowsum=True, col_scale=jnp.asarray(cs))
    got = A.attention_bnhd(t(q), t(k), t(v), D ** -0.5, seg_len=seg,
                           kv_mask=None if mask is None else t(mask),
                           emit=True, emit_sym=emit_sym, need_rowsum=True,
                           col_scale=t(cs))
    check_rows([None if g is None else g.reshape(-1, g.shape[-1])
                for g in got],
               [None if w is None else w.reshape(-1, w.shape[-1])
                for w in want], sym=emit_sym, scale_rtol=1e-5)


def test_k6_emission_col_scale_is_k4s():
    # K6 emits through K4 with the column scale (attention.py:705-709)
    from test_torch_stream import D as SD
    from test_torch_stream import _inputs
    q, k, v, mask = _inputs(seed=54, masked=True)
    cs = col_scales(np.random.default_rng(55), q.shape[2] * SD)
    B, N, H, _ = q.shape
    got = A.attention_bnhd(t(q), t(k), t(v), SD ** -0.5, kv_mask=t(mask),
                           emit=True, emit_sym=False, need_rowsum=True,
                           col_scale=t(cs))
    out = A.attention_bnhd(t(q), t(k), t(v), SD ** -0.5, kv_mask=t(mask))
    want = FM.quantize_rows(out.reshape(B * N, H * SD), sym=False,
                            need_rowsum=True, col_scale=t(cs))
    assert all(torch.equal(g.reshape(w.shape), w) for g, w in zip(got, want))


def test_k2_emission_col_scale_matches_jax():
    # fc1's shape class: K = 1152 -> N = 4608 emits 3 groups (C1); the
    # column scale (fc2's 1/cs) after the GELU, before each group's absmax
    rng = np.random.default_rng(56)
    M, K, N = 16, 1152, 4608
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w = rng.integers(-8, 8, (K, N)).astype(np.int8)
    xs = rng.uniform(1e-3, 2e-2, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) * 0.1
    cs = col_scales(rng, N)
    codes, scales = interp(jfm.int8_consumer_matmul, jnp.asarray(xq),
                           jnp.asarray(xs), jnp.asarray(w), jnp.asarray(ws),
                           bias=jnp.asarray(b),
                           emit={"gelu": True, "col_scale": jnp.asarray(cs)})
    pc, ps = FM.int8_consumer_matmul(t(xq), t(xs), k_major(t(w)), t(ws), t(b),
                                     emit={"gelu": True, "col_scale": t(cs)})
    assert ps.shape == (M, 3)
    np.testing.assert_allclose(ps.numpy(), scales[:, ::128], rtol=1e-6)
    diff = np.abs(pc.numpy().astype(np.int32) - codes.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FRAC


@pytest.mark.parametrize("impl", [None, "xla", "mixed", "pallas", "fused"])
def test_quantized_linear_native_col_scale_matches_jax(impl):
    from test_torch_int_matmul import _packed
    rng = np.random.default_rng(57)
    x = (rng.standard_normal((2, 24, 128)) + 0.3).astype(np.float32)
    packed = _packed(rng, 128, 96, False)
    bias = rng.standard_normal(96).astype(np.float32)
    cs = col_scales(rng, 128)
    with jax_kernel_path():
        want = np.asarray(jim.quantized_linear_native(
            jnp.asarray(x), packed, bias=jnp.asarray(bias), act_sym=False,
            w_sym=False, out_dtype=jnp.float32, impl=impl,
            col_scale=jnp.asarray(cs)))
    got = IM.quantized_linear_native(
        t(x), {k: t(np.asarray(v)) for k, v in packed.items()},
        bias=t(bias), out_dtype=torch.float32, impl=impl, col_scale=t(cs))
    assert got.shape == (2, 24, 96)
    assert rel_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_shared_prequant_col_scale_matches_jax(impl):
    # the shared q/k/v quantize under qkv_share_cs: K4 with the pooled 1/cs
    # (fused), or one f32 pass then K7a (the native backend's other impls)
    from viditq_tpu.quant.qlinear import shared_prequant as j_shared
    from viditq_tpu.utils.config import load_quant_config as j_load
    from viditq_tpu_torch.utils.config import load_quant_config
    specs = [dataclasses.replace(cb_plan()(load(CB)).default_layer,
                                 impl=impl)
             for load in (j_load, load_quant_config)]
    rng = np.random.default_rng(60)
    x = (rng.standard_normal((2, 48, 128)) + 0.3).astype(np.float32)
    cs = col_scales(rng, 128)
    with jax_kernel_path():
        want = interp(j_shared, jnp.asarray(x), specs[0],
                      col_scale=jnp.asarray(cs))
    got = qlinear.shared_prequant(t(x), specs[1], col_scale=t(cs))
    assert got.codes.shape == (96, 128)
    check_rows(tuple(got)[:4], want, scale_rtol=2.5e-7)
    # without the pooled scale a CB layer's rescale is its own: no pass
    assert qlinear.shared_prequant(t(x), specs[1]) is None


def test_smooth_quant_scale_matches_jax():
    rng = np.random.default_rng(59)
    a = rng.uniform(0, 5, 256).astype(np.float32)
    w = rng.uniform(0, 0.2, 256).astype(np.float32)
    a[:3] = 0.0  # dead channels: the 1e-5 act clamp keeps cs finite
    w[3] = 0.0
    want = np.asarray(jcore.smooth_quant_scale(jnp.asarray(a),
                                               jnp.asarray(w), 0.11))
    got = core.smooth_quant_scale(t(a), t(w), 0.11).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-6)
