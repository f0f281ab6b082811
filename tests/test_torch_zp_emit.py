"""K2's int8 emission after a zero-point epilogue (fc1 with asymmetric
dynamic acts feeding a sym x sym fc2), on CPU tensors (the plain version),
against the JAX package's consumer kernel in interpret mode, and a tiny
STDiT forward under a plan whose fc1 takes asym acts, against the JAX
kernel path on the same weights.

Tolerances, each with its reason:
  * kernel: the int32 product is exact in both and the f32 epilogue, GELU
    and group statistic are the same sequence of operations; XLA takes
    `round(y * (1/s))` with its own reciprocal, so codes are equal or off
    by one at no more than 0.1% of the entries (C6), scales to 1e-6;
  * forward: 1e-2 relative, the fused plans' int8 forward limit
    (`tests/test_torch_fused.py`): every int8 layer turns float
    differences of an ulp into whole code flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Fc1AsymPlan
from test_torch_asym import _asym_tables
from test_torch_kernels import LAYOUTS, assert_codes_close, interp, t
from torch_parity import (SYM, build_jax, build_port, inputs,
                          jax_kernel_path, rel_err)
from viditq_tpu.kernels import fused_matmul as jfm
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.quant.qlinear import QuantCtx

FWD_TOL = 1e-2


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("act_sym,w_sym", [(False, True), (False, False),
                                           (True, False)],
                         ids=["asym-sym", "asym-asym", "sym-asym"])
def test_k2_zero_point_emission_matches_jax(act_sym, w_sym, layout):
    # fc1's shape class: K=1152 -> N=4608 emits G=3 groups of 1536 (C1)
    rng = np.random.default_rng(36)
    M, K, N = 16, 1152, 4608
    (xq, xs, xzp, xrs), w, ws, wzp, wcs, b = _asym_tables(
        rng, M, K, N, act_sym, w_sym)
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    p = lambda a: None if a is None else t(a)  # noqa: E731
    emit = {"gelu": True}
    codes, scales = interp(jfm.int8_consumer_matmul, j(xq), j(xs), j(w),
                           j(ws), x_zp=j(xzp), x_rowsum=j(xrs), w_zp=j(wzp),
                           w_colsum=j(wcs), bias=j(b), emit=emit)
    kw = dict(x_zp=p(xzp), x_rowsum=p(xrs), w_zp=p(wzp), w_colsum=p(wcs))
    pc, ps = FM.int8_consumer_matmul(p(xq), p(xs), LAYOUTS[layout](p(w)),
                                     p(ws), p(b), emit=emit, **kw)
    assert pc.dtype == torch.int8 and ps.shape == (M, 3)
    # the TPU layout pads each group's scale across 128 lanes
    np.testing.assert_allclose(ps.numpy(), scales[:, ::128], rtol=1e-6)
    assert_codes_close(pc, codes)
    # the zero-point terms really enter: without them the scales move
    _, plain_s = FM.int8_consumer_matmul(p(xq), p(xs), p(w), p(ws), p(b),
                                         emit=emit)
    assert rel_err(plain_s, scales[:, ::128]) > 1e-2


@pytest.fixture(scope="module")
def fc1_asym():
    """Both packages' tiny STDiT under the sym plan with fc1's acts asym
    (`chip_smoke.Fc1AsymPlan`, the card's `fc1_asym` arm: either package's
    plan with one resolver override)."""
    jmodel, jv = build_jax(SYM, plan_fn=Fc1AsymPlan)
    fn = jax.jit(lambda x, t_, y, m: jmodel.apply(
        jv, x, t_, y, m, qctx=JQuantCtx(mode="quant")))
    return fn, build_port(SYM, jv, plan_fn=Fc1AsymPlan)


def test_fc1_asym_forward_emits_with_zero_points(fc1_asym, monkeypatch):
    fn, port = fc1_asym
    mlp = port.blocks[0].mlp
    assert not mlp.fc1.lspec.act.sym and mlp.fc2.lspec.act.sym
    assert mlp.fc2.lspec.weight.sym
    seen = []
    k2 = FM.int8_consumer_matmul_plain

    def spy(*a, **kw):  # the wrapper passes emit and x_zp by position
        emit = a[7] if len(a) > 7 else kw.get("emit")
        if emit is not None:
            seen.append((a[8] if len(a) > 8 else kw.get("x_zp")) is not None)
        return k2(*a, **kw)
    monkeypatch.setattr(FM, "int8_consumer_matmul_plain", spy)
    args = inputs()
    with torch.no_grad():
        got = port(*(torch.from_numpy(np.array(a)) for a in args),
                   qctx=QuantCtx(mode="quant")).numpy()
    assert seen and all(seen)  # every block's fc1 emits, with x_zp
    with jax_kernel_path():
        want = np.asarray(fn(*args))
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
