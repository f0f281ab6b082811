"""Heads wider than 128 on models: the tiny STDiT of 2 blocks at hidden
384 in 2 heads of 192 and the tiny DiT of 2 blocks at hidden 256 in 1 head
of 256, their fp and sm8 forwards against the JAX package's on its kernel
path (`torch_parity.jax_kernel_path`: the Pallas kernels in interpret
mode) on the same bridged weights, within 1e-4 (fp) and 1e-2 (sm8: the
int8 noise floor, PERF.md §2). The kernels at these head dims alone:
tests/test_torch_head_dims_wide.py.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_kernels import rel_err, t
from torch_parity import SM8, build_jax, build_port, inputs, jax_kernel_path
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.quant.qlinear import QuantCtx

# the wide heads on models: STDiT in 2 heads of 192, DiT in 1 head of 256
WIDE_MODELS = {"stdit": dict(hidden_size=384, num_heads=2),
               "dit": dict(hidden_size=256, num_heads=1)}


def _weight_scale(hidden: int) -> float:
    """The tiny models' weight draw (x 0.1 at hidden 64) scaled by
    sqrt(64 / hidden), so the wider models' activations keep the tiny
    ones' size (as chip_smoke.TINY_MS_SCALE does at hidden 192): at x 0.1
    a hidden-384 STDiT's scores grow so sharp that the bf16 rounding of
    q and k, which both packages take from f32 products summed in their
    own order, moves its fp forward by 1e-2 at any head split (6 heads of
    64 as 2 of 192)."""
    return 0.1 * (64 / hidden) ** 0.5


@pytest.fixture(scope="module", params=sorted(WIDE_MODELS))
def wide_model(request):
    kind = request.param
    jmodel, jv = build_jax(SM8, kind=kind,
                           weight_scale=_weight_scale(
                               WIDE_MODELS[kind]["hidden_size"]),
                           **WIDE_MODELS[kind])
    return kind, jmodel, jv, build_port(SM8, jv, kind=kind,
                                        **WIDE_MODELS[kind])


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "sm8"])
def test_wide_head_model_forward_matches_jax(wide_model, quant):
    kind, jmodel, jv, port = wide_model
    blk = port.blocks[0]
    attn = blk.attn if kind == "dit" else blk.attn_temp
    assert attn.head_dim == (256 if kind == "dit" else 192)
    x, tt, y, mask = inputs(kind=kind)
    mode = "quant" if quant else "fp"
    with jax_kernel_path():
        want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
            v, *a, qctx=JQuantCtx(mode=mode, t_id=500)))(jv, x, tt, y, mask))
    with torch.no_grad():
        got = port(t(x), t(tt), t(y), t(mask), qctx=QuantCtx(
            mode=mode, t_id=500)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < (1e-2 if quant else 1e-4)
