"""The port's MMDiT and its rectified-flow sampler against the JAX package
on equal weights (tests/torch_parity.py's tiny MMDiT: a 32x32 latent, 256
image tokens and 8 caption tokens, C = 64, 4 heads, 2 blocks), the JAX
side on its kernel path (Pallas interpret mode): the fp forward, the
forward under the MMDiT W4A8 plan (`configs/mmdit/w4a8_tpu_fused.yaml`:
sym W4 per channel, dynamic sym A8, the text stream fp; the image stream
through K1 -> K2, fc1's emission -> K2, K5 at its proj), a 3-step
`rectified_flow_sample` under that plan, the sampler's times, and the
quant checkpoint in both directions.

Tolerances: fp forward 1e-4 relative (float32; the joint attention is f32
`sdpa` in both packages); quantized forward 1e-2 and the 3-step sampling
2e-2, the int8 limits of PERF.md §2 (the int8 layers turn ulp differences
of the two libraries into code flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (build_jax, build_port, inputs, jax_kernel_path,
                          quant_ckpt_crosses, rel_err)
from viditq_tpu.models.mmdit import rectified_flow_sample as j_rf_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.models.mmdit import rectified_flow_sample
from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.utils.config import load_quant_config

W4A8 = "configs/mmdit/w4a8_tpu_fused.yaml"
FP_TOL = 1e-4
QUANT_TOL = 1e-2
DENOISE_TOL = 2e-2


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def models():
    jmodel, jv = build_jax(W4A8, kind="mmdit")
    return jmodel, jv, build_port(W4A8, jv, kind="mmdit")


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "w4a8"])
def test_forward_matches_jax(models, quant):
    jmodel, jv, port = models
    x, t, y, mask = inputs(kind="mmdit")
    mode = "quant" if quant else "fp"
    with jax_kernel_path():
        want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
            v, *a, qctx=JQuantCtx(mode=mode, t_id=500)))(jv, x, t, y, mask))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(y), _t(mask),
                   qctx=QuantCtx(mode=mode, t_id=500)).numpy()
    assert got.shape == want.shape == x.shape and np.isfinite(got).all()
    assert rel_err(got, want) < (QUANT_TOL if quant else FP_TOL)


def test_plan_names_resolve_as_in_jax(models):
    """The per-stream projections keep the flax module names
    (`img_attn_proj`) and resolve the plan's `blocks.N.img_attn.proj`; the
    text stream and the adaLN heads stay fp by the plan's fp list."""
    _, _, port = models
    res = load_quant_config(W4A8).resolver()
    for i, block in enumerate(port.blocks):
        assert block.img_attn_proj.lspec == res(f"blocks.{i}.img_attn.proj")
        assert block.img_attn_proj.native and block.img_attn.q.native
        assert block.img_mlp.fc2.native
        for lin in (block.txt_attn_proj, block.txt_attn.q, block.txt_mlp.fc1):
            assert not lin.lspec.weight_quant and not lin.native
        assert block.adaLN_linear.lspec is None


def test_quant_ckpt_crosses(models, tmp_path):
    _, jv, _ = models
    port = build_port(W4A8, {"params": jv["params"]}, fp_only=True,
                      kind="mmdit")
    keys = quant_ckpt_crosses(jv, port, str(tmp_path / "j.npz"),
                              str(tmp_path / "p.npz"))
    assert "blocks.1.img_attn_proj::w_delta" in keys


def test_rectified_flow_sample_matches_jax(models):
    jmodel, jv, port = models
    x, _, y, mask = inputs(batch=1, seed=3, kind="mmdit")
    y2 = np.concatenate([y, inputs(batch=1, seed=4, kind="mmdit")[2]])

    def j_apply(xx, tt, yy, mm, qctx):
        return jmodel.apply(jv, xx, tt, yy, mm, qctx=qctx)

    with jax_kernel_path():
        want = np.asarray(jax.jit(lambda z, yy, mm: j_rf_sample(
            j_apply, z, yy, mm, num_steps=3, cfg_scale=4.0,
            qctx_factory=lambda t_id, i: JQuantCtx(mode="quant",
                                                   t_id=t_id)))(
            x, y2, mask))
    got = rectified_flow_sample(
        port, _t(x), _t(y2), _t(mask), num_steps=3, cfg_scale=4.0,
        qctx_factory=lambda t_id, i: QuantCtx(mode="quant", t_id=t_id))
    got = got.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < DENOISE_TOL
    assert rel_err(got, x) > 0.01


@pytest.mark.parametrize("steps", [3, 7, 20])
def test_rectified_flow_times_match_jax(steps):
    """The model's float32 times, the contexts' timesteps and the Euler
    updates of JAX's scan, on a velocity that depends on x, t and the
    context's timestep."""
    z = np.random.default_rng(0).standard_normal((1, 2, 4, 4)).astype(
        np.float32)

    def apply(xx, tt, yy, mm, t_id):
        return xx * 0.5 + tt.reshape(-1, 1, 1, 1) * 1e-3 + t_id * 1e-4

    want, traj = j_rf_sample(apply, jnp.asarray(z), None, num_steps=steps,
                             qctx_factory=lambda t_id, i: t_id,
                             return_trajectory=True)
    seen = []

    def p_apply(*a):
        seen.append(a[-1])
        return apply(*a)

    got, ptraj = rectified_flow_sample(
        p_apply, _t(z), None, num_steps=steps,
        qctx_factory=lambda t_id, i: t_id, return_trajectory=True)
    ts = np.asarray(traj["ts"])
    np.testing.assert_array_equal(ptraj["ts"].numpy(), ts)
    assert seen == [min(max(int(t), 0), 999) for t in ts[:, 0]]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
