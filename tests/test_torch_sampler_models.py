"""The new sampler loops on the tiny quantized STDiT (`tests/torch_parity.py`,
one block, sm8 on the JAX kernel path in interpret mode), port against JAX, 2-step
runs of each loop shape held to the denoise tolerance 2e-2: IDDPM's
ancestral loop, DPM-Solver singlestep with thresholding and
denoise_to_zero, SA-Solver, LCM (the model on the cond prompts alone)
and EDM (the model's timestep sigma, its quant context's t_id from log
sigma). Draws are pinned as in `tests/test_torch_samplers.py`. The JAX
forward is jitted once and shared by the loops, which run eagerly around
it (`jax.disable_jit()`): one compile instead of one a loop. The
static-act plan's slot tie-out is in `tests/test_torch_samplers.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SM8, build_jax, build_port, inputs,
                          jax_kernel_path, rel_err)
from viditq_tpu.samplers import DPMSolverSampler as JDPM
from viditq_tpu.samplers import EDMSampler as JEDM
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.samplers import LCMScheduler as JLCM
from viditq_tpu.samplers import SASolverSampler as JSA
from viditq_tpu.samplers import default_qctx_factory as j_qctx_factory
from viditq_tpu_torch.samplers import (IDDPM, DPMSolverSampler, EDMSampler,
                                       LCMScheduler, SASolverSampler)
from viditq_tpu_torch.samplers.iddpm import default_qctx_factory

DENOISE_TOL = 2e-2
DEPTH = 1  # one block: the JAX forward's compile and interpret-mode run
X, _, Y, MASK = inputs(batch=1, seed=3)
Y2 = np.concatenate([Y, inputs(batch=1, seed=4)[2]])  # [cond; null]
X2 = np.concatenate([X, inputs(batch=1, seed=6)[0]])
Y4 = np.concatenate([Y, inputs(batch=1, seed=7)[2], Y2[1:], Y2[1:]])
FIXED = np.random.default_rng(5).standard_normal(
    (2, *X.shape[1:])).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def stdit():
    """(JAX model_apply, the port's model): the JAX forward jitted once
    and shared by every loop (its timestep as float32), each loop's own
    code run eagerly around it (`jax.disable_jit()` in the test)."""
    jmodel, jv = build_jax(SM8, depth=DEPTH)
    fwd = jax.jit(lambda x, t, y, m, q: jmodel.apply(jv, x, t, y, m,
                                                     qctx=q))

    def apply(x, t, y, mask, qctx, **kw):
        with jax.disable_jit(False), jax_kernel_path():
            return fwd(x, t.astype(jnp.float32), y, mask, qctx)
    return apply, build_port(SM8, jv, depth=DEPTH)


@pytest.fixture
def pinned(monkeypatch):
    """jax.random.normal -> FIXED's first rows at the shape asked; the
    port's hook of the same draws."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.asarray(FIXED[:shape[0]], dtype))
    return lambda x, i: _t(FIXED[:x.shape[0]]).to(x.dtype)


# (JAX sampler, port sampler, sample keywords of each: draws pinned).
# EDM's last Euler step, to sigma = 0, and DPM-Solver's denoise_to_zero
# return the denoiser's CFG mix itself, whose int8 noise a scale s
# multiplies by ~2s - 1: 2.7e-2 at s = 4 for the singlestep case, 5.5e-3
# at s = 1 (float32 without quantization: 1.0e-5 and 4.7e-6). Those two
# run unguided, s = 1; the CFG mix is held at s = 4.5 by
# tests/test_torch_samplers.py
CASES = {
    "iddpm": (JIDDPM(2), IDDPM(2), dict(sampler_type="iddpm")),
    "dpm singlestep": (
        JDPM(2, cfg_scale=1.0, method="singlestep", thresholding=True,
             denoise_to_zero=True),
        DPMSolverSampler(2, cfg_scale=1.0, method="singlestep",
                         thresholding=True, denoise_to_zero=True), {}),
    "sa-solver": (JSA(2, eta=1.0), SASolverSampler(2, eta=1.0), {}),
    "lcm": (JLCM(2), LCMScheduler(2), {}),
    "edm": (JEDM(2, cfg_scale=1.0), EDMSampler(2, cfg_scale=1.0), {}),
}
HOOK = {"iddpm": "noise_fn", "sa-solver": "_noise_fn", "lcm": "noise_fn"}


@pytest.mark.parametrize("name", list(CASES))
def test_quantized_loop_matches_jax(stdit, name, pinned):
    jax_apply, port = stdit
    js, ps, kw = CASES[name]
    # LCM runs the model on the cond half: two latents, so its forwards
    # take the CFG loops' batch of 2
    x, y = (X2, Y4) if name == "lcm" else (X, Y2)
    with jax.disable_jit():
        want = js.sample(jax_apply, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(MASK), rng=jax.random.PRNGKey(0),
                         qctx_factory=j_qctx_factory("quant"), **kw)
    if name in HOOK:
        kw = {**kw, HOOK[name]: pinned}
    with torch.no_grad():
        got = ps.sample(port, _t(x), _t(y), _t(MASK),
                        qctx_factory=default_qctx_factory("quant"), **kw)
    assert got.shape == x.shape and torch.isfinite(got).all()
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01
