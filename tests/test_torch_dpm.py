"""The port's multistep DPM-Solver against the JAX package's: the solver
tableau (numpy float64 in both, equal to 1e-6) and a 20-step sample of a
toy noise model (float32 in both; 1e-5 relative, since the JAX package
takes alpha/sigma of the later steps in float32 and the port in
float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viditq_tpu.samplers import dpm_solver as jdpm
from viditq_tpu_torch.samplers import dpm_solver as pdpm

CASES = [(2, "time_uniform", "dpmsolver++", False),
         (3, "logSNR", "dpmsolver++", True),
         (2, "time_quadratic", "dpmsolver", True),
         (1, "time_uniform", "dpmsolver++", False)]


def _jax_tableau(steps, order, skip, alg, lof):
    """The tableau as `DPMSolver._sample_multistep` builds it."""
    ns = jdpm.NoiseScheduleVP()
    ts = jdpm.get_time_steps(ns, skip, 1.0, 1.0 / ns.total_N, steps)
    tab = []
    for step in range(1, steps + 1):
        o = min(order, step)
        if lof:
            o = min(o, steps + 1 - step)
        t_prev = [ts[max(step - 1 - j, 0)] for j in range(2, -1, -1)]
        tab.append(jdpm.multistep_coeffs(ns, t_prev, ts[step], o, alg,
                                         "dpmsolver"))
    return ts, np.asarray(tab)


@pytest.mark.parametrize("order,skip,alg,lof", CASES)
def test_tableau_matches_jax(order, skip, alg, lof):
    want_ts, want = _jax_tableau(20, order, skip, alg, lof)
    ns = pdpm.NoiseScheduleVP()
    ts, tab = pdpm.multistep_tableau(ns, 20, 1.0, 1.0 / ns.total_N, order,
                                     skip, lof, alg, "dpmsolver")
    np.testing.assert_allclose(ts, want_ts, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tab, want, rtol=1e-6, atol=1e-12)
    assert ns.total_N == jdpm.NoiseScheduleVP().total_N


@pytest.mark.parametrize("order,skip,alg,lof", CASES)
def test_toy_sample_matches_jax(order, skip, alg, lof):
    x = np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    kw = dict(steps=20, order=order, skip_type=skip, lower_order_final=lof)
    want = jdpm.DPMSolver(
        lambda x, t, i: 0.3 * x + 0.05 * (t[0] / 1000.0),
        jdpm.NoiseScheduleVP(), algorithm_type=alg).sample(
            jnp.asarray(x), **kw)
    got = pdpm.DPMSolver(
        lambda x, t, i: 0.3 * x + 0.05 * (t[0] / 1000.0),
        pdpm.NoiseScheduleVP(), algorithm_type=alg).sample(
            torch.from_numpy(x), **kw)
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert err < 1e-5, err


def test_sampler_lower_order_final_auto_follows_step_count():
    assert not pdpm.DPMSolverSampler(num_sampling_steps=20).lower_order_final
    assert pdpm.DPMSolverSampler(num_sampling_steps=5).lower_order_final


@pytest.mark.parametrize("kw", [dict(method="singlestep"),
                                dict(thresholding=True),
                                dict(denoise_to_zero=True),
                                dict(model_type="v")])
def test_unported_sampler_options_raise(kw):
    with pytest.raises(NotImplementedError):
        pdpm.DPMSolverSampler(**kw)
