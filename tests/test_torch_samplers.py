"""The port's samplers against the JAX package's, on toy noise models
(float32 in both): IDDPM's ancestral loop and DDIM with eta > 0, the
DPM-Solver family (singlestep, singlestep_fixed, taylor, thresholding,
denoise_to_zero, the other schedules and model types), SA-Solver, LCM and
EDM.

Host tableaus (schedules, singlestep coefficients, SA-Solver update rows,
grids, EDM sigmas) are held to 1e-6 relative, toy samples to 1e-5 (the
JAX package takes alpha/sigma of its scanned evaluations in float32, the
port in float64). Threefry's draws cannot be matched, so the noise is
pinned in both packages: the JAX hooks (`p_sample_loop(noise_fn=)`,
`SASolver.sample(_noise_fn=)`, the latter keyed by the folded key of each
step) return rows of one numpy table, the port's hooks the same rows;
where JAX has no hook (LCM, DDIM with eta > 0, `IDDPM.sample`,
`SASolverSampler`) `jax.random.normal` is patched to return one fixed
array, which the port's hook returns at every step. Last, the quant
context each model evaluation gets, (t_id, step_idx), in the order of the
evaluations: JAX's read under `jax.disable_jit()` (its scans then run in
Python), equal to the port's but for the evaluations JAX computes and
drops (EDM's Heun correction on its last step, SA-Solver PECE's on the
last step of more_steps); and a static-act plan on the tiny STDiT, whose
table slot each evaluation reads through `act_slot_map[t_id]`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_static import _ptq_pair
from torch_parity import build_jax, inputs, jax_kernel_path, rel_err
from viditq_tpu.pipelines import inference as j_inf
from viditq_tpu.samplers import SASolverSampler as JSA
from viditq_tpu.samplers import dpm_solver as jdpm
from viditq_tpu.samplers import extra_solvers as jex
from viditq_tpu.samplers import gaussian_diffusion as jgd
from viditq_tpu.samplers import iddpm as jiddpm
from viditq_tpu.samplers import sa_solver as jsa
from viditq_tpu_torch.pipelines import inference as p_inf
from viditq_tpu_torch.samplers import SASolverSampler
from viditq_tpu_torch.samplers import dpm_solver as pdpm
from viditq_tpu_torch.samplers import extra_solvers as pex
from viditq_tpu_torch.samplers import gaussian_diffusion as pgd
from viditq_tpu_torch.samplers import iddpm as piddpm
from viditq_tpu_torch.samplers import sa_solver as psa

TABLE_REL = 1e-6
SAMPLE_REL = 1e-5
SHAPE = (2, 4, 8, 8)
_RNG = np.random.default_rng(0)
X = _RNG.standard_normal(SHAPE).astype(np.float32)
BIAS = _RNG.standard_normal(SHAPE[1:]).astype(np.float32)
# pinned draws: row i is step i's (CFG-doubled shape for the IDDPM loops)
NOISE = _RNG.standard_normal((24, *SHAPE)).astype(np.float32)
FIXED = _RNG.standard_normal(SHAPE).astype(np.float32)
Y = _RNG.standard_normal((4, 1, 3, 5)).astype(np.float32)  # [cond; null]


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def close(got, want, tol=SAMPLE_REL):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    assert np.isfinite(got).all()
    assert rel(got, want) < tol, rel(got, want)


def traj_close(got, want):
    for k in ("xs", "ts"):
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        close(got[k].float(), np.asarray(want[k], np.float32))


# toy models: eps = 0.1 x + cos(5 t / 1000) bias (+ the prompt's mean);
# with `var`, channels C..2C carry tanh(x) as a learned variance
def toy_j(x, t, i):
    return 0.1 * x + jnp.cos(t / 1000.0 * 5.0).reshape(-1, 1, 1, 1) * BIAS


def toy_p(x, t, i):
    return 0.1 * x + torch.cos(t / 1000.0 * 5.0).reshape(-1, 1, 1, 1) \
        * torch.from_numpy(BIAS)


def toy_apply_j(x, t, y, mask, qctx, **kw):
    eps = toy_j(x, t.astype(jnp.float32), 0) + 0.2 * y.mean(
        axis=(1, 2, 3)).reshape(-1, 1, 1, 1)
    return jnp.concatenate([eps, jnp.tanh(x)], axis=1)


def toy_apply_p(x, t, y, mask, qctx, **kw):
    eps = toy_p(x, t.float(), 0) + 0.2 * y.mean(dim=(1, 2, 3)).reshape(
        -1, 1, 1, 1)
    return torch.cat([eps, torch.tanh(x)], dim=1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def pinned_p(table):
    return lambda x, i: torch.from_numpy(table[i]).to(x.dtype)


@pytest.fixture
def fixed_jax_normal(monkeypatch):
    """jax.random.normal -> the first rows of FIXED twice over, as many as
    the shape asked has (1, 2 or 4); returns the port's hook of the same
    draws."""
    def fixed(n):
        return np.concatenate([FIXED] * 2)[:n]

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(fixed(shape[0]), dtype)
    monkeypatch.setattr(jax.random, "normal", normal)
    return lambda x, i: torch.from_numpy(fixed(x.shape[0]))


# ---------------------------------------------------------------- IDDPM --

@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
@pytest.mark.parametrize("respacing", ["20", "ddim25", "10,5"])
def test_schedule_fields_match_jax(schedule, respacing):
    want = jgd.make_schedule(timestep_respacing=respacing,
                             noise_schedule=schedule)
    got = pgd.make_schedule(timestep_respacing=respacing,
                            noise_schedule=schedule)
    assert np.array_equal(got.timestep_map, want.timestep_map)
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
              "posterior_log_variance_clipped", "posterior_mean_coef1",
              "posterior_mean_coef2"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=TABLE_REL, atol=0)


@pytest.mark.parametrize("schedule,steps", [("linear", 6),
                                            ("squaredcos_cap_v2", 10)])
def test_p_sample_loop_matches_jax(schedule, steps):
    sch_j = jgd.make_schedule(steps, noise_schedule=schedule)
    sch_p = pgd.make_schedule(steps, noise_schedule=schedule)

    def fn_j(x, t, i):
        return jnp.concatenate([toy_j(x, t, i), jnp.tanh(x)], axis=1)

    def fn_p(x, t, i):
        return torch.cat([toy_p(x, t, i), torch.tanh(x)], dim=1)
    want, wtraj = jgd.p_sample_loop(
        fn_j, jnp.asarray(X), sch_j, jax.random.PRNGKey(0),
        capture_trajectory=True, noise_fn=lambda x, i: jnp.asarray(NOISE)[i])
    got, traj = pgd.p_sample_loop(fn_p, _t(X), sch_p, None,
                                  capture_trajectory=True,
                                  noise_fn=pinned_p(NOISE))
    close(got, want)
    traj_close(traj, wtraj)
    # the learned variance and the draws moved it off the DDIM sample
    ddim = pgd.ddim_sample_loop(fn_p, _t(X), sch_p)
    assert rel(got.numpy(), ddim.numpy()) > 1e-2


def test_ancestral_loop_needs_learned_variance():
    sch = pgd.make_schedule(3)
    with pytest.raises(ValueError, match="variance"):
        pgd.p_sample_loop(toy_p, _t(X), sch, torch.Generator())
    # and a generator or a hook: it draws
    fn = lambda x, t, i: torch.cat(  # noqa: E731
        [toy_p(x, t, i), torch.tanh(x)], 1)
    with pytest.raises(ValueError, match="generator"):
        pgd.p_sample_loop(fn, _t(X), sch)
    out = pgd.p_sample_loop(fn, _t(X).bfloat16(), sch,
                            torch.Generator().manual_seed(0))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


def test_iddpm_sample_ancestral_matches_jax(fixed_jax_normal):
    kw = dict(num_sampling_steps=5, cfg_scale=4.0)
    z = X[:1]
    want, wtraj = jiddpm.IDDPM(**kw).sample(
        toy_apply_j, jnp.asarray(z), jnp.asarray(Y[:2]), None,
        sampler_type="iddpm", rng=jax.random.PRNGKey(0),
        return_trajectory=True)

    got, traj = piddpm.IDDPM(**kw).sample(
        toy_apply_p, _t(z), _t(Y[:2]), None, sampler_type="iddpm",
        return_trajectory=True, noise_fn=fixed_jax_normal)
    close(got, want)
    traj_close(traj, wtraj)
    with pytest.raises(ValueError):
        piddpm.IDDPM(**kw).sample(toy_apply_p, _t(z), _t(Y[:2]),
                                  sampler_type="ancestral")


def test_ddim_eta_matches_jax(fixed_jax_normal):
    sch_j, sch_p = jgd.make_schedule(6), pgd.make_schedule(6)
    want = jgd.ddim_sample_loop(toy_j, jnp.asarray(X), sch_j, eta=0.7,
                                rng=jax.random.PRNGKey(0))
    got = pgd.ddim_sample_loop(toy_p, _t(X), sch_p, eta=0.7,
                               noise_fn=fixed_jax_normal)
    close(got, want)
    # eta = 0 is the deterministic DDIM of before
    det = pgd.ddim_sample_loop(toy_p, _t(X), sch_p)
    close(det, jgd.ddim_sample_loop(toy_j, jnp.asarray(X), sch_j))
    assert rel(got.numpy(), det.numpy()) > 1e-2


# ----------------------------------------------------------- DPM-Solver --

NOISE_SCHEDULES = {
    "discrete": {},
    "betas": {"betas": jgd.get_named_beta_schedule("squaredcos_cap_v2",
                                                   1000)},
    "alphas_cumprod": {"alphas_cumprod": np.cumprod(
        1 - np.linspace(1e-4, 0.03, 500))},
    "linear": {"schedule": "linear"},
}


@pytest.mark.parametrize("name", sorted(NOISE_SCHEDULES))
def test_noise_schedules_match_jax(name):
    js = jdpm.NoiseScheduleVP(**NOISE_SCHEDULES[name])
    ps = pdpm.NoiseScheduleVP(**NOISE_SCHEDULES[name])
    assert ps.total_N == js.total_N
    t = np.linspace(1e-3, 1.0, 37)
    for got, want in ((ps.marginal_log_mean_coeff, js._log_mean_coeff_np),
                      (ps.marginal_alpha, js._alpha_np),
                      (ps.marginal_std, js._std_np),
                      (ps.marginal_lambda, js._lambda_np)):
        np.testing.assert_allclose(got(t), want(t), rtol=TABLE_REL)
    lam = js._lambda_np(t)
    np.testing.assert_allclose(ps.inverse_lambda(lam),
                               js._inverse_lambda_np(lam), rtol=TABLE_REL)


@pytest.mark.parametrize("skip", ["time_uniform", "logSNR",
                                  "time_quadratic"])
def test_singlestep_orders_and_coeffs_match_jax(skip):
    js, ps = jdpm.NoiseScheduleVP(), pdpm.NoiseScheduleVP()
    for steps in (5, 6, 7):
        for order in (1, 2, 3):
            want = jdpm.get_orders_and_timesteps_for_singlestep(
                js, steps, order, skip, 1.0, 1e-3)
            got = pdpm.get_orders_and_timesteps_for_singlestep(
                ps, steps, order, skip, 1.0, 1e-3)
            assert got[1] == want[1]
            np.testing.assert_allclose(got[0], want[0], rtol=TABLE_REL)
    for order in (1, 2, 3):
        for alg in ("dpmsolver", "dpmsolver++"):
            for solver in ("dpmsolver", "taylor"):
                want = jdpm.singlestep_coeffs(js, 0.8, 0.35, order, alg,
                                              solver, skip)
                got = pdpm.singlestep_coeffs(ps, 0.8, 0.35, order, alg,
                                             solver, skip)
                assert got.order == want.order
                for f in ("eval_t", "cx", "b"):
                    np.testing.assert_allclose(
                        np.asarray(getattr(got, f)),
                        np.asarray(getattr(want, f)), rtol=TABLE_REL,
                        atol=1e-12)


DPM_CASES = [
    # method, order, algorithm, solver, skip, thresholding,
    # denoise_to_zero, steps, noise schedule
    ("singlestep", 3, "dpmsolver++", "dpmsolver", "logSNR", False, False,
     10, "discrete"),
    ("singlestep", 3, "dpmsolver", "taylor", "logSNR", False, True, 9,
     "discrete"),
    ("singlestep", 2, "dpmsolver", "taylor", "time_uniform", False, True, 9,
     "discrete"),
    ("singlestep", 1, "dpmsolver++", "dpmsolver", "time_quadratic", True,
     False, 6, "discrete"),
    ("singlestep", 3, "dpmsolver++", "taylor", "time_uniform", True, True,
     8, "discrete"),
    ("singlestep_fixed", 3, "dpmsolver++", "taylor", "time_uniform", True,
     True, 9, "discrete"),
    ("singlestep_fixed", 2, "dpmsolver", "dpmsolver", "logSNR", False,
     False, 8, "linear"),
    ("multistep", 3, "dpmsolver++", "taylor", "logSNR", True, True, 10,
     "discrete"),
    ("multistep", 2, "dpmsolver", "taylor", "time_uniform", False, True, 10,
     "betas"),
    ("multistep", 2, "dpmsolver++", "dpmsolver", "time_uniform", False,
     False, 12, "linear"),
]


@pytest.mark.parametrize("method,order,alg,solver,skip,thr,d2z,steps,ns",
                         DPM_CASES)
def test_dpm_toy_sample_matches_jax(method, order, alg, solver, skip, thr,
                                    d2z, steps, ns):
    kw = dict(steps=steps, order=order, skip_type=skip, method=method,
              denoise_to_zero=d2z, capture_trajectory=True)
    corr = "dynamic_thresholding" if thr else None
    # x 3: near t = T the x0 estimate then leaves [-1, 1], where the
    # thresholding acts
    x = 3.0 * X
    want, wtraj = jdpm.DPMSolver(
        toy_j, jdpm.NoiseScheduleVP(**NOISE_SCHEDULES[ns]), alg, solver,
        correcting_x0_fn=corr).sample(jnp.asarray(x), **kw)
    got, traj = pdpm.DPMSolver(
        toy_p, pdpm.NoiseScheduleVP(**NOISE_SCHEDULES[ns]), alg, solver,
        correcting_x0_fn=corr).sample(_t(x), **kw)
    close(got, want)
    traj_close(traj, wtraj)


def test_dynamic_thresholding_acts():
    x0 = torch.from_numpy(3.0 * X)
    out = pdpm.dynamic_threshold(x0, 0.995, 1.0)
    assert float(out.abs().max()) <= 1.0 + 1e-6
    s = torch.quantile(x0.abs().reshape(2, -1), 0.995, dim=1)
    np.testing.assert_allclose(
        out.numpy(), (torch.clamp(x0, -s.reshape(-1, 1, 1, 1),
                                  s.reshape(-1, 1, 1, 1))
                      / s.reshape(-1, 1, 1, 1)).numpy())
    np.testing.assert_allclose(
        pdpm.abs_quantile(x0, 0.995).numpy(),
        np.asarray(jnp.quantile(jnp.abs(jnp.asarray(3.0 * X)).reshape(2, -1),
                                0.995, axis=1)), rtol=TABLE_REL)


@pytest.mark.parametrize("model_type,cfg_split", [
    ("x_start", False), ("v", True), ("score", False)])
def test_dpm_sampler_model_types_match_jax(model_type, cfg_split):
    kw = dict(num_sampling_steps=6, cfg_scale=4.5, cfg_split=cfg_split,
              model_type=model_type, method="singlestep", order=2)
    z = X[:1]
    want = jdpm.DPMSolverSampler(**kw).sample(
        toy_apply_j, jnp.asarray(z), jnp.asarray(Y[:2]))
    got = pdpm.DPMSolverSampler(**kw).sample(toy_apply_p, _t(z),
                                             _t(Y[:2]))
    close(got, want)


def test_dpm_solver_pp_2m_matches_jax():
    want = jdpm.dpm_solver_pp_2m(toy_j, jnp.asarray(X), steps=7)
    got = pdpm.dpm_solver_pp_2m(toy_p, _t(X), steps=7)
    close(got, want)


# ------------------------------------------------------------ SA-Solver --

@pytest.mark.parametrize("skip", ["time", "logSNR", "karras"])
@pytest.mark.parametrize("skip_order", [1, 2])
def test_sa_time_steps_match_jax(skip, skip_order):
    want = jsa.sa_time_steps(jdpm.NoiseScheduleVP(), skip, 1.0, 1e-3, 12,
                             skip_order)
    got = psa.sa_time_steps(pdpm.NoiseScheduleVP(), skip, 1.0, 1e-3, 12,
                            skip_order)
    np.testing.assert_allclose(got, want, rtol=TABLE_REL)


def _jax_rows(ns, ts, tau_fn, po, co, predict_x0, few):
    """SASolver.sample's tableau loop (sa_solver.py:297-322)."""
    steps = len(ts) - 1
    warm = max(po, co - 1)
    pred, corr = [], []
    t_prev = [float(ts[0])]
    for step in range(1, steps + 1):
        t = float(ts[step])
        if step < warm:
            p, c = min(po, step), min(co, step + 1)
        else:
            p, c = min(po, steps - step + 1), min(co, steps - step + 2)
        tau = float(tau_fn(t))
        final = few and step == steps
        pred.append(jsa._adams_update_row(ns, t_prev, t, p,
                                          0.0 if final else tau, predict_x0,
                                          False, few))
        corr.append(jsa._adams_update_row(ns, t_prev, t, c, tau, predict_x0,
                                          True, few)
                    if co > 0 and not final else None)
        t_prev.append(t)
    return pred, corr


@pytest.mark.parametrize("po,co,alg,mode,tau", [
    (1, 0, "data_prediction", "few_steps", 0.0),
    (2, 2, "data_prediction", "few_steps", 0.6),
    (3, 4, "data_prediction", "more_steps", 1.0),
    (4, 3, "noise_prediction", "more_steps", 0.3),
    (2, 1, "noise_prediction", "few_steps", 0.0)])
def test_sa_update_rows_match_jax(po, co, alg, mode, tau):
    js = jdpm.NoiseScheduleVP()
    ts = jsa.sa_time_steps(js, "logSNR", 1.0, 1e-3, 9)
    tau_fn = lambda t: tau if 0.2 <= t <= 0.8 else 0.0  # noqa: E731
    few = mode == "few_steps"
    want_p, want_c = _jax_rows(js, ts, tau_fn, po, co,
                               alg == "data_prediction", few)
    solver = psa.SASolver(toy_p, pdpm.NoiseScheduleVP(), alg)
    got_ts, got_p, got_c = solver.tableau(9, 1.0, 1e-3, tau_fn, "logSNR", 1,
                                          po, co, few)
    np.testing.assert_allclose(got_ts, ts, rtol=TABLE_REL)
    for got, want in zip(got_p + got_c, want_p + want_c):
        assert (got is None) == (want is None)
        if got is None:
            continue
        np.testing.assert_allclose(
            [got.cx, got.noise_scale, *got.m_coef],
            [want.cx, want.noise_scale, *want.m_coef], rtol=TABLE_REL,
            atol=1e-12)


SA_CASES = [
    # predictor, corrector, pc_mode, mode, tau, algorithm, thresholding,
    # skip, skip_order
    (1, 0, "PEC", "few_steps", 0.0, "data_prediction", False, "time", 1),
    (2, 2, "PEC", "few_steps", "window", "data_prediction", False, "time",
     1),
    (3, 4, "PECE", "more_steps", 0.5, "data_prediction", True, "logSNR", 1),
    (4, 3, "PEC", "more_steps", 0.3, "noise_prediction", False, "karras", 1),
    (2, 1, "PECE", "few_steps", 1.0, "noise_prediction", False, "time", 2),
    (4, 4, "PECE", "few_steps", "window", "data_prediction", True, "karras",
     1),
]


@pytest.mark.parametrize("po,co,pc,mode,tau,alg,thr,skip,skip_order",
                         SA_CASES)
def test_sa_toy_sample_matches_jax(po, co, pc, mode, tau, alg, thr, skip,
                                   skip_order):
    steps = 8
    if tau == "window":
        tau = lambda t: 0.8 if 0.2 <= t <= 0.8 else 0.0  # noqa: E731
    rng = jax.random.PRNGKey(3)
    keys = jnp.stack([jax.random.fold_in(rng, i) for i in range(steps)])

    def noise_j(key, shape, dtype):
        idx = jnp.argmax(jnp.all(keys == key, axis=-1))
        return jnp.asarray(NOISE[:steps])[idx].astype(dtype)
    kw = dict(tau=tau, steps=steps, skip_type=skip, skip_order=skip_order,
              predictor_order=po, corrector_order=co, pc_mode=pc, mode=mode,
              capture_trajectory=True)
    corr = "dynamic_thresholding" if thr else None
    x = 3.0 * X
    want, wtraj = jsa.SASolver(toy_j, jdpm.NoiseScheduleVP(), alg,
                               correcting_x0_fn=corr).sample(
        jnp.asarray(x), rng=rng, _noise_fn=noise_j, **kw)
    got, traj = psa.SASolver(toy_p, pdpm.NoiseScheduleVP(), alg,
                             correcting_x0_fn=corr).sample(
        _t(x), _noise_fn=pinned_p(NOISE), **kw)
    close(got, want)
    traj_close(traj, wtraj)


def test_sa_solver_sampler_matches_jax(fixed_jax_normal):
    kw = dict(num_sampling_steps=7, cfg_scale=4.5, eta=1.0)
    z = X[:1]
    want, wtraj = jex.SASolverSampler(**kw).sample(
        toy_apply_j, jnp.asarray(z), jnp.asarray(Y[:2]),
        rng=jax.random.PRNGKey(0), return_trajectory=True)
    got, traj = pex.SASolverSampler(**kw).sample(
        toy_apply_p, _t(z), _t(Y[:2]), return_trajectory=True,
        _noise_fn=fixed_jax_normal)
    close(got, want)
    traj_close(traj, wtraj)


# ------------------------------------------------------------ LCM, EDM --

@pytest.mark.parametrize("dim", [8, 9])
def test_guidance_scale_embedding_matches_jax(dim):
    w = np.array([0.0, 3.5, 7.0], np.float32)
    # float32 sines of arguments up to 7000: the two libraries' range
    # reductions differ by ~3e-5 there
    np.testing.assert_allclose(
        pex.get_guidance_scale_embedding(_t(w), dim).numpy(),
        jex.get_guidance_scale_embedding(jnp.asarray(w), dim), atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(prediction_type="epsilon"),
    dict(prediction_type="sample", clip_sample=True),
    dict(prediction_type="v_prediction", thresholding=True,
         sample_max_value=1.5),
    dict(prediction_type="epsilon", guidance_embed_dim=6)],
    ids=["epsilon", "sample-clip", "v-threshold", "w_embed"])
def test_lcm_toy_sample_matches_jax(kw, fixed_jax_normal):
    seen = {}

    def apply_j(x, t, y, mask, qctx, **extra):
        seen["j"] = sorted(extra)
        return toy_apply_j(x, t, y, mask, qctx)

    def apply_p(x, t, y, mask, qctx, **extra):
        seen["p"] = sorted(extra)
        assert x.shape[0] == y.shape[0] == 2  # the cond half alone
        return toy_apply_p(x, t, y, mask, qctx)
    kw = dict(num_sampling_steps=4, cfg_scale=4.0, **kw)
    want, wtraj = jex.LCMScheduler(**kw).sample(
        apply_j, jnp.asarray(X), jnp.asarray(Y), rng=jax.random.PRNGKey(0),
        return_trajectory=True)
    got, traj = pex.LCMScheduler(**kw).sample(
        apply_p, _t(X), _t(Y), return_trajectory=True,
        noise_fn=fixed_jax_normal)
    close(got, want)
    traj_close(traj, wtraj)
    assert seen["p"] == seen["j"]
    assert np.array_equal(pex.LCMScheduler(**kw).timesteps,
                          jex.LCMScheduler(**kw).timesteps)


@pytest.mark.parametrize("steps", [2, 6])
def test_edm_matches_jax(steps):
    kw = dict(num_sampling_steps=steps, cfg_scale=4.0)
    np.testing.assert_allclose(pex.EDMSampler(**kw).sigmas(),
                               jex.EDMSampler(**kw).sigmas(), rtol=TABLE_REL)
    z = X[:1]
    want, wtraj = jex.EDMSampler(**kw).sample(
        toy_apply_j, jnp.asarray(z), jnp.asarray(Y[:2]),
        return_trajectory=True)
    got, traj = pex.EDMSampler(**kw).sample(
        toy_apply_p, _t(z), _t(Y[:2]), return_trajectory=True)
    close(got, want)
    traj_close(traj, wtraj)


# ------------------------------------------- the quant context tie-out --

def _recorder(calls):
    def factory(t_id, step_idx):
        calls.append((int(t_id), int(step_idx)))
        return None
    return factory


def _runs():
    """(JAX run, port run, what JAX evaluates and drops) of each new loop
    shape, each run taking a qctx factory."""
    z_j, z_p = jnp.asarray(X[:1]), _t(X[:1])
    y_j, y_p = jnp.asarray(Y[:2]), _t(Y[:2])
    dpm = dict(num_sampling_steps=6, method="singlestep", order=3,
               thresholding=True, denoise_to_zero=True)
    sa = dict(num_sampling_steps=6, predictor_order=3, corrector_order=3,
              pc_mode="PECE", mode="more_steps")
    return {
        "iddpm": (lambda f: jiddpm.IDDPM(3).sample(
            toy_apply_j, z_j, y_j, sampler_type="iddpm",
            rng=jax.random.PRNGKey(0), qctx_factory=f),
            lambda f: piddpm.IDDPM(3).sample(
                toy_apply_p, z_p, y_p, sampler_type="iddpm",
                generator=torch.Generator().manual_seed(0),
                qctx_factory=f), 0),
        "dpm singlestep": (
            lambda f: jdpm.DPMSolverSampler(**dpm).sample(
                toy_apply_j, z_j, y_j, qctx_factory=f),
            lambda f: pdpm.DPMSolverSampler(**dpm).sample(
                toy_apply_p, z_p, y_p, qctx_factory=f), 0),
        "sa-solver": (lambda f: jex.SASolverSampler(**sa).sample(
            toy_apply_j, z_j, y_j, qctx_factory=f),
            lambda f: pex.SASolverSampler(**sa).sample(
                toy_apply_p, z_p, y_p, qctx_factory=f), 1),
        "lcm": (lambda f: jex.LCMScheduler(4).sample(
            toy_apply_j, z_j, y_j, qctx_factory=f),
            lambda f: pex.LCMScheduler(4).sample(
                toy_apply_p, z_p, y_p,
                generator=torch.Generator().manual_seed(0),
                qctx_factory=f), 0),
        "edm": (lambda f: jex.EDMSampler(4).sample(
            toy_apply_j, z_j, y_j, qctx_factory=f),
            lambda f: pex.EDMSampler(4).sample(
                toy_apply_p, z_p, y_p, qctx_factory=f), 1)}


@pytest.mark.parametrize("name", ["iddpm", "dpm singlestep", "sa-solver",
                                  "lcm", "edm"])
def test_quant_context_sequence_matches_jax(name):
    run_j, run_p, dropped = _runs()[name]
    want, got = [], []
    with jax.disable_jit():
        run_j(_recorder(want))
    run_p(_recorder(got))
    assert len(want) == len(got) + dropped
    if name == "edm":  # the Heun correction of the last step
        del want[-1]
    if name == "sa-solver":  # PECE's re-evaluation of the last step
        del want[-2]
    assert got == want


NAIVE = "configs/opensora/w8a8_naive.yaml"
DENOISE_TOL = 2e-2
SX, _, _SY, SMASK = inputs(batch=1, seed=3)
SY2 = np.concatenate([_SY, inputs(batch=1, seed=4)[2]])  # [cond; null]


def _two_slots(plan):
    d = plan.default_layer
    return dataclasses.replace(plan, default_layer=dataclasses.replace(
        d, act=dataclasses.replace(d.act, timestep_wise=True,
                                   n_timestep=2)))


def test_static_plan_reads_slots_through_t_id():
    """A static-act plan (`w8a8_naive`, timestep-wise act tables of two
    slots; the tiny STDiT at depth 1) calibrated by `run_ptq` in both packages on JAX's SA-Solver
    trajectory: its quantized SA-Solver run reads each evaluation's slot
    through `act_slot_map[t_id]` as JAX's does (2e-2)."""
    jmodel, jv = build_jax(NAIVE, plan_fn=_two_slots, depth=1)
    kw = dict(num_sampling_steps=2, cfg_scale=4.0)
    with jax_kernel_path():
        jcal = j_inf.get_calib_data(jmodel, jv, JSA(**kw), jnp.asarray(SX),
                                    jnp.asarray(SY2), jnp.asarray(SMASK))
    # tables to 1e-3, as tests/test_torch_plans.py holds code flips: at
    # SA-Solver's fractional second timestep, 499.5, the two packages'
    # timestep embeddings differ by ~1e-6, which flips bf16 q.k roundings
    # (1.4e-4 on two a_delta here)
    jres, port = _ptq_pair(NAIVE, jmodel, jv, jcal, plan_fn=_two_slots,
                           table_rel=1e-3, depth=1)
    slot_map = jres.act_slot_map
    # the two calibrated timesteps sit in different slots
    assert len(set(slot_map[np.asarray(jcal["ts"][:, 0]).astype(int)])) == 2
    with jax_kernel_path():
        want = j_inf.quant_sample(jmodel, jres.variables, JSA(**kw),
                                  jnp.asarray(SX), jnp.asarray(SY2),
                                  jnp.asarray(SMASK), act_slot_map=slot_map)
    got = p_inf.quant_sample(port, SASolverSampler(**kw), _t(SX), _t(SY2),
                             _t(SMASK), act_slot_map=slot_map)
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    # against the same tables read from slot 0 alone
    one = p_inf.quant_sample(port, SASolverSampler(**kw), _t(SX), _t(SY2),
                             _t(SMASK), act_slot_map=np.zeros_like(slot_map))
    assert rel_err(got.numpy(), one.numpy()) > 1e-4
