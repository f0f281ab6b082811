"""The port's training losses (`viditq_tpu_torch/samplers/
diffusion_losses.py`) against the JAX package's `diffusion_losses.py`
on the same inputs (mirroring `tests/test_diffusion_losses.py`): the
likelihoods, the posterior and the learned-range model mean and
variance, the vb terms, all four loss types with their gradients into a
toy model's mean and variance heads, the refusals, and the timestep
samplers. Float32 throughout; the values are held to 1e-5 relative
(`REL`), the gradients to 1e-4 relative in norm. The discretized
log-likelihood (the vb term at t = 0) is held to 1e-2 (`LOG_REL`, the
JAX package's own bound against the reference, tests/
test_diffusion_losses.py:52): its bins subtract two cdfs near 1, where
one f32 ulp of tanh (2^-24 against 1 - tanh(6) ~ 1e-5) is 0.5% of the
difference, and XLA's and torch's tanh differ by that ulp.

The loss-second-moment resampler's state and weights are held equal to
JAX's after one (t, loss) stream that repeats timesteps within a batch;
its draws (threefry against torch's) cannot match, so they are held to
the weights' distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import rel_err
from viditq_tpu.samplers import diffusion_losses as J
from viditq_tpu.samplers import make_schedule as j_make_schedule
from viditq_tpu_torch.samplers import diffusion_losses as P
from viditq_tpu_torch.samplers import make_schedule

REL = 1e-5
LOG_REL = 1e-2
GRAD_REL = 1e-4
LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rel,
                               atol=rel * float(np.abs(want).max()))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_likelihoods_match_jax():
    m1, m2, lv1, lv2 = (_rand(i, 4, 8) for i in range(4))
    T = torch.from_numpy
    _close(P.normal_kl(T(m1), T(lv1), T(m2), T(lv2)),
           J.normal_kl(m1, lv1, m2, lv2))
    x = np.clip(_rand(4, 6, 8) * 0.7, -1, 1)
    x[0, :4] = [-1.0, 1.0, -0.9995, 0.9995]  # the two tails
    means, ls = 0.1 * _rand(5, 6, 8), -2.0 + 0.1 * _rand(6, 6, 8)
    _close(P.approx_standard_normal_cdf(T(x)),
           J.approx_standard_normal_cdf(x))
    _close(P.continuous_gaussian_log_likelihood(
        T(x), means=T(means), log_scales=T(ls)),
        J.continuous_gaussian_log_likelihood(x, means=means, log_scales=ls))
    _close(P.discretized_gaussian_log_likelihood(
        T(x), means=T(means), log_scales=T(ls)),
        J.discretized_gaussian_log_likelihood(x, means=means,
                                              log_scales=ls), LOG_REL)


def _toy(lib, w, eps_only=False):
    """A model of x_t alone: eps = 0.1 x_t + 0.01 x_t @ w and the variance
    head tanh(x_t @ w) (the JAX test's), concatenated on channels; w
    trains both."""
    if lib == "jax":
        def fn(x_t, tt):
            eps = x_t * 0.1 + 0.01 * x_t @ w
            return eps if eps_only else jnp.concatenate(
                [eps, jnp.tanh(x_t @ w)], axis=1)
        return fn

    def fn(x_t, tt):
        eps = x_t * 0.1 + 0.01 * x_t @ w
        return eps if eps_only else torch.cat([eps, torch.tanh(x_t @ w)],
                                              dim=1)
    return fn


def _loss_inputs():
    x0 = _rand(0, 3, 4, 8, 8)
    noise = _rand(1, 3, 4, 8, 8)
    t = np.array([0, 3, 7])  # t = 0: the vb term is the decoder nll
    w = _rand(2, 8, 8) * 0.1
    return x0, noise, t, w


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_training_losses_full_matches_jax(loss_type):
    """Each loss type's terms, and the gradient of its mean loss into the
    toy model's shared weights (the mean and the variance heads), against
    JAX's."""
    x0, noise, t, w = _loss_inputs()
    js, ps = j_make_schedule(num_sampling_steps=10), make_schedule(
        num_sampling_steps=10)

    def jloss(wj):
        return J.training_losses_full(_toy("jax", wj), x0, t, noise, js,
                                      loss_type)
    want = jloss(w)
    wt = torch.from_numpy(w.copy()).requires_grad_()
    got = P.training_losses_full(_toy("torch", wt), torch.from_numpy(x0),
                                 torch.from_numpy(t), torch.from_numpy(noise),
                                 ps, loss_type)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == (3,)
        _close(got[k], want[k])
    gw = jax.grad(lambda wj: jnp.mean(jloss(wj)["loss"]))(w)
    (gt,) = torch.autograd.grad(got["loss"].mean(), [wt])
    assert float(np.abs(gw).sum()) > 0
    assert rel_err(gt.numpy(), gw) <= GRAD_REL


def test_vb_terms_train_only_the_variance_head():
    """vb_terms per sample (t = 0: the decoder nll, LOG_REL; else the kl)
    and its gradient into the model output: with stop_mean_grad
    (training_losses' frozen mean) none reaches eps, without it some;
    both against JAX's."""
    x0, noise, t, w = _loss_inputs()
    js, ps = j_make_schedule(num_sampling_steps=10), make_schedule(
        num_sampling_steps=10)
    out = np.concatenate([0.1 * noise, np.tanh(x0 @ w)], axis=1)
    x_t = np.asarray(0.5 * x0 + 0.5 * noise, np.float32)
    for stop in (True, False):
        def jvb(o):
            return J.vb_terms(js, o, x0, x_t, t, 4, stop_mean_grad=stop)
        want = jvb(out)
        ot = torch.from_numpy(out.copy()).requires_grad_()
        got = P.vb_terms(ps, ot, torch.from_numpy(x0), torch.from_numpy(x_t),
                         torch.from_numpy(t), 4, stop_mean_grad=stop)
        _close(got[:1], want[:1], LOG_REL)
        _close(got[1:], want[1:])
        # the kl samples' gradient (t > 0)
        gj = jax.grad(lambda o: jnp.sum(jvb(o)[1:]))(out)
        (gt,) = torch.autograd.grad(got[1:].sum(), [ot])
        assert rel_err(gt.numpy(), gj) <= GRAD_REL
        assert bool(gt[:, :4].abs().sum() == 0) == stop


@pytest.mark.parametrize("clip", [False, True])
def test_posterior_and_model_mean_match_jax(clip):
    x0, noise, t, _ = _loss_inputs()
    js, ps = j_make_schedule(num_sampling_steps=10), make_schedule(
        num_sampling_steps=10)
    x_t = 0.5 * x0 + 0.5 * noise
    T = torch.from_numpy
    for a, b in zip(P.q_posterior_mean_logvar(ps, T(x0), T(x_t), T(t)),
                    J.q_posterior_mean_logvar(js, x0, x_t, t)):
        _close(a, b)
    var = np.tanh(noise)
    for a, b in zip(
            P.p_mean_logvar_learned_range(ps, T(0.1 * noise), T(var), T(x_t),
                                          T(t), clip_denoised=clip),
            J.p_mean_logvar_learned_range(js, 0.1 * noise, var, x_t, t,
                                          clip_denoised=clip)):
        _close(a, b)


def test_eps_only_model_and_refusals():
    """An eps-only model: the mse types give mse alone (vb zeros), the kl
    types raise as in JAX; an unknown loss type raises (JAX asserts);
    vb_terms refuses an output without the variance channels."""
    x0, noise, t, w = _loss_inputs()
    js, ps = j_make_schedule(num_sampling_steps=10), make_schedule(
        num_sampling_steps=10)
    T = torch.from_numpy
    args = (T(x0), T(t), T(noise), ps)
    for lt in ("mse", "rescaled_mse"):
        got = P.training_losses_full(_toy("torch", T(w), True), *args, lt)
        want = J.training_losses_full(_toy("jax", w, True), x0, t, noise,
                                      js, lt)
        _close(got["loss"], want["loss"])
        assert not got["vb"].any()
    for lt in ("kl", "rescaled_kl"):
        with pytest.raises(ValueError, match="learned-variance"):
            J.training_losses_full(_toy("jax", w, True), x0, t, noise, js,
                                   lt)
        with pytest.raises(ValueError, match="learned-variance"):
            P.training_losses_full(_toy("torch", T(w), True), *args, lt)
    with pytest.raises(AssertionError):
        J.training_losses_full(_toy("jax", w), x0, t, noise, js, "l1")
    with pytest.raises(ValueError, match="unknown loss type"):
        P.training_losses_full(_toy("torch", T(w)), *args, "l1")
    with pytest.raises(ValueError, match="learned-variance"):
        P.vb_terms(ps, T(x0), T(x0), T(x0), T(t), 4)


def _stream():
    """12 batches of 4 (t, loss) pairs over 6 timesteps, timesteps
    repeated inside batches, filling every ring buffer of 3."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        ts = rng.integers(0, 6, size=4)
        if i % 3 == 0:
            ts[1] = ts[0]  # a repeat inside the batch
        out.append((ts, rng.random(4).astype(np.float32)))
    return out


def test_loss_second_moment_state_and_weights_match_jax():
    jr = J.LossSecondMomentResampler(6, history_per_term=3)
    pr = P.LossSecondMomentResampler(6, history_per_term=3)
    js, ps = jr.init(), pr.init()
    warmed = []
    for ts, losses in _stream():
        js = jr.update(js, ts, losses)
        ps = pr.update(ps, torch.from_numpy(ts), torch.from_numpy(losses))
        assert np.array_equal(ps.counts.numpy(), np.asarray(js.counts))
        assert np.array_equal(ps.history.numpy(), np.asarray(js.history))
        _close(pr.weights(ps), jr.weights(js))
        warmed.append(bool((ps.counts == 3).all()))
    assert warmed[0] is False and warmed[-1] is True
    assert not np.allclose(pr.weights(ps).numpy(), 1 / 6)  # not uniform


def test_loss_second_moment_draws_follow_the_weights():
    """40000 draws of a warmed state: each timestep's frequency within 5
    standard deviations of its weight, and the importance weights
    unbiased (E[w] = 1 within 2%)."""
    pr = P.LossSecondMomentResampler(6, history_per_term=3)
    ps = pr.init()
    for ts, losses in _stream():
        ps = pr.update(ps, torch.from_numpy(ts), torch.from_numpy(losses))
    p = pr.weights(ps).double().numpy()
    n = 40000
    t, w = pr.sample(ps, torch.Generator().manual_seed(0), n)
    freq = np.bincount(t.numpy(), minlength=6) / n
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n))
    assert abs(float(w.double().mean()) - 1) < 0.02
    np.testing.assert_allclose(w.numpy(), 1 / (6 * p[t.numpy()]), rtol=1e-6)


def test_uniform_sampler_and_names():
    s = P.create_named_schedule_sampler("uniform", 10)
    t, w = s.sample(torch.Generator().manual_seed(0), 1000)
    assert t.min() >= 0 and t.max() == 9 and bool((w == 1).all())
    assert isinstance(P.create_named_schedule_sampler(
        "loss-second-moment", 10), P.LossSecondMomentResampler)
    for lib in (J, P):
        with pytest.raises(NotImplementedError, match="unknown"):
            lib.create_named_schedule_sampler("lossy", 10)
