"""Likelihood terms and loss-aware timestep samplers for diffusion training
(port of `viditq_tpu/samplers/diffusion_losses.py`).

The reference's `diffusion_utils.py` (normal_kl, the discretized and
continuous Gaussian log-likelihoods) and `timestep_sampler.py`
(UniformSampler, LossSecondMomentResampler), and the vb branch of its
`training_losses` (loss types mse / rescaled_mse / kl / rescaled_kl with
a LEARNED_RANGE variance head). Everything computes in float32, as the
JAX module does.

The loss-second-moment sampler keeps the JAX module's explicit state
(`LossSamplerState`: a [T, H] loss history and [T] fill counts) and pure
`update`/`weights`; `update` pushes the (t, loss) pairs in batch order on
the device, so a batch that repeats a timestep fills its ring buffer as
the reference's host loop does. Draws come from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from viditq_tpu_torch.samplers.gaussian_diffusion import (
    Schedule, _split_eps, model_timesteps, noised)

LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


# ---------------------------------------------------------------------------
# likelihoods (diffusion_utils.py:18-87)
# ---------------------------------------------------------------------------

def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL between two Gaussians, broadcasting (diffusion_utils.py:18-35)."""
    logvar1 = torch.as_tensor(logvar1, dtype=torch.float32)
    logvar2 = torch.as_tensor(logvar2, dtype=torch.float32)
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    """diffusion_utils.py:38-43."""
    return 0.5 * (1.0 + torch.tanh(float(np.sqrt(2.0 / np.pi))
                                   * (x + 0.044715 * x ** 3)))


def continuous_gaussian_log_likelihood(x, *, means, log_scales):
    """log N(x; means, exp(log_scales)^2) (diffusion_utils.py:46-58)."""
    z = (x - means) * torch.exp(-log_scales)
    return -0.5 * (z ** 2 + float(np.log(2 * np.pi)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales):
    """Log-likelihood of a Gaussian discretized to uint8 bins scaled to
    [-1, 1] (diffusion_utils.py:61-87)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus, log_delta))


# ---------------------------------------------------------------------------
# variational-bound terms (q_posterior / p_mean_variance / _vb_terms_bpd
# with the LEARNED_RANGE variance)
# ---------------------------------------------------------------------------

def _bcast(arr, t, ndim: int) -> torch.Tensor:
    """arr[t] (numpy, cast to float32) as [B, 1, ...] of ndim dims."""
    return torch.as_tensor(arr, dtype=torch.float32, device=t.device)[
        t].reshape((-1,) + (1,) * (ndim - 1))


def q_posterior_mean_logvar(schedule: Schedule, x_start, x_t, t):
    mean = (_bcast(schedule.posterior_mean_coef1, t, x_t.dim()) * x_start
            + _bcast(schedule.posterior_mean_coef2, t, x_t.dim()) * x_t)
    logvar = _bcast(schedule.posterior_log_variance_clipped, t, x_t.dim())
    return mean, logvar


def p_mean_logvar_learned_range(schedule: Schedule, eps, var_raw, x_t, t,
                                clip_denoised: bool = False):
    """The model's p(x_{t-1} | x_t) mean and log variance under
    eps-prediction with the LEARNED_RANGE variance (p_mean_variance)."""
    nd = x_t.dim()
    min_log = _bcast(schedule.posterior_log_variance_clipped, t, nd)
    max_log = _bcast(np.log(schedule.betas), t, nd)
    frac = (var_raw.float() + 1.0) / 2.0
    model_logvar = frac * max_log + (1 - frac) * min_log
    x0 = (_bcast(schedule.sqrt_recip_alphas_cumprod, t, nd) * x_t
          - _bcast(schedule.sqrt_recipm1_alphas_cumprod, t, nd) * eps)
    if clip_denoised:
        x0 = torch.clamp(x0, -1.0, 1.0)
    mean, _ = q_posterior_mean_logvar(schedule, x0, x_t, t)
    return mean, model_logvar


def _per_sample_mean(v: torch.Tensor) -> torch.Tensor:
    return torch.mean(v.reshape(v.shape[0], -1), dim=-1)


def vb_terms(schedule: Schedule, model_out, x_start, x_t, t,
             in_channels: int = 4, stop_mean_grad: bool = True):
    """Per-sample variational-bound term in bits (the reference's
    _vb_terms_bpd); stop_mean_grad detaches eps, so the term trains only
    the variance head (training_losses' frozen mean)."""
    eps, var_raw = _split_eps(model_out, in_channels)
    if var_raw.shape[1] == 0:
        raise ValueError("vb term needs a learned-variance model output "
                         "(2*in_channels output channels)")
    if stop_mean_grad:
        eps = eps.detach()
    true_mean, true_logvar = q_posterior_mean_logvar(schedule, x_start,
                                                     x_t, t)
    mean, logvar = p_mean_logvar_learned_range(schedule, eps, var_raw,
                                               x_t, t)
    kl = _per_sample_mean(normal_kl(true_mean, true_logvar, mean, logvar)
                          ) / float(np.log(2.0))
    nll = _per_sample_mean(-discretized_gaussian_log_likelihood(
        x_start, means=mean, log_scales=0.5 * logvar)) / float(np.log(2.0))
    return torch.where(t == 0, nll, kl)


def training_losses_full(model_fn, x_start, t, noise, schedule: Schedule,
                         loss_type: str = "mse", in_channels: int = 4):
    """Per-sample training losses of every loss type (the reference's
    training_losses): {'loss': [B], 'mse': [B], 'vb': [B]}. t indexes the
    spaced steps; model_fn(x_t, t_orig) receives the original-scale
    timesteps. The kl types need the learned variance; an eps-only model
    gets the mse alone (its vb is zeros)."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss type {loss_type!r}; one of "
                         f"{LOSS_TYPES}")
    x_t = noised(schedule, x_start, t, noise)
    model_out = model_fn(x_t, model_timesteps(schedule, t))
    eps, var_raw = _split_eps(model_out, in_channels)
    has_var = var_raw.shape[1] > 0
    zeros = torch.zeros((x_start.shape[0],), dtype=torch.float32,
                        device=x_start.device)

    if loss_type in ("kl", "rescaled_kl"):
        if not has_var:
            raise ValueError(
                "kl/rescaled_kl losses need a learned-variance model "
                "(model output channels == 2*in_channels); this model "
                "predicts eps only")
        vb = vb_terms(schedule, model_out, x_start, x_t, t, in_channels,
                      stop_mean_grad=False)
        if loss_type == "rescaled_kl":
            vb = vb * schedule.n_steps
        return {"loss": vb, "mse": zeros, "vb": vb}

    mse = _per_sample_mean((eps.float() - noise) ** 2)
    vb = zeros
    if has_var:
        vb = vb_terms(schedule, model_out, x_start, x_t, t, in_channels)
        if loss_type == "rescaled_mse":
            # the vb term keeps its weight against the rescaled mse
            vb = vb * schedule.n_steps / 1000.0
    return {"loss": mse + vb, "mse": mse, "vb": vb}


# ---------------------------------------------------------------------------
# timestep samplers (timestep_sampler.py)
# ---------------------------------------------------------------------------

class UniformSampler:
    """timestep_sampler.py:69-76: t uniform over the schedule's steps,
    weights 1."""

    def __init__(self, n_steps: int):
        self.n_steps = n_steps

    def sample(self, generator: torch.Generator, batch_size: int):
        """-> (t [B] int64, weights [B] float32) on the generator's
        device."""
        t = torch.randint(0, self.n_steps, (batch_size,),
                          generator=generator, device=generator.device)
        return t, torch.ones((batch_size,), dtype=torch.float32,
                             device=generator.device)


@dataclasses.dataclass
class LossSamplerState:
    """LossSecondMomentResampler's ring buffers (timestep_sampler.py:
    122-151)."""

    history: torch.Tensor  # [T, H] float32: each timestep's last losses
    counts: torch.Tensor   # [T] int32: their fill counts


@dataclasses.dataclass(frozen=True)
class LossSecondMomentResampler:
    """Importance-samples timesteps by the second moment of their recent
    losses, unbiased by 1 / (T p) weights; uniform until every timestep
    holds history_per_term losses (timestep_sampler.py:79-151)."""

    n_steps: int
    history_per_term: int = 10
    uniform_prob: float = 0.001

    def init(self, device=None) -> LossSamplerState:
        return LossSamplerState(
            history=torch.zeros((self.n_steps, self.history_per_term),
                                dtype=torch.float32, device=device),
            counts=torch.zeros((self.n_steps,), dtype=torch.int32,
                               device=device))

    def weights(self, state: LossSamplerState) -> torch.Tensor:
        """The sampling probabilities [T] (timestep_sampler.py:122-130)."""
        warmed = torch.all(state.counts == self.history_per_term)
        w = torch.sqrt(torch.mean(state.history ** 2, dim=-1))
        w = w / torch.clamp(torch.sum(w), min=1e-12)
        w = w * (1 - self.uniform_prob) + self.uniform_prob / self.n_steps
        return torch.where(warmed, w, torch.full_like(w, 1.0 / self.n_steps))

    def sample(self, state: LossSamplerState, generator: torch.Generator,
               batch_size: int):
        """-> (t [B] int64, weights [B] float32) (timestep_sampler.py:
        51-67): t drawn from `weights` with replacement."""
        p = self.weights(state)
        p = p / torch.sum(p)
        t = torch.multinomial(p.to(generator.device), batch_size,
                              replacement=True, generator=generator)
        t = t.to(p.device)
        return t, 1.0 / (self.n_steps * p[t])

    def update(self, state: LossSamplerState, ts, losses
               ) -> LossSamplerState:
        """Push each (t, loss) into t's ring buffer in batch order
        (timestep_sampler.py:139-148: shift left when full, else append),
        on the device: a repeated timestep takes its losses one by one.
        Returns a new state."""
        H = self.history_per_term
        hist, counts = state.history.clone(), state.counts.clone()
        ts = torch.as_tensor(ts, device=hist.device).long()
        losses = torch.as_tensor(losses, device=hist.device).float()
        for i in range(ts.shape[0]):
            t, loss = ts[i], losses[i]
            h, cnt = hist[t], counts[t]
            full = cnt >= H
            shifted = torch.cat([h[1:], loss.reshape(1)])
            appended = h.clone()
            appended[torch.clamp(cnt, max=H - 1).long()] = loss
            hist[t] = torch.where(full, shifted, appended)
            counts[t] = torch.where(full, cnt, cnt + 1)
        return LossSamplerState(history=hist, counts=counts)


def create_named_schedule_sampler(name: str, n_steps: int):
    """timestep_sampler.py:20-31."""
    if name == "uniform":
        return UniformSampler(n_steps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(n_steps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
