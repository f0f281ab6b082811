"""Multistep DPM-Solver(++) with classifier-free guidance: port of
`viditq_tpu/samplers/dpm_solver.py` (the t2i sampler of PixArt).

Every multistep update is linear in the buffered model values once the
timestep grid is fixed, so the per-step coefficients are a tableau
computed host-side in numpy float64 (`multistep_coeffs`, the JAX package's
own probing of the reference update equations); the JAX `lax.scan` becomes
a Python loop over the tableau. Ported: the discrete VP schedule, skip
types time_uniform / logSNR / time_quadratic, multistep orders 1-3 with
warm-up and `lower_order_final`, algorithm types dpmsolver / dpmsolver++,
noise-prediction models, CFG with `cfg_split`, the full time range
(t_T = 1 to t_0 = 1/N), the calibration-trajectory capture. Singlestep
methods, dynamic thresholding, `denoise_to_zero` and other model types
raise NotImplementedError; the continuous schedule and custom betas or
time ranges are not ported.

Numerics: the solver state is combined in float32 and cast back to the
latent's dtype after each update, as in the JAX package; the tableau is
applied in float32. The JAX package evaluates alpha/sigma of steps after
the first in float32 from the scanned model time; the port takes them in
float64 from the same grid (a difference of about 1e-7 relative).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from viditq_tpu_torch.samplers.gaussian_diffusion import (
    get_named_beta_schedule)


class NoiseScheduleVP:
    """Discrete VP schedule (dpm_solver.py:40-170): piecewise-linear
    log_alpha over t in (0, 1] from the linear betas, with the numerical
    logSNR clip near t = T. Host-side numpy float64 only."""

    def __init__(self, diffusion_steps: int = 1000):
        betas = get_named_beta_schedule("linear", diffusion_steps)
        log_alphas = 0.5 * np.log1p(-np.asarray(betas, np.float64)).cumsum()
        log_alphas = self._numerical_clip_alpha(log_alphas)
        self.T = 1.0
        self.total_N = len(log_alphas)
        self.t_array = (np.arange(self.total_N) + 1.0) / self.total_N
        self.log_alpha_array = log_alphas

    @staticmethod
    def _numerical_clip_alpha(log_alphas: np.ndarray,
                              clipped_lambda: float = -5.1) -> np.ndarray:
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(lambs[::-1], clipped_lambda))
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        return log_alphas

    def _log_mean_coeff_np(self, t):
        return np.interp(np.asarray(t, np.float64), self.t_array,
                         self.log_alpha_array)

    def _alpha_np(self, t):
        return np.exp(self._log_mean_coeff_np(t))

    def _std_np(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self._log_mean_coeff_np(t)))

    def _lambda_np(self, t):
        la = self._log_mean_coeff_np(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    def _inverse_lambda_np(self, lamb):
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * np.asarray(lamb,
                                                               np.float64))
        return np.interp(log_alpha, self.log_alpha_array[::-1],
                         self.t_array[::-1])


def model_input_timestep(t_cont, total_n: int = 1000):
    """Continuous t in (0, 1] -> the model's time input, scaled by 1000
    regardless of total_N (dpm_solver.py:142-146)."""
    return (t_cont - 1.0 / total_n) * 1000.0


def get_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                   t_0: float, N: int) -> np.ndarray:
    """Timestep grid [N+1] (dpm_solver.py:149-160)."""
    if skip_type == "logSNR":
        lam_T = ns._lambda_np(t_T)
        lam_0 = ns._lambda_np(t_0)
        return ns._inverse_lambda_np(np.linspace(lam_T, lam_0, N + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(f"unsupported skip_type {skip_type!r}")


def _ms_update_scalar(ns, t_prev_list, t, order, m, algorithm_type,
                      solver_type):
    """The m-part of one multistep update with scalar model values
    m = (m0, m1, m2), m0 the most recent (dpm_solver.py:210-259)."""
    m0, m1, m2 = m
    t0 = t_prev_list[-1]
    lam_t = ns._lambda_np(t)
    lam_0 = ns._lambda_np(t0)
    h = lam_t - lam_0
    sigma_t = ns._std_np(t)
    alpha_t = ns._alpha_np(t)
    if order >= 2:
        t1 = t_prev_list[-2]
        h_0 = lam_0 - ns._lambda_np(t1)
        r0 = h_0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
    if order >= 3:
        t2 = t_prev_list[-3]
        h_1 = ns._lambda_np(t1) - ns._lambda_np(t2)
        r1 = h_1 / h
        d1_1 = (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
    if algorithm_type == "dpmsolver++":
        phi_1 = np.expm1(-h)
        if order == 1:
            return -alpha_t * phi_1 * m0
        if order == 2:
            if solver_type == "dpmsolver":
                return -alpha_t * phi_1 * m0 \
                    - 0.5 * alpha_t * phi_1 * d1_0
            return -alpha_t * phi_1 * m0 \
                + alpha_t * (phi_1 / h + 1.0) * d1_0
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        return (-alpha_t * phi_1 * m0 + alpha_t * phi_2 * d1
                - alpha_t * phi_3 * d2)
    phi_1 = np.expm1(h)
    if order == 1:
        return -sigma_t * phi_1 * m0
    if order == 2:
        if solver_type == "dpmsolver":
            return -sigma_t * phi_1 * m0 - 0.5 * sigma_t * phi_1 * d1_0
        return -sigma_t * phi_1 * m0 - sigma_t * (phi_1 / h - 1.0) * d1_0
    phi_2 = phi_1 / h - 1.0
    phi_3 = phi_2 / h - 0.5
    return (-sigma_t * phi_1 * m0 - sigma_t * phi_2 * d1
            - sigma_t * phi_3 * d2)


def _ms_cx(ns, t_prev0, t, algorithm_type):
    if algorithm_type == "dpmsolver++":
        return ns._std_np(t) / ns._std_np(t_prev0)
    return np.exp(ns._log_mean_coeff_np(t) - ns._log_mean_coeff_np(t_prev0))


def multistep_coeffs(ns, t_prev_list, t, order, algorithm_type,
                     solver_type):
    """(cx, a0, a1, a2) of one multistep update: x_t = cx * x + sum a_i m_i
    (dpm_solver.py:278-285, the linear coefficients probed at unit m)."""
    cx = float(_ms_cx(ns, t_prev_list[-1], t, algorithm_type))
    a = []
    for i in range(3):
        m = [0.0, 0.0, 0.0]
        m[i] = 1.0
        a.append(float(_ms_update_scalar(ns, t_prev_list, t, order, tuple(m),
                                         algorithm_type, solver_type)))
    return cx, a[0], a[1], a[2]


def multistep_tableau(ns, steps: int, t_T: float, t_0: float, order: int,
                      skip_type: str, lower_order_final: bool,
                      algorithm_type: str, solver_type: str):
    """(grid ts [steps+1], tableau [steps, 4]) of the multistep sampler:
    warm-up orders 1..order-1, then `order`, with the lower-order tail
    (dpm_solver.py:510-534)."""
    ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
    tab = np.zeros((steps, 4), np.float64)
    for i in range(steps):
        step = i + 1
        o = min(order, step)
        if lower_order_final:
            o = min(o, steps + 1 - step)
        t_prev = [ts[max(step - 1 - j, 0)] for j in range(2, -1, -1)]
        tab[i] = multistep_coeffs(ns, t_prev, ts[step], o, algorithm_type,
                                  solver_type)
    return ts, tab


def _true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c rounded once (PyTorch may multiply by 1/c for a scalar c)."""
    return t / torch.full_like(t, c)


class DPMSolver:
    """Tableau-driven multistep DPM-Solver (dpm_solver.py:430-575).
    noise_model_fn(x, t_model [B] float32, eval_idx) -> eps prediction."""

    def __init__(self, noise_model_fn: Callable, ns: NoiseScheduleVP,
                 algorithm_type: str = "dpmsolver++",
                 solver_type: str = "dpmsolver"):
        if algorithm_type not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(algorithm_type)
        if solver_type not in ("dpmsolver", "taylor"):
            raise ValueError(solver_type)
        self.noise_model_fn = noise_model_fn
        self.ns = ns
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type

    def _model_value(self, x, t_cont: float, eval_idx: int):
        """eps for dpmsolver, x0 = (x - sigma eps) / alpha for ++."""
        t_model = torch.full(
            (x.shape[0],), float(np.float32(model_input_timestep(
                t_cont, self.ns.total_N))), device=x.device)
        eps = self.noise_model_fn(x, t_model, eval_idx).float()
        if self.algorithm_type == "dpmsolver":
            return eps
        alpha = float(self.ns._alpha_np(t_cont))
        sigma = float(self.ns._std_np(t_cont))
        return _true_div(x.float() - sigma * eps, alpha)

    @torch.no_grad()
    def sample(self, x: torch.Tensor, steps: int = 20, order: int = 2,
               skip_type: str = "time_uniform", method: str = "multistep",
               lower_order_final: bool = True,
               denoise_to_zero: bool = False,
               capture_trajectory: bool = False):
        """The multistep solver; with capture_trajectory also {'xs': the
        input of each model evaluation [steps, B, ...], 'ts': its model
        timestep [steps, B] float32} (dpm_solver.py:506-574)."""
        if method != "multistep":
            raise NotImplementedError(f"method {method!r} is not ported")
        if denoise_to_zero:
            raise NotImplementedError("denoise_to_zero is not ported")
        t_0, t_T = 1.0 / self.ns.total_N, self.ns.T
        if steps < order:
            raise ValueError(f"steps {steps} < order {order}")
        ts, tab = multistep_tableau(self.ns, steps, t_T, t_0, order,
                                    skip_type, lower_order_final,
                                    self.algorithm_type, self.solver_type)
        coeffs = [[float(c) for c in row] for row in tab.astype(np.float32)]
        xs, tms = [], []

        def value(x, t_cont, idx):
            if capture_trajectory:
                xs.append(x)
                tms.append(torch.full((x.shape[0],), float(np.float32(
                    model_input_timestep(t_cont, self.ns.total_N))),
                    device=x.device))
            return self._model_value(x, t_cont, idx)
        m = value(x, float(ts[0]), 0)
        b0 = b1 = b2 = m  # stale slots have zero coefficients
        for i in range(steps):
            c = coeffs[i]
            x = (c[0] * x.float() + c[1] * b0 + c[2] * b1 + c[3] * b2
                 ).to(x.dtype)
            if i < steps - 1:  # no model eval after the final update
                b0, b1, b2 = value(x, float(ts[i + 1]), i + 1), b0, b1
        if capture_trajectory:
            return x, {"xs": torch.stack(xs), "ts": torch.stack(tms)}
        return x


class DPMSolverSampler:
    """Scheduler-registry wrapper (dpm_solver.py:687-774): CFG over
    [cond; null] text embeds, eps taken from the first `in_channels`
    output channels."""

    def __init__(self, num_sampling_steps: int = 20, cfg_scale: float = 4.0,
                 in_channels: int = 4, cfg_split: bool = False,
                 order: int = 2, method: str = "multistep",
                 skip_type: str = "time_uniform",
                 algorithm_type: str = "dpmsolver++",
                 solver_type: str = "dpmsolver",
                 lower_order_final="auto", thresholding: bool = False,
                 denoise_to_zero: bool = False, model_type: str = "noise"):
        if method != "multistep":
            raise NotImplementedError(f"method {method!r} is not ported")
        if thresholding:
            raise NotImplementedError("dynamic thresholding is not ported")
        if denoise_to_zero:
            raise NotImplementedError("denoise_to_zero is not ported")
        if model_type != "noise":
            raise NotImplementedError(f"model_type {model_type!r}")
        self.steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.in_channels = in_channels
        self.cfg_split = cfg_split
        self.order = order
        self.skip_type = skip_type
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type
        # the t2v rule: lower-order final steps only below 10 steps
        if lower_order_final == "auto":
            lower_order_final = num_sampling_steps < 10
        self.lower_order_final = lower_order_final
        self.ns = NoiseScheduleVP()

    def sample(self, model_apply, z, y, mask=None, qctx_factory=None,
               return_trajectory: bool = False):
        """z: [n, C, ...]; y: [2n, 1, L, C_cap] = [cond; null]. Returns
        the final latent [n, C, ...] in z's dtype, and with
        return_trajectory the solver's {xs, ts} (not CFG-doubled)."""
        c = self.in_channels
        s = self.cfg_scale

        def noise_model_fn(x, t_model, step_idx):
            t_id = min(max(int(t_model[0].item()), 0), 999)
            qctx = (qctx_factory(t_id, step_idx)
                    if qctx_factory is not None else None)
            if self.cfg_split:
                y_cond, y_null = torch.chunk(y, 2, dim=0)
                out_c = model_apply(x, t_model, y_cond, mask, qctx)
                out_u = model_apply(x, t_model, y_null, mask, qctx)
            else:
                out = model_apply(torch.cat([x, x]),
                                  torch.cat([t_model, t_model]), y, mask,
                                  qctx)
                out_c, out_u = torch.chunk(out, 2, dim=0)
            eps_c, eps_u = out_c[:, :c], out_u[:, :c]
            return eps_u + s * (eps_c - eps_u)

        solver = DPMSolver(noise_model_fn, self.ns, self.algorithm_type,
                           self.solver_type)
        return solver.sample(z, steps=self.steps, order=self.order,
                             skip_type=self.skip_type,
                             lower_order_final=self.lower_order_final,
                             capture_trajectory=return_trajectory)
