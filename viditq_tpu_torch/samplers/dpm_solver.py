"""The DPM-Solver family with classifier-free guidance: port of
`viditq_tpu/samplers/dpm_solver.py` (the t2i sampler of PixArt).

Every update is linear in the buffered model values once the timestep
grid is fixed, so the per-step coefficients are a tableau computed
host-side in numpy float64 (the JAX package's own probing of the
reference update equations); the JAX `lax.scan`s become Python loops over
the tableau. Ported whole: the discrete VP schedule (linear betas, given
betas or alphas_cumprod) and the continuous 'linear' VPSDE, skip types
time_uniform / logSNR / time_quadratic, multistep orders 1-3 with warm-up
and `lower_order_final`, singlestep ("DPM-Solver-fast") and
singlestep_fixed with orders 1-3, algorithm types dpmsolver / dpmsolver++,
solver types dpmsolver / taylor, dynamic thresholding, `denoise_to_zero`,
model types noise / x_start / v / score, CFG with `cfg_split`, and the
calibration-trajectory capture.

Numerics: the solver state is combined in float32 and cast back to the
latent's dtype after each update, as in the JAX package; the tableau is
applied in float32. The JAX package evaluates alpha/sigma of the scanned
model evaluations in float32 from the model time; the port takes them in
float64 from the same grid (a difference of about 1e-7 relative).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from viditq_tpu_torch.kernels._common import divc
from viditq_tpu_torch.samplers.gaussian_diffusion import (
    get_named_beta_schedule, trajectory)


class NoiseScheduleVP:
    """VP forward-SDE schedule (dpm_solver.py:40-150), host-side numpy
    float64. 'discrete': piecewise-linear log_alpha over t in (0, 1], from
    betas (the linear ones by default) or alphas_cumprod, with the
    numerical logSNR clip near t = T; 'linear': the continuous VPSDE."""

    def __init__(self, betas: Optional[np.ndarray] = None,
                 diffusion_steps: int = 1000, schedule: str = "discrete",
                 alphas_cumprod: Optional[np.ndarray] = None,
                 continuous_beta_0: float = 0.1,
                 continuous_beta_1: float = 20.0):
        if schedule not in ("discrete", "linear"):
            raise ValueError(f"unsupported schedule {schedule!r}")
        self.schedule = schedule
        self.T = 1.0
        if schedule == "discrete":
            if alphas_cumprod is not None:
                log_alphas = 0.5 * np.log(
                    np.asarray(alphas_cumprod, np.float64))
            else:
                if betas is None:
                    betas = get_named_beta_schedule("linear", diffusion_steps)
                log_alphas = 0.5 * np.log1p(
                    -np.asarray(betas, np.float64)).cumsum()
            log_alphas = self._numerical_clip_alpha(log_alphas)
            self.total_N = len(log_alphas)
            self.t_array = (np.arange(self.total_N) + 1.0) / self.total_N
            self.log_alpha_array = log_alphas
        else:
            self.total_N = 1000
            self.beta_0 = float(continuous_beta_0)
            self.beta_1 = float(continuous_beta_1)

    @staticmethod
    def _numerical_clip_alpha(log_alphas: np.ndarray,
                              clipped_lambda: float = -5.1) -> np.ndarray:
        log_sigmas = 0.5 * np.log(1.0 - np.exp(2.0 * log_alphas))
        lambs = log_alphas - log_sigmas
        idx = int(np.searchsorted(lambs[::-1], clipped_lambda))
        if idx > 0:
            log_alphas = log_alphas[:-idx]
        return log_alphas

    def marginal_log_mean_coeff(self, t):
        t = np.asarray(t, np.float64)
        if self.schedule == "discrete":
            return np.interp(t, self.t_array, self.log_alpha_array)
        return -0.25 * t ** 2 * (self.beta_1 - self.beta_0) \
            - 0.5 * t * self.beta_0

    def marginal_alpha(self, t):
        return np.exp(self.marginal_log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.marginal_log_mean_coeff(t)))

    def marginal_lambda(self, t):
        la = self.marginal_log_mean_coeff(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    def inverse_lambda(self, lamb):
        lamb = np.asarray(lamb, np.float64)
        if self.schedule == "linear":
            tmp = 2.0 * (self.beta_1 - self.beta_0) * np.logaddexp(
                -2.0 * lamb, 0.0)
            delta = self.beta_0 ** 2 + tmp
            return tmp / (np.sqrt(delta) + self.beta_0) \
                / (self.beta_1 - self.beta_0)
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lamb)
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
        lam_T = ns.marginal_lambda(t_T)
        lam_0 = ns.marginal_lambda(t_0)
        return ns.inverse_lambda(np.linspace(lam_T, lam_0, N + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(f"unsupported skip_type {skip_type!r}")


def get_orders_and_timesteps_for_singlestep(
        ns: NoiseScheduleVP, steps: int, order: int, skip_type: str,
        t_T: float, t_0: float):
    """"DPM-Solver-fast" order schedule (dpm_solver.py:174-207): the
    outer grid [K+1] and each group's order, summing to steps."""
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            orders = [3] * (K - 2) + [2, 1]
        elif steps % 3 == 1:
            orders = [3] * (K - 1) + [1]
        else:
            orders = [3] * (K - 1) + [2]
    elif order == 2:
        K = steps // 2 if steps % 2 == 0 else steps // 2 + 1
        orders = [2] * K if steps % 2 == 0 else [2] * (K - 1) + [1]
    elif order == 1:
        K = 1
        orders = [1] * steps
    else:
        raise ValueError("order must be 1, 2 or 3")
    if skip_type == "logSNR":
        timesteps_outer = get_time_steps(ns, skip_type, t_T, t_0, K)
    else:
        grid = get_time_steps(ns, skip_type, t_T, t_0, steps)
        timesteps_outer = grid[np.cumsum([0] + orders)]
    return timesteps_outer, orders


def _ms_update_scalar(ns, t_prev_list, t, order, m, algorithm_type,
                      solver_type):
    """The m-part of one multistep update with scalar model values
    m = (m0, m1, m2), m0 the most recent (dpm_solver.py:210-259)."""
    m0, m1, m2 = m
    t0 = t_prev_list[-1]
    lam_t = ns.marginal_lambda(t)
    lam_0 = ns.marginal_lambda(t0)
    h = lam_t - lam_0
    sigma_t = ns.marginal_std(t)
    alpha_t = ns.marginal_alpha(t)
    if order >= 2:
        t1 = t_prev_list[-2]
        h_0 = lam_0 - ns.marginal_lambda(t1)
        r0 = h_0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
    if order >= 3:
        t2 = t_prev_list[-3]
        h_1 = ns.marginal_lambda(t1) - ns.marginal_lambda(t2)
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
        return ns.marginal_std(t) / ns.marginal_std(t_prev0)
    return np.exp(ns.marginal_log_mean_coeff(t)
                  - ns.marginal_log_mean_coeff(t_prev0))


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


@dataclasses.dataclass
class SinglestepCoeffs:
    """Coefficients of one singlestep group of order k
    (dpm_solver.py:287-300). Level j computes x_j = cx[j] * x +
    sum_i b[j][i] * m_i, m_j being the model value at eval_t[j]; the last
    level is the group's output."""

    order: int
    eval_t: Sequence[float]
    cx: Sequence[float]
    b: Sequence[Sequence[float]]


def _taylor3(r1, r2):
    """Order 3 taylor's D1 and D2 as rows over (m0, m1, m2), from
    D1_0 = (m1 - m0) / r1 and D1_1 = (m2 - m0) / r2
    (dpm_solver.py:377-384)."""
    c10, c11 = 1.0 / r1, 1.0 / r2
    d1 = ((r2 * (-c10) - r1 * (-c11)) / (r2 - r1), (r2 * c10) / (r2 - r1),
          (-r1 * c11) / (r2 - r1))
    d2 = (2.0 * ((-c11) - (-c10)) / (r2 - r1), 2.0 * (-c10) / (r2 - r1),
          2.0 * c11 / (r2 - r1))
    return d1, d2


def singlestep_coeffs(ns, s: float, t: float, order: int, algorithm_type,
                      solver_type, skip_type: str) -> SinglestepCoeffs:
    """The singlestep update equations at (s -> t), probed
    (dpm_solver.py:303-427): r1/r2 from the inner spacing of
    get_time_steps over [s, t]."""
    ts_inner = get_time_steps(ns, skip_type, s, t, order)
    lam_inner = ns.marginal_lambda(ts_inner)
    h = lam_inner[-1] - lam_inner[0]
    lam_s = ns.marginal_lambda(s)
    lam_t = ns.marginal_lambda(t)
    H = lam_t - lam_s
    A, S, la = ns.marginal_alpha, ns.marginal_std, ns.marginal_log_mean_coeff
    pp = algorithm_type == "dpmsolver++"

    if order == 1:
        cx = _ms_cx(ns, s, t, algorithm_type)
        a0 = -A(t) * np.expm1(-H) if pp else -S(t) * np.expm1(H)
        return SinglestepCoeffs(order=1, eval_t=[s], cx=[float(cx)],
                                b=[[float(a0), 0.0, 0.0]])

    r1 = float((lam_inner[1] - lam_inner[0]) / h)
    s1 = float(ns.inverse_lambda(lam_s + r1 * H))
    if order == 2:
        if pp:
            phi_11 = np.expm1(-r1 * H)
            phi_1 = np.expm1(-H)
            cx1 = S(s1) / S(s)
            b1 = [-A(s1) * phi_11, 0.0, 0.0]
            cx2 = S(t) / S(s)
            if solver_type == "dpmsolver":
                a_s = -A(t) * phi_1 + (0.5 / r1) * A(t) * phi_1
                a_s1 = -(0.5 / r1) * A(t) * phi_1
            else:
                k = (1.0 / r1) * A(t) * (phi_1 / H + 1.0)
                a_s = -A(t) * phi_1 - k
                a_s1 = k
        else:
            phi_11 = np.expm1(r1 * H)
            phi_1 = np.expm1(H)
            cx1 = np.exp(la(s1) - la(s))
            b1 = [-S(s1) * phi_11, 0.0, 0.0]
            cx2 = np.exp(la(t) - la(s))
            if solver_type == "dpmsolver":
                a_s = -S(t) * phi_1 + (0.5 / r1) * S(t) * phi_1
                a_s1 = -(0.5 / r1) * S(t) * phi_1
            else:
                k = (1.0 / r1) * S(t) * (phi_1 / H - 1.0)
                a_s = -S(t) * phi_1 + k
                a_s1 = -k
        return SinglestepCoeffs(
            order=2, eval_t=[s, s1], cx=[float(cx1), float(cx2)],
            b=[[float(b1[0]), 0.0, 0.0], [float(a_s), float(a_s1), 0.0]])

    r2 = float((lam_inner[2] - lam_inner[0]) / h)
    s2 = float(ns.inverse_lambda(lam_s + r2 * H))
    if pp:
        phi_11 = np.expm1(-r1 * H)
        phi_12 = np.expm1(-r2 * H)
        phi_1 = np.expm1(-H)
        phi_22 = np.expm1(-r2 * H) / (r2 * H) + 1.0
        phi_2 = phi_1 / H + 1.0
        phi_3 = phi_2 / H - 0.5
        cx1 = S(s1) / S(s)
        b1 = [-A(s1) * phi_11, 0.0, 0.0]
        cx2 = S(s2) / S(s)
        k22 = (r2 / r1) * A(s2) * phi_22
        b2 = [-A(s2) * phi_12 - k22, k22, 0.0]
        cx3 = S(t) / S(s)
        if solver_type == "dpmsolver":
            k2 = (1.0 / r2) * A(t) * phi_2
            b3 = [-A(t) * phi_1 - k2, 0.0, k2]
        else:
            At = A(t)
            d1, d2 = _taylor3(r1, r2)
            b3 = [-At * phi_1 + At * phi_2 * d1[0] - At * phi_3 * d2[0],
                  At * phi_2 * d1[1] - At * phi_3 * d2[1],
                  At * phi_2 * d1[2] - At * phi_3 * d2[2]]
    else:
        phi_11 = np.expm1(r1 * H)
        phi_12 = np.expm1(r2 * H)
        phi_1 = np.expm1(H)
        phi_22 = np.expm1(r2 * H) / (r2 * H) - 1.0
        phi_2 = phi_1 / H - 1.0
        phi_3 = phi_2 / H - 0.5
        cx1 = np.exp(la(s1) - la(s))
        b1 = [-S(s1) * phi_11, 0.0, 0.0]
        cx2 = np.exp(la(s2) - la(s))
        k22 = (r2 / r1) * S(s2) * phi_22
        b2 = [-S(s2) * phi_12 + k22, -k22, 0.0]
        cx3 = np.exp(la(t) - la(s))
        if solver_type == "dpmsolver":
            k2 = (1.0 / r2) * S(t) * phi_2
            b3 = [-S(t) * phi_1 + k2, 0.0, -k2]
        else:
            St = S(t)
            d1, d2 = _taylor3(r1, r2)
            b3 = [-St * phi_1 - St * phi_2 * d1[0] - St * phi_3 * d2[0],
                  -St * phi_2 * d1[1] - St * phi_3 * d2[1],
                  -St * phi_2 * d1[2] - St * phi_3 * d2[2]]
    return SinglestepCoeffs(
        order=3, eval_t=[s, s1, s2],
        cx=[float(cx1), float(cx2), float(cx3)],
        b=[[float(v) for v in b1], [float(v) for v in b2],
           [float(v) for v in b3]])


def abs_quantile(x0: torch.Tensor, p: float) -> torch.Tensor:
    """Each row's p-quantile of |x0| over its elements, linearly
    interpolated as `jnp.quantile`'s default is; [B]. x0 is float32 here
    (float64 stays). `torch.quantile` takes at most 2**24 elements and
    raises above: the largest latent of the workloads, STDiT 16x512x512 at
    a CFG batch of 2, has 2**19; a larger one would need a sort of each
    row and the same interpolation."""
    a = x0.abs().reshape(x0.shape[0], -1)
    if a.dtype != torch.float64:
        a = a.float()
    return torch.quantile(a, p, dim=1)


def dynamic_threshold(x0: torch.Tensor, ratio: float,
                      max_val: float) -> torch.Tensor:
    """Imagen's dynamic thresholding of the solvers (dpm_solver.py:
    464-471): s = max(quantile, max_val) a row; x0 clipped to [-s, s],
    divided by s."""
    s = torch.clamp(abs_quantile(x0, ratio), min=max_val).reshape(
        (-1,) + (1,) * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


class DPMSolver:
    """Tableau-driven DPM-Solver (dpm_solver.py:430-671).
    noise_model_fn(x, t_model [B] float32, eval_idx) -> eps prediction;
    eval_idx counts the model evaluations from 0."""

    def __init__(self, noise_model_fn: Callable, ns: NoiseScheduleVP,
                 algorithm_type: str = "dpmsolver++",
                 solver_type: str = "dpmsolver",
                 correcting_x0_fn: Optional[str] = None,
                 thresholding_max_val: float = 1.0,
                 dynamic_thresholding_ratio: float = 0.995):
        if algorithm_type not in ("dpmsolver", "dpmsolver++"):
            raise ValueError(algorithm_type)
        if solver_type not in ("dpmsolver", "taylor"):
            raise ValueError(solver_type)
        self.noise_model_fn = noise_model_fn
        self.ns = ns
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type
        self.thresholding = correcting_x0_fn == "dynamic_thresholding"
        self.thresholding_max_val = thresholding_max_val
        self.dynamic_thresholding_ratio = dynamic_thresholding_ratio

    def _t_model(self, x, t_cont: float) -> torch.Tensor:
        return torch.full((x.shape[0],), float(np.float32(
            model_input_timestep(t_cont, self.ns.total_N))), device=x.device)

    def _model_value(self, x, t_cont: float, eval_idx: int):
        """eps for dpmsolver, the (thresholded) x0 = (x - sigma eps) /
        alpha for ++, in float32."""
        eps = self.noise_model_fn(x, self._t_model(x, t_cont),
                                  eval_idx).float()
        if self.algorithm_type == "dpmsolver":
            return eps
        alpha = float(self.ns.marginal_alpha(t_cont))
        sigma = float(self.ns.marginal_std(t_cont))
        x0 = divc(x.float() - sigma * eps, alpha)
        if self.thresholding:
            x0 = dynamic_threshold(x0, self.dynamic_thresholding_ratio,
                                   self.thresholding_max_val)
        return x0

    @torch.no_grad()
    def sample(self, x: torch.Tensor, steps: int = 20,
               t_start: Optional[float] = None, t_end: Optional[float] = None,
               order: int = 2, skip_type: str = "time_uniform",
               method: str = "multistep", lower_order_final: bool = True,
               denoise_to_zero: bool = False,
               capture_trajectory: bool = False):
        """From t_start (T) to t_end (1/N); with capture_trajectory also
        {'xs': the state at each update's start [n, B, ...], 'ts': its
        model timestep [n, B] float32} (dpm_solver.py:475-507).
        denoise_to_zero: one more model evaluation at t_end, its x0 the
        result."""
        t_0 = 1.0 / self.ns.total_N if t_end is None else t_end
        t_T = self.ns.T if t_start is None else t_start
        if not (t_0 > 0 and t_T > 0):
            raise ValueError(f"times must be positive: {t_T}, {t_0}")
        if method == "multistep":
            x, traj, n_evals = self._sample_multistep(
                x, steps, t_T, t_0, order, skip_type, lower_order_final,
                capture_trajectory)
        elif method in ("singlestep", "singlestep_fixed"):
            x, traj, n_evals = self._sample_singlestep(
                x, steps, t_T, t_0, order, skip_type, method,
                capture_trajectory)
        else:
            raise ValueError(f"unsupported method {method!r}")
        if denoise_to_zero:
            m = self._model_value(x, t_0, n_evals)
            if self.algorithm_type == "dpmsolver":
                alpha = float(self.ns.marginal_alpha(t_0))
                sigma = float(self.ns.marginal_std(t_0))
                m = divc(x.float() - sigma * m, alpha)
            x = m.to(x.dtype)
        if capture_trajectory:
            return x, traj
        return x

    def _sample_multistep(self, x, steps, t_T, t_0, order, skip_type,
                          lower_order_final, capture):
        if steps < order:
            raise ValueError(f"steps {steps} < order {order}")
        ts, tab = multistep_tableau(self.ns, steps, t_T, t_0, order,
                                    skip_type, lower_order_final,
                                    self.algorithm_type, self.solver_type)
        coeffs = [[float(c) for c in row] for row in tab.astype(np.float32)]
        xs, tms = [], []

        def value(x, i):
            if capture:
                xs.append(x)
                tms.append(self._t_model(x, float(ts[i])))
            return self._model_value(x, float(ts[i]), i)
        b0 = b1 = b2 = value(x, 0)  # stale slots have zero coefficients
        for i in range(steps):
            c = coeffs[i]
            x = (c[0] * x.float() + c[1] * b0 + c[2] * b1 + c[3] * b2
                 ).to(x.dtype)
            if i < steps - 1:  # no model eval after the final update
                b0, b1, b2 = value(x, i + 1), b0, b1
        return x, trajectory(xs, tms) if capture else None, steps

    def _sample_singlestep(self, x, steps, t_T, t_0, order, skip_type,
                           method, capture):
        """Groups of order k (the "fast" order schedule, or `steps //
        order` groups of `order`), each k model evaluations at its inner
        times (dpm_solver.py:597-671)."""
        ns = self.ns
        if method == "singlestep":
            ts_outer, orders = get_orders_and_timesteps_for_singlestep(
                ns, steps, order, skip_type, t_T, t_0)
        else:
            orders = [order] * (steps // order)
            ts_outer = get_time_steps(ns, skip_type, t_T, t_0, len(orders))
        xs, tms = [x], [self._t_model(x, float(ts_outer[0]))]
        eval_idx = 0
        for gi, o in enumerate(orders):
            g = singlestep_coeffs(ns, float(ts_outer[gi]),
                                  float(ts_outer[gi + 1]), o,
                                  self.algorithm_type, self.solver_type,
                                  skip_type)
            cx = [float(np.float32(c)) for c in g.cx]
            b = [[float(np.float32(c)) for c in row] for row in g.b]
            ms, xi = [], x
            for lvl in range(g.order):
                ms.append(self._model_value(xi, g.eval_t[lvl], eval_idx))
                eval_idx += 1
                acc = cx[lvl] * x.float()
                for q, mq in enumerate(ms):
                    acc = acc + b[lvl][q] * mq
                xi = acc.to(x.dtype)
            x = xi
            if capture:
                xs.append(x)
                tms.append(self._t_model(x, float(ts_outer[gi + 1])))
        # the states at each group's start: the last (the output) dropped
        # (t2i get_calib_data.py:167-169)
        return (x, trajectory(xs[:-1], tms[:-1]) if capture else None,
                eval_idx)


def dpm_solver_pp_2m(noise_model_fn: Callable, z: torch.Tensor,
                     steps: int = 20, t_start: float = 1.0,
                     t_end: Optional[float] = None,
                     schedule: Optional[NoiseScheduleVP] = None,
                     capture_trajectory: bool = False):
    """Multistep DPM-Solver++ of order 2 on the time-uniform grid
    (dpm_solver.py:673-685)."""
    solver = DPMSolver(noise_model_fn, schedule or NoiseScheduleVP(),
                       algorithm_type="dpmsolver++")
    return solver.sample(z, steps=steps, t_start=t_start, t_end=t_end,
                         order=2, skip_type="time_uniform",
                         method="multistep", lower_order_final=True,
                         capture_trajectory=capture_trajectory)


MODEL_TYPES = ("noise", "x_start", "v", "score")


class DPMSolverSampler:
    """Scheduler-registry wrapper (dpm_solver.py:687-774): CFG over
    [cond; null] text embeds, the model's output taken from its first
    `in_channels` channels and turned into eps by `model_type`."""

    def __init__(self, num_sampling_steps: int = 20, cfg_scale: float = 4.0,
                 in_channels: int = 4, cfg_split: bool = False,
                 order: int = 2, method: str = "multistep",
                 skip_type: str = "time_uniform",
                 algorithm_type: str = "dpmsolver++",
                 solver_type: str = "dpmsolver",
                 lower_order_final="auto", thresholding: bool = False,
                 denoise_to_zero: bool = False, model_type: str = "noise"):
        if method not in ("multistep", "singlestep", "singlestep_fixed"):
            raise ValueError(f"unsupported method {method!r}")
        if model_type not in MODEL_TYPES:
            raise ValueError(f"unsupported model_type {model_type!r}")
        self.steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.in_channels = in_channels
        self.cfg_split = cfg_split
        self.order = order
        self.method = method
        self.skip_type = skip_type
        self.algorithm_type = algorithm_type
        self.solver_type = solver_type
        # the t2v rule: lower-order final steps only below 10 steps
        if lower_order_final == "auto":
            lower_order_final = num_sampling_steps < 10
        self.lower_order_final = lower_order_final
        self.thresholding = thresholding
        self.denoise_to_zero = denoise_to_zero
        self.model_type = model_type
        self.ns = NoiseScheduleVP()

    def _eps_from_output(self, out, x, t_model):
        """model_type conversions (dpm_solver.py:725-740), alpha and sigma
        at the model time's continuous t."""
        if self.model_type == "noise":
            return out
        t_cont = float(t_model[0]) / 1000.0 + 1.0 / self.ns.total_N
        alpha = float(self.ns.marginal_alpha(t_cont))
        sigma = float(self.ns.marginal_std(t_cont))
        if self.model_type == "x_start":
            return divc(x.float() - alpha * out.float(), sigma)
        if self.model_type == "v":
            return alpha * out.float() + sigma * x.float()
        return -sigma * out.float()

    def sample(self, model_apply, z, y, mask=None, generator=None,
               qctx_factory=None, return_trajectory: bool = False):
        """z: [n, C, ...]; y: [2n, 1, L, C_cap] = [cond; null]. Returns
        the final latent [n, C, ...] in z's dtype, and with
        return_trajectory the solver's {xs, ts} (not CFG-doubled). The
        solver draws nothing: generator is taken for the samplers' common
        signature."""
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
            eps_c = self._eps_from_output(out_c[:, :c], x, t_model)
            eps_u = self._eps_from_output(out_u[:, :c], x, t_model)
            return eps_u + s * (eps_c - eps_u)

        solver = DPMSolver(
            noise_model_fn, self.ns, self.algorithm_type, self.solver_type,
            correcting_x0_fn=("dynamic_thresholding" if self.thresholding
                              else None))
        return solver.sample(z, steps=self.steps, order=self.order,
                             skip_type=self.skip_type, method=self.method,
                             lower_order_final=self.lower_order_final,
                             denoise_to_zero=self.denoise_to_zero,
                             capture_trajectory=return_trajectory)
