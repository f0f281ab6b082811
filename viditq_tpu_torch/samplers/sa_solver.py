"""SA-Solver, the stochastic-Adams predictor-corrector solver (port of
`viditq_tpu/samplers/sa_solver.py`).

Predictor orders 1-4 (Adams-Bashforth), corrector orders 0-4
(Adams-Moulton), PEC and PECE, tau-stochastic sampling with a tau per
timestep, the `few_steps` (rescaling trick, no final evaluation) and
`more_steps` (denoise-to-zero) loop shapes, data or noise prediction, skip
types time / logSNR / karras, and dynamic thresholding. As in the JAX
package, every update is linear in the buffered model values once the
grid and the tau schedule are fixed: the Lagrange-interpolated exponential
integrals give a tableau of state coefficients, gradient coefficients and
noise scales, computed host-side in numpy float64 (the JAX module's code,
a copy: the port imports nothing of the JAX package). The JAX `lax.scan`
becomes a Python loop that combines the state, a rolling history of four
model values and the step's noise in float32.

Draws: one standard normal tensor a step (of the loop's steps, only when
some noise scale is nonzero), from `generator` or from the `_noise_fn(x,
i)` hook, cast to the latent's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from viditq_tpu_torch.kernels._common import divc
from viditq_tpu_torch.samplers.dpm_solver import (NoiseScheduleVP,
                                                  dynamic_threshold,
                                                  model_input_timestep)
from viditq_tpu_torch.samplers.gaussian_diffusion import randn, trajectory

MAX_ORDER = 4


def _exp_int_negative(order: int, a: float, b: float) -> float:
    """integral of exp(-x) x^order dx over [a, b] (sa_solver.py:46-62),
    for the noise-prediction formula."""
    if order == 0:
        return np.exp(-b) * (np.exp(b - a) - 1.0)
    if order == 1:
        return np.exp(-b) * ((a + 1.0) * np.exp(b - a) - (b + 1.0))
    if order == 2:
        return np.exp(-b) * ((a ** 2 + 2 * a + 2) * np.exp(b - a)
                             - (b ** 2 + 2 * b + 2))
    if order == 3:
        return np.exp(-b) * ((a ** 3 + 3 * a ** 2 + 6 * a + 6)
                             * np.exp(b - a)
                             - (b ** 3 + 3 * b ** 2 + 6 * b + 6))
    raise ValueError(f"unsupported integral order {order}")


def _exp_int_positive(order: int, a: float, b: float, tau: float) -> float:
    """integral of exp(x (1+tau^2)) x^order dx over [a, b]
    (sa_solver.py:65-84), for the data-prediction formula."""
    t2 = 1.0 + tau ** 2
    bc, ac = t2 * b, t2 * a
    if order == 0:
        return np.exp(bc) * (1.0 - np.exp(-(bc - ac))) / t2
    if order == 1:
        return np.exp(bc) * ((bc - 1.0) - (ac - 1.0) * np.exp(-(bc - ac))) \
            / t2 ** 2
    if order == 2:
        return np.exp(bc) * ((bc ** 2 - 2 * bc + 2)
                             - (ac ** 2 - 2 * ac + 2) * np.exp(-(bc - ac))) \
            / t2 ** 3
    if order == 3:
        return np.exp(bc) * ((bc ** 3 - 3 * bc ** 2 + 6 * bc - 6)
                             - (ac ** 3 - 3 * ac ** 2 + 6 * ac - 6)
                             * np.exp(-(bc - ac))) / t2 ** 4
    raise ValueError(f"unsupported integral order {order}")


def _lagrange_coeffs(lambda_list) -> np.ndarray:
    """[n, n] monomial coefficients of the n Lagrange basis polynomials
    over the lambda nodes, highest power first (sa_solver.py:87-101)."""
    lam = np.asarray(lambda_list, np.float64)
    n = len(lam)
    rows = []
    for i in range(n):
        others = np.delete(lam, i)
        denom = np.prod(lam[i] - others) if n > 1 else 1.0
        numer = np.poly(others) if n > 1 else np.asarray([1.0])
        rows.append(numer / denom)
    return np.stack(rows)


def _grad_coefficients(order: int, a: float, b: float, lambda_list,
                       tau: float, predict_x0: bool) -> np.ndarray:
    """Each Lagrange basis polynomial integrated against the exponential
    kernel over [a, b] (sa_solver.py:104-118); coeff[i] multiplies the
    (i+1)-th most recent model value."""
    if order != len(lambda_list):
        raise ValueError(f"order {order} over {len(lambda_list)} nodes")
    lag = _lagrange_coeffs(lambda_list)
    out = np.zeros(order, np.float64)
    for i in range(order):
        acc = 0.0
        for j in range(order):
            if predict_x0:
                acc += lag[i][j] * _exp_int_positive(order - 1 - j, a, b, tau)
            else:
                acc += lag[i][j] * _exp_int_negative(order - 1 - j, a, b)
        out[i] = acc
    return out


@dataclasses.dataclass
class _UpdateRow:
    """One Adams update as a linear form: x_new = cx * x +
    sum_i m_coef[i] * hist[i] + noise_scale * noise."""

    cx: float
    m_coef: np.ndarray  # [MAX_ORDER]; corrector rows index the pushed buffer
    noise_scale: float


def _adams_update_row(ns: NoiseScheduleVP, t_prev_list, t: float, order: int,
                      tau: float, predict_x0: bool, corrector: bool,
                      rescaling: bool) -> _UpdateRow:
    """One SA predictor or corrector update's coefficients
    (sa_solver.py:120-181); `rescaling` is the few-steps trick."""
    lam_t = float(ns.marginal_lambda(t))
    lam_prev = float(ns.marginal_lambda(t_prev_list[-1]))
    h = lam_t - lam_prev
    alpha_t = float(ns.marginal_alpha(t))
    sigma_t = float(ns.marginal_std(t))

    t_list = list(t_prev_list) + ([t] if corrector else [])
    lambda_list = [float(ns.marginal_lambda(t_list[-(i + 1)]))
                   for i in range(order)]
    g = _grad_coefficients(order, lam_prev, lam_t, lambda_list, tau,
                           predict_x0)

    if predict_x0 and rescaling and order == 2:
        t2 = 1.0 + tau ** 2
        if corrector:
            extra = np.exp(t2 * lam_t) * (
                h / 2.0 - (h * t2 - 1.0 + np.exp(-t2 * h)) / (t2 ** 2 * h))
        else:
            lam_prev2 = float(ns.marginal_lambda(t_prev_list[-2]))
            extra = np.exp(t2 * lam_t) * (
                h ** 2 / 2.0 - (h * t2 - 1.0 + np.exp(-t2 * h)) / t2 ** 2) \
                / (lam_prev - lam_prev2)
        g = g.copy()
        g[0] += extra
        g[1] -= extra

    m_coef = np.zeros(MAX_ORDER, np.float64)
    for i in range(order):
        if predict_x0:
            m_coef[i] = (1.0 + tau ** 2) * sigma_t \
                * np.exp(-tau ** 2 * lam_t) * g[i]
        else:
            m_coef[i] = -(1.0 + tau ** 2) * alpha_t * g[i]

    if predict_x0:
        sigma_prev = float(ns.marginal_std(t_prev_list[-1]))
        cx = np.exp(-tau ** 2 * h) * sigma_t / sigma_prev
        noise_scale = sigma_t * np.sqrt(
            max(1.0 - np.exp(-2.0 * tau ** 2 * h), 0.0))
    else:
        alpha_prev = float(ns.marginal_alpha(t_prev_list[-1]))
        cx = alpha_t / alpha_prev
        noise_scale = tau * sigma_t * np.sqrt(max(np.exp(2.0 * h) - 1.0, 0.0))
    return _UpdateRow(cx=float(cx), m_coef=m_coef,
                      noise_scale=float(noise_scale))


def _edm_sigma(ns, t):
    return ns.marginal_std(t) / ns.marginal_alpha(t)


def _edm_inverse_sigma(ns, edm_sigma):
    edm_sigma = np.asarray(edm_sigma, np.float64)
    alpha = 1.0 / np.sqrt(edm_sigma ** 2 + 1.0)
    sigma = alpha * edm_sigma
    return ns.inverse_lambda(np.log(alpha / sigma))


def sa_time_steps(ns: NoiseScheduleVP, skip_type: str, t_T: float,
                  t_0: float, N: int, skip_order: int = 1) -> np.ndarray:
    """SA-Solver's grid [N+1] (sa_solver.py:183-220): 'time' spaced in
    t^(1/skip_order), 'logSNR' in logSNR, 'karras' in EDM sigma (its
    sigma_min >= 0.002, sigma_max <= 80)."""
    if skip_type == "time":
        return np.linspace(t_T ** (1.0 / skip_order),
                           t_0 ** (1.0 / skip_order), N + 1) ** skip_order
    if skip_type == "logSNR":
        lam_T = ns.marginal_lambda(t_T)
        lam_0 = ns.marginal_lambda(t_0)
        steps = lam_T + np.linspace(
            0.0, float(lam_0 - lam_T) ** (1.0 / skip_order), N + 1) \
            ** skip_order
        return ns.inverse_lambda(steps)
    if skip_type == "karras":
        sigma_min = max(0.002, float(_edm_sigma(ns, 1e-3)))
        sigma_max = min(80.0, float(_edm_sigma(ns, 1.0)))
        sig = np.linspace(sigma_max ** (1 / 7), sigma_min ** (1 / 7),
                          N + 1) ** 7
        return _edm_inverse_sigma(ns, sig)
    raise ValueError(f"unsupported skip_type {skip_type!r}")


def _f32(v) -> float:
    return float(np.float32(v))


class SASolver:
    """Tableau-driven SA-Solver (sa_solver.py:222-417).
    noise_model_fn(x, t_model [B] float32, eval_idx) -> eps prediction."""

    def __init__(self, noise_model_fn: Callable, ns: NoiseScheduleVP,
                 algorithm_type: str = "data_prediction",
                 correcting_x0_fn: Optional[str] = None,
                 thresholding_max_val: float = 1.0,
                 dynamic_thresholding_ratio: float = 0.995):
        if algorithm_type not in ("data_prediction", "noise_prediction"):
            raise ValueError(algorithm_type)
        self.noise_model_fn = noise_model_fn
        self.ns = ns
        self.predict_x0 = algorithm_type == "data_prediction"
        self.thresholding = correcting_x0_fn == "dynamic_thresholding"
        self.thresholding_max_val = thresholding_max_val
        self.dynamic_thresholding_ratio = dynamic_thresholding_ratio

    def _t_model(self, x, t_cont: float) -> torch.Tensor:
        return torch.full((x.shape[0],), _f32(model_input_timestep(
            t_cont, self.ns.total_N)), device=x.device)

    def _model_value(self, x, t_cont: float, eval_idx: int):
        """eps for noise prediction; the (thresholded) x0 for data
        prediction (sa_solver.py:245-258), in float32."""
        eps = self.noise_model_fn(x, self._t_model(x, t_cont),
                                  eval_idx).float()
        if not self.predict_x0:
            return eps
        alpha = float(self.ns.marginal_alpha(t_cont))
        sigma = float(self.ns.marginal_std(t_cont))
        x0 = divc(x.float() - sigma * eps, alpha)
        if self.thresholding:
            x0 = dynamic_threshold(x0, self.dynamic_thresholding_ratio,
                                   self.thresholding_max_val)
        return x0

    def tableau(self, steps, t_T, t_0, tau_fn, skip_type, skip_order,
                predictor_order, corrector_order, few: bool):
        """(grid ts [steps+1], predictor rows, corrector rows or None) of
        steps 1..steps (sa_solver.py:297-322): warm-up order ramps, the
        lower-order tail, and in few_steps mode the final step a
        predictor at tau = 0."""
        ns = self.ns
        ts = sa_time_steps(ns, skip_type, t_T, t_0, steps, skip_order)
        pred_rows, corr_rows = [], []
        warm = max(predictor_order, corrector_order - 1)
        t_prev_list = [float(ts[0])]
        for step in range(1, steps + 1):
            t = float(ts[step])
            if step < warm:
                po = min(predictor_order, step)
                co = min(corrector_order, step + 1)
            else:
                po = min(predictor_order, steps - step + 1)
                co = min(corrector_order, steps - step + 2)
            tau_s = float(tau_fn(t))
            final_skip = few and step == steps
            pred_rows.append(_adams_update_row(
                ns, t_prev_list, t, po, 0.0 if final_skip else tau_s,
                self.predict_x0, corrector=False, rescaling=few))
            corr_rows.append(
                _adams_update_row(ns, t_prev_list, t, co, tau_s,
                                  self.predict_x0, corrector=True,
                                  rescaling=few)
                if corrector_order > 0 and not final_skip else None)
            t_prev_list.append(t)
        return ts, pred_rows, corr_rows

    @torch.no_grad()
    def sample(self, x: torch.Tensor,
               tau: Union[float, Callable[[float], float]] = 0.0,
               steps: int = 25, t_start: Optional[float] = None,
               t_end: Optional[float] = None, skip_type: str = "time",
               skip_order: int = 1, predictor_order: int = 3,
               corrector_order: int = 4, pc_mode: str = "PEC",
               mode: str = "few_steps",
               generator: Optional[torch.Generator] = None,
               capture_trajectory: bool = False,
               _noise_fn: Optional[Callable] = None):
        """sample_few_steps / sample_more_steps (sa_solver.py:261-405).
        tau: a float, or a host callable t -> tau(t) on the grid. The
        model evaluations are numbered as the JAX scan numbers them (0 at
        the start; 1 + i * k, and 2 + i * k under PECE, in step i with k
        evaluations a step; the denoise-to-zero one last); the ones JAX
        computes and then drops (PECE's on the last step of more_steps)
        are not run. With capture_trajectory also {'xs': the state at
        each loop step's start and after the last, 'ts': its model
        timestep}. _noise_fn(x, i) -> step i's draw replaces the
        generator's (JAX's hook takes (key, shape, dtype))."""
        if pc_mode not in ("PEC", "PECE"):
            raise ValueError(f"unsupported pc_mode {pc_mode!r}")
        if mode not in ("few_steps", "more_steps"):
            raise ValueError(f"unsupported mode {mode!r}")
        if steps < max(predictor_order, corrector_order - 1):
            raise ValueError("steps must cover the warm-up ramp")
        ns = self.ns
        t_0 = 1.0 / ns.total_N if t_end is None else t_end
        t_T = ns.T if t_start is None else t_start
        few = mode == "few_steps"
        tau_fn = tau if callable(tau) else (lambda _t, _v=float(tau): _v)
        ts, pred_rows, corr_rows = self.tableau(
            steps, t_T, t_0, tau_fn, skip_type, skip_order, predictor_order,
            corrector_order, few)
        stochastic = any(r is not None and r.noise_scale != 0.0
                         for r in pred_rows + corr_rows)
        pece = pc_mode == "PECE" and corrector_order > 0
        k = 2 if pece else 1
        n_loop = steps - 1 if few else steps

        def combine(row, x, hist, noise):
            acc = _f32(row.cx) * x.float()
            for c, m in zip(row.m_coef, hist):
                acc = acc + _f32(c) * m
            if noise is not None:
                acc = acc + _f32(row.noise_scale) * noise.float()
            return acc.to(x.dtype)

        m0 = self._model_value(x, float(ts[0]), 0)
        hist = [m0] + [torch.zeros_like(m0)] * (MAX_ORDER - 1)
        xs, tms = [x], [self._t_model(x, float(ts[0]))]
        for i in range(n_loop):
            t = float(ts[i + 1])
            noise = None
            if stochastic:
                noise = (_noise_fn(x, i) if _noise_fn is not None
                         else randn(x, generator)).to(x.dtype)
            x_p = combine(pred_rows[i], x, hist, noise)
            m = self._model_value(x_p, t, 1 + i * k)
            hist = [m] + hist[:-1]
            x_new = x_p
            if corr_rows[i] is not None:
                x_new = combine(corr_rows[i], x, hist, noise)
                if pece and i + 1 < steps:
                    hist[0] = self._model_value(x_new, t, 2 + i * k)
            x = x_new
            if capture_trajectory:
                xs.append(x)
                tms.append(self._t_model(x, t))
        if few:
            # the final step: the predictor at tau = 0, no model eval
            x = combine(pred_rows[-1], x, hist, None)
        else:
            # denoise to zero (sa_solver.py:382-388)
            x0 = self._model_value(x, t_0, 1 + n_loop * k)
            if not self.predict_x0:
                alpha = float(ns.marginal_alpha(t_0))
                sigma = float(ns.marginal_std(t_0))
                x0 = divc(x.float() - sigma * x0, alpha)
            x = x0.to(x.dtype)
        if capture_trajectory:
            return x, trajectory(xs, tms)
        return x
