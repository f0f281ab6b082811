"""The other t2i samplers: LCM, EDM and the SA-Solver wrapper (port of
`viditq_tpu/samplers/extra_solvers.py`; the reference's
`t2i/diffusion/lcm_scheduler.py`, `edm_sample.py` and `sa_sampler.py`,
reached through `quant_txt2img.py:138-182`'s `--sampler_type`).

Each `sample(model_apply, z, y, mask, generator=, qctx_factory=,
return_trajectory=)` takes the model as the other samplers do
(`model_apply(x, t, y, mask, qctx)`), y = [cond; null].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from viditq_tpu_torch.kernels._common import divc
from viditq_tpu_torch.samplers.dpm_solver import NoiseScheduleVP, abs_quantile
from viditq_tpu_torch.samplers.gaussian_diffusion import (
    get_named_beta_schedule, randn, trajectory)
from viditq_tpu_torch.samplers.sa_solver import SASolver


def get_guidance_scale_embedding(w, embedding_dim: int) -> torch.Tensor:
    """Sinusoidal embedding of the guidance weight w [B] (x 1000) for
    guidance-distilled consistency models (extra_solvers.py:27-43):
    [B, embedding_dim] float32."""
    w = torch.as_tensor(w, dtype=torch.float32) * 1000.0
    half = embedding_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device)
                      * np.float32(-np.log(10000.0) / (half - 1)))
    emb = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class LCMScheduler:
    """Latent-consistency sampling (extra_solvers.py:45-163): at each
    timestep the model's x0 prediction (epsilon / sample / v_prediction,
    then clip or dynamic threshold), the boundary scalings c_skip / c_out
    with t scaled up 10x (the reference's t / 0.1) and sigma_data 0.5, and
    re-noising to the next timestep (none after the last). The model runs
    on the cond half alone: batch n with y's first n rows. With
    `guidance_embed_dim`, the model also gets `w_embed` (the guidance
    weight cfg_scale - 1's embedding) as a keyword."""

    sigma_data = 0.5

    def __init__(self, num_sampling_steps: int = 4,
                 lcm_origin_steps: int = 50, diffusion_steps: int = 1000,
                 cfg_scale: float = 4.0, in_channels: int = 4,
                 prediction_type: str = "epsilon",
                 clip_sample: bool = False, thresholding: bool = False,
                 dynamic_thresholding_ratio: float = 0.995,
                 sample_max_value: float = 1.0,
                 guidance_embed_dim: Optional[int] = None):
        if prediction_type not in ("epsilon", "sample", "v_prediction"):
            raise ValueError(f"unsupported prediction_type "
                             f"{prediction_type!r}")
        self.steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.in_channels = in_channels
        self.prediction_type = prediction_type
        self.clip_sample = clip_sample
        self.thresholding = thresholding
        self.dynamic_thresholding_ratio = dynamic_thresholding_ratio
        self.sample_max_value = sample_max_value
        self.guidance_embed_dim = guidance_embed_dim
        betas = get_named_beta_schedule("linear", diffusion_steps)
        self.alphas_cumprod = np.cumprod(1.0 - betas)
        # every k-th of the origin-step grid, descending
        # (lcm_scheduler.set_timesteps)
        c = diffusion_steps // lcm_origin_steps
        lcm_origin = np.asarray(range(1, lcm_origin_steps + 1)) * c - 1
        skip = max(len(lcm_origin) // num_sampling_steps, 1)
        self.timesteps = lcm_origin[::-skip][:num_sampling_steps]

    def _pred_x0(self, x, out, a: float):
        """The parameterization branch and the x0 corrections
        (extra_solvers.py:92-112); a = alphas_cumprod[t] as float32."""
        sa, s1a = np.sqrt(np.float32(a)), np.sqrt(np.float32(1) - a)
        if self.prediction_type == "epsilon":
            x0 = divc(x.float() - float(s1a) * out.float(), float(sa))
        elif self.prediction_type == "sample":
            x0 = out.float()
        else:
            x0 = float(sa) * x.float() - float(s1a) * out.float()
        if self.thresholding:
            s = torch.clamp(abs_quantile(x0, self.dynamic_thresholding_ratio),
                            1.0, self.sample_max_value).reshape(
                                (-1,) + (1,) * (x0.dim() - 1))
            x0 = torch.clamp(x0, -s, s) / s
        elif self.clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)
        return x0

    def _scalings(self, t: int):
        ts = np.float32(t) * np.float32(10.0)
        sd2 = np.float32(self.sigma_data ** 2)
        c_skip = sd2 / (ts ** 2 + sd2)
        c_out = ts / np.sqrt(ts ** 2 + sd2)
        return float(c_skip), float(c_out)

    @torch.no_grad()
    def sample(self, model_apply, z, y, mask=None, generator=None,
               qctx_factory=None, return_trajectory: bool = False,
               noise_fn=None):
        """z: [n, C, ...]; y: [2n, 1, L, C] = [cond; null] (the null half
        unused). The re-noising draws (x's dtype) come from generator, or
        from noise_fn(x, i). With return_trajectory also {'xs': each
        step's input [steps, n, ...], 'ts': its timestep [steps, n]}."""
        acp = self.alphas_cumprod.astype(np.float32)
        c = self.in_channels
        y_cond = torch.chunk(y, 2, dim=0)[0]
        kwargs = {}
        if self.guidance_embed_dim is not None:
            w = torch.full((z.shape[0],), self.cfg_scale - 1.0,
                           dtype=torch.float32, device=z.device)
            kwargs["w_embed"] = get_guidance_scale_embedding(
                w, self.guidance_embed_dim)
        x = z
        xs, tss = [], []
        for i, t in enumerate(int(t) for t in self.timesteps):
            qctx = qctx_factory(t, i) if qctx_factory is not None else None
            tb = torch.full((x.shape[0],), float(t), dtype=torch.float32,
                            device=x.device)
            if return_trajectory:
                xs.append(x)
                tss.append(tb.to(torch.int32))
            out = model_apply(x, tb, y_cond, mask, qctx, **kwargs)
            x0 = self._pred_x0(x, out[:, :c], acp[t])
            c_skip, c_out = self._scalings(t)
            denoised = c_out * x0 + c_skip * x.float()
            if i + 1 < self.steps:
                a_next = acp[int(self.timesteps[i + 1])]
                noise = (noise_fn(x, i) if noise_fn is not None
                         else randn(x, generator, x.dtype))
                denoised = (float(np.sqrt(a_next)) * denoised
                            + float(np.sqrt(np.float32(1) - a_next))
                            * noise.float())
            x = denoised.to(x.dtype)
        if return_trajectory:
            return x, trajectory(xs, tss)
        return x


def edm_t_id(sigma: float) -> int:
    """The quant context's timestep of an EDM evaluation at sigma, as the
    JAX package derives it (extra_solvers.py:195-196): trunc(log(max(
    sigma, 1e-6)) * 41 + 500) in float32, clipped to [0, 999]."""
    v = (np.log(np.maximum(np.float32(sigma), np.float32(1e-6)))
         * np.float32(41.0) + np.float32(500.0))
    return min(max(int(v), 0), 999)


class EDMSampler:
    """Karras-EDM Heun sampler (extra_solvers.py:166-231): the sigma
    schedule (sigma_max^(1/rho) + i/(N-1) (sigma_min^(1/rho) -
    sigma_max^(1/rho)))^rho then 0, an Euler step and a Heun correction
    (none on the last step, to sigma = 0). As in the JAX package the model
    is the denoiser: its output's first in_channels channels, CFG-mixed,
    are the x0 estimate, its timestep input is sigma (float32), and its
    quant context's timestep `edm_t_id(sigma)`; the Heun evaluation
    takes the step's index too. JAX also evaluates, and drops, a Heun
    correction on the last step: the port does not run it (2N - 1
    forwards for N steps)."""

    def __init__(self, num_sampling_steps: int = 18, cfg_scale: float = 4.0,
                 sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, in_channels: int = 4):
        self.steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.sigma_min = sigma_min
        self.sigma_max = sigma_max
        self.rho = rho
        self.in_channels = in_channels

    def sigmas(self) -> np.ndarray:
        i = np.arange(self.steps)
        lo, hi, rho = self.sigma_min, self.sigma_max, self.rho
        s = (hi ** (1 / rho)
             + i / max(self.steps - 1, 1) * (lo ** (1 / rho)
                                             - hi ** (1 / rho))) ** rho
        return np.append(s, 0.0)

    @torch.no_grad()
    def sample(self, denoiser, z, y, mask=None, generator=None,
               qctx_factory=None, return_trajectory: bool = False):
        """denoiser(x, sigma [2B], y, mask, qctx) -> x0 estimate (the
        model). z: [B, C, ...]; y: [2B, ...] = [cond; null]. The sampler
        draws nothing (no churn). With return_trajectory also {'xs': each
        step's input, 'ts': its sigma [steps, B] float32}."""
        sig = self.sigmas().astype(np.float32)
        B = z.shape[0]
        c = self.in_channels

        def D(x, sigma: np.float32, step_idx: int):
            qctx = (qctx_factory(edm_t_id(sigma), step_idx)
                    if qctx_factory is not None else None)
            ss = torch.full((2 * B,), float(sigma), dtype=torch.float32,
                            device=x.device)
            out = denoiser(torch.cat([x, x], dim=0), ss, y, mask, qctx)
            d_c, d_u = torch.chunk(out[:, :c], 2, dim=0)
            return d_u + self.cfg_scale * (d_c - d_u)

        x = z
        xs, tss = [], []
        for i in range(self.steps):
            s0, s1 = sig[i], sig[i + 1]
            if return_trajectory:
                xs.append(x)
                tss.append(torch.full((B,), float(s0), dtype=torch.float32,
                                      device=x.device))
            d = divc(x.float() - D(x, s0, i), float(max(s0, np.float32(1e-8))))
            dt = float(s1 - s0)
            x_euler = x.float() + dt * d
            if s1 > 0:
                d2 = divc(x_euler - D(x_euler, max(
                    s1, np.float32(self.sigma_min)), i), float(s1))
                x_new = x.float() + dt * 0.5 * (d + d2)
            else:
                x_new = x_euler
            x = x_new.to(x.dtype)
        if return_trajectory:
            return x, trajectory(xs, tss)
        return x


class SASolverSampler:
    """SA-Solver scheduler wrapper (extra_solvers.py:234-291): CFG over
    [cond; null] embeds (one doubled forward), the data-prediction solver
    in 'few_steps' mode, tau(t) = eta on t in [0.2, 0.8] else 0 unless
    tau is given, eta 0 by default (then it draws nothing)."""

    def __init__(self, num_sampling_steps: int = 25, cfg_scale: float = 4.0,
                 in_channels: int = 4, tau=None, eta: float = 0.0,
                 predictor_order: int = 2, corrector_order: int = 2,
                 pc_mode: str = "PEC", mode: str = "few_steps",
                 skip_type: str = "time", skip_order: int = 1,
                 algorithm_type: str = "data_prediction",
                 thresholding: bool = False):
        self.steps = num_sampling_steps
        self.cfg_scale = cfg_scale
        self.in_channels = in_channels
        if tau is None:
            tau = lambda t: eta if 0.2 <= t <= 0.8 else 0.0  # noqa: E731
        self.tau = tau
        self.predictor_order = predictor_order
        self.corrector_order = corrector_order
        self.pc_mode = pc_mode
        self.mode = mode
        self.skip_type = skip_type
        self.skip_order = skip_order
        self.algorithm_type = algorithm_type
        self.thresholding = thresholding
        self.ns = NoiseScheduleVP()

    def sample(self, model_apply, z, y, mask=None, generator=None,
               qctx_factory=None, return_trajectory: bool = False,
               _noise_fn=None):
        s = self.cfg_scale
        c = self.in_channels

        def noise_model_fn(x, t_model, step_idx):
            t_id = min(max(int(t_model[0].item()), 0), 999)
            qctx = (qctx_factory(t_id, step_idx)
                    if qctx_factory is not None else None)
            out = model_apply(torch.cat([x, x]),
                              torch.cat([t_model, t_model]), y, mask, qctx)
            out_c, out_u = torch.chunk(out[:, :c], 2, dim=0)
            return out_u + s * (out_c - out_u)

        solver = SASolver(
            noise_model_fn, self.ns, algorithm_type=self.algorithm_type,
            correcting_x0_fn=("dynamic_thresholding" if self.thresholding
                              else None))
        return solver.sample(
            z, tau=self.tau, steps=self.steps, skip_type=self.skip_type,
            skip_order=self.skip_order,
            predictor_order=self.predictor_order,
            corrector_order=self.corrector_order, pc_mode=self.pc_mode,
            mode=self.mode, generator=generator,
            capture_trajectory=return_trajectory, _noise_fn=_noise_fn)
