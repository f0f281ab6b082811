"""Diffusion schedule, the DDIM loop, IDDPM's ancestral loop and the
training step's MSE loss (port of `viditq_tpu/samplers/gaussian_diffusion.py`).

The respaced schedule is precomputed into numpy float64 arrays exactly as
in the JAX package; the JAX `lax.scan` denoise loops become Python loops
whose coefficients are float32, as the JAX loops' `_extract` makes them.
`step_indices` runs a sub-range of the DDIM trajectory (descending
spaced-step ids), e.g. the first k steps of a 20-step schedule.

Draws: every Gaussian draw comes from the `generator` argument (`randn`:
drawn on the generator's device, then moved to the latent's, so a CPU
generator gives the same noise to a run on the card), or from a
`noise_fn(x, i)` hook that replaces it (the JAX loops' hook; threefry's
draws cannot be matched).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """OpenAI schedule (gaussian_diffusion.py get_named_beta_schedule)."""
    if name == "linear":
        scale = 1000 / num_steps
        return np.linspace(scale * 1e-4, scale * 2e-2, num_steps,
                           dtype=np.float64)
    if name == "squaredcos_cap_v2":
        def f(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        ts = np.arange(num_steps)
        betas = 1 - f((ts + 1) / num_steps) / f(ts / num_steps)
        return np.minimum(betas, 0.999)
    raise ValueError(f"unknown beta schedule {name!r}")


def space_timesteps(num_timesteps: int, section_counts) -> list:
    """Evenly respace (reference respace.py space_timesteps): section
    counts as a list, a comma-separated string, or 'ddimN' (the stride
    that gives exactly N steps)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return list(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {desired} ddim steps")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur_idx = 0.0
        taken = []
        for _ in range(count):
            taken.append(start_idx + round(cur_idx))
            cur_idx += stride
        all_steps += taken
        start_idx += size
    return sorted(all_steps)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Respaced diffusion schedule; all arrays are [n_steps] numpy fp64.
    `timestep_map[i]` is the original-scale timestep at spaced step i."""

    betas: np.ndarray
    timestep_map: np.ndarray

    @property
    def n_steps(self) -> int:
        return len(self.betas)

    def __post_init__(self):
        alphas = 1.0 - self.betas
        acp = np.cumprod(alphas)
        acp_prev = np.append(1.0, acp[:-1])
        post_var = self.betas * (1.0 - acp_prev) / (1.0 - acp)
        fields = {
            "alphas_cumprod": acp,
            "alphas_cumprod_prev": acp_prev,
            "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / acp),
            "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / acp - 1),
            "posterior_variance": post_var,
            "posterior_log_variance_clipped": np.log(
                np.append(post_var[1], post_var[1:])),
            "posterior_mean_coef1": self.betas * np.sqrt(acp_prev)
            / (1.0 - acp),
            "posterior_mean_coef2": (1.0 - acp_prev) * np.sqrt(alphas)
            / (1.0 - acp)}
        for k, v in fields.items():
            object.__setattr__(self, k, v)


def make_schedule(num_sampling_steps: Optional[int] = None,
                  timestep_respacing=None, noise_schedule: str = "linear",
                  diffusion_steps: int = 1000) -> Schedule:
    """IDDPM constructor semantics (iddpm/__init__.py:13-49 + respace.py)."""
    base_betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if num_sampling_steps is not None:
        if timestep_respacing is not None:
            raise ValueError("give num_sampling_steps or timestep_respacing")
        timestep_respacing = str(num_sampling_steps)
    if not timestep_respacing:
        timestep_respacing = [diffusion_steps]
    use = set(space_timesteps(diffusion_steps, timestep_respacing))
    base_acp = np.cumprod(1.0 - base_betas)
    last = 1.0
    new_betas, tmap = [], []
    for i in range(diffusion_steps):
        if i in use:
            new_betas.append(1 - base_acp[i] / last)
            last = base_acp[i]
            tmap.append(i)
    return Schedule(betas=np.array(new_betas),
                    timestep_map=np.array(tmap, np.int64))


# model_fn(x, t_orig [B] int, step_idx int) -> model output
ModelFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
# noise_fn(x, i) -> the draw of step i, x's shape
NoiseFn = Callable[[torch.Tensor, int], torch.Tensor]


def randn(x: torch.Tensor, generator: Optional[torch.Generator],
          dtype=torch.float32) -> torch.Tensor:
    """Standard normal draws of x's shape from generator (on its device,
    then moved to x's)."""
    if generator is None:
        raise ValueError("this sampler draws noise: pass generator=")
    return torch.randn(x.shape, generator=generator, device=generator.device,
                       dtype=dtype).to(x.device)


def _split_eps(model_out: torch.Tensor, c: int):
    """eps/rest split at the latent channel count (gaussian_diffusion.py:
    142-145; the rest has 0 channels for an eps-only model)."""
    return model_out[:, :c], model_out[:, c:]


def _coef(arr: np.ndarray, i: int, like: torch.Tensor) -> torch.Tensor:
    """Schedule coefficient at step i as a float32 tensor broadcastable
    against `like` (a dimensioned tensor, so it promotes bf16 x to f32 as
    the JAX loop's f32 arrays do)."""
    return torch.tensor(np.float32(arr[i]), device=like.device).reshape(
        (1,) * like.dim())


def _t_orig(schedule: Schedule, i: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((like.shape[0],), int(schedule.timestep_map[i]),
                      dtype=torch.int32, device=like.device)


def trajectory(xs, ts):
    """A loop's captured states and timesteps, stacked: the calibration
    data {'xs': [n, B, ...], 'ts': [n, B]}."""
    return {"xs": torch.stack(xs), "ts": torch.stack(ts)}


def ddim_sample_loop(model_fn: ModelFn, z: torch.Tensor, schedule: Schedule,
                     in_channels: int = 4, eta: float = 0.0,
                     step_indices: Optional[Sequence[int]] = None,
                     capture_trajectory: bool = False,
                     generator: Optional[torch.Generator] = None,
                     noise_fn: Optional[NoiseFn] = None):
    """DDIM (gaussian_diffusion.py:148-198). z: [B, C, ...] initial noise,
    already CFG-doubled by the caller. eta > 0 adds sigma * noise in x's
    dtype at every step but the last (i = 0). With capture_trajectory,
    also {'xs': each step's input [n_steps, B, ...], 'ts': its timestep
    [n_steps, B]}: the reference's calib_data (:679-689)."""
    n = schedule.n_steps
    steps = (range(n - 1, -1, -1) if step_indices is None
             else [int(i) for i in step_indices])
    x = z
    xs, ts = [], []
    for i in steps:
        t_orig = _t_orig(schedule, i, x)
        if capture_trajectory:
            xs.append(x)
            ts.append(t_orig)
        eps = model_fn(x, t_orig, i)[:, :in_channels]
        sr = _coef(schedule.sqrt_recip_alphas_cumprod, i, x)
        srm1 = _coef(schedule.sqrt_recipm1_alphas_cumprod, i, x)
        pred_xstart = sr * x - srm1 * eps
        acp = _coef(schedule.alphas_cumprod, i, x)
        acp_prev = _coef(schedule.alphas_cumprod_prev, i, x)
        sigma = (eta * torch.sqrt((1 - acp_prev) / (1 - acp))
                 * torch.sqrt(1 - acp / acp_prev))
        # re-derive eps from xstart (identity without clipping)
        eps2 = (sr * x - pred_xstart) / srm1
        mean = (torch.sqrt(acp_prev) * pred_xstart
                + torch.sqrt(torch.clamp(1 - acp_prev - sigma ** 2, min=0.0))
                * eps2)
        if eta > 0 and i > 0:
            noise = (noise_fn(x, i) if noise_fn is not None
                     else randn(x, generator, x.dtype))
            mean = mean + sigma * noise
        x = mean.to(x.dtype)
    if capture_trajectory:
        return x, trajectory(xs, ts)
    return x


def p_sample_loop(model_fn: ModelFn, z: torch.Tensor, schedule: Schedule,
                  generator: Optional[torch.Generator] = None,
                  in_channels: int = 4, capture_trajectory: bool = False,
                  noise_fn: Optional[NoiseFn] = None):
    """Ancestral sampling with LEARNED_RANGE variance
    (gaussian_diffusion.py:201-243): the model's channels C..2C
    interpolate the log variance between the posterior's (min) and beta
    (max); float32 noise and coefficients, none added at i = 0; the sample
    is cast back to the latent's dtype each step. A model without the
    variance channels (`pred_sigma=False`) raises. noise_fn(x, i)
    replaces the draw from generator."""
    n = schedule.n_steps
    x = z
    xs, ts = [], []
    for i in range(n - 1, -1, -1):
        t_orig = _t_orig(schedule, i, x)
        if capture_trajectory:
            xs.append(x)
            ts.append(t_orig)
        out = model_fn(x, t_orig, i)
        if out.shape[1] != 2 * in_channels:
            raise ValueError(
                f"the ancestral loop reads a learned variance in channels "
                f"{in_channels}..{2 * in_channels} of the model output; it "
                f"has {out.shape[1]} (a model with pred_sigma=False)")
        eps, var_raw = out[:, :in_channels], out[:, in_channels:]
        min_log = _coef(schedule.posterior_log_variance_clipped, i, x)
        max_log = torch.log(_coef(schedule.betas, i, x))
        frac = (var_raw.float() + 1) / 2
        log_var = frac * max_log + (1 - frac) * min_log
        sr = _coef(schedule.sqrt_recip_alphas_cumprod, i, x)
        srm1 = _coef(schedule.sqrt_recipm1_alphas_cumprod, i, x)
        pred_xstart = sr * x - srm1 * eps
        mean = (_coef(schedule.posterior_mean_coef1, i, x) * pred_xstart
                + _coef(schedule.posterior_mean_coef2, i, x) * x)
        if i > 0:
            noise = (noise_fn(x, i) if noise_fn is not None
                     else randn(x, generator))
            mean = mean + torch.exp(0.5 * log_var) * noise
        x = mean.to(x.dtype)
    if capture_trajectory:
        return x, trajectory(xs, ts)
    return x


def noised(schedule: Schedule, x_start: torch.Tensor, t: torch.Tensor,
           noise: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0) in float32: sqrt(acp[t]) x_0 + sqrt(1 - acp[t]) noise,
    t the spaced-step ids [B]."""
    acp = torch.as_tensor(schedule.alphas_cumprod, dtype=torch.float32,
                          device=x_start.device)[t]
    shape = (-1,) + (1,) * (x_start.dim() - 1)
    return (torch.sqrt(acp).reshape(shape) * x_start
            + torch.sqrt(1 - acp).reshape(shape) * noise)


def model_timesteps(schedule: Schedule, t: torch.Tensor) -> torch.Tensor:
    """The original-scale timesteps [B] int32 the model receives at
    spaced steps t."""
    return torch.as_tensor(schedule.timestep_map, dtype=torch.int32,
                           device=t.device)[t]


def training_losses(model_fn, x_start: torch.Tensor, t: torch.Tensor,
                    noise: torch.Tensor, schedule: Schedule,
                    in_channels: int = 4) -> torch.Tensor:
    """The simple-MSE diffusion loss (gaussian_diffusion.py:246-261): x_t
    built in float32, the model at `timestep_map[t]`, the mean over the
    whole batch of (eps - noise)^2 in float32, eps the output's first
    in_channels. model_fn(x_t, t_orig) -> output."""
    model_out = model_fn(noised(schedule, x_start, t, noise),
                         model_timesteps(schedule, t))
    eps, _ = _split_eps(model_out, in_channels)
    return torch.mean((eps.float() - noise) ** 2)
