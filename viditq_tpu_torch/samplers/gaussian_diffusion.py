"""Diffusion schedule and the DDIM loop (port of
`viditq_tpu/samplers/gaussian_diffusion.py`).

The respaced schedule is precomputed into numpy float64 arrays exactly as
in the JAX package; the JAX `lax.scan` denoise loop becomes a Python loop.
`step_indices` runs a sub-range of the trajectory (descending spaced-step
ids), e.g. the first k steps of a 20-step schedule. Only deterministic
DDIM (eta = 0) is ported; the ancestral sampler is not.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def get_named_beta_schedule(name: str, num_steps: int) -> np.ndarray:
    """OpenAI schedule (gaussian_diffusion.py get_named_beta_schedule); the
    port has the 'linear' schedule STDiT uses."""
    if name != "linear":
        raise NotImplementedError(name)
    scale = 1000 / num_steps
    return np.linspace(scale * 1e-4, scale * 2e-2, num_steps,
                       dtype=np.float64)


def space_timesteps(num_timesteps: int, section_counts) -> list:
    """Evenly respace (reference respace.py space_timesteps); section
    counts as a list or a comma-separated string ('ddimN' is not ported)."""
    if isinstance(section_counts, str):
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
        acp = np.cumprod(1.0 - self.betas)
        object.__setattr__(self, "alphas_cumprod", acp)
        object.__setattr__(self, "alphas_cumprod_prev",
                           np.append(1.0, acp[:-1]))
        object.__setattr__(self, "sqrt_recip_alphas_cumprod",
                           np.sqrt(1.0 / acp))
        object.__setattr__(self, "sqrt_recipm1_alphas_cumprod",
                           np.sqrt(1.0 / acp - 1))


def make_schedule(num_sampling_steps: Optional[int] = None,
                  timestep_respacing=None, noise_schedule: str = "linear",
                  diffusion_steps: int = 1000) -> Schedule:
    """IDDPM constructor semantics (iddpm/__init__.py:13-49 + respace.py)."""
    base_betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if num_sampling_steps is not None:
        assert timestep_respacing is None
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


def _coef(arr: np.ndarray, i: int, like: torch.Tensor) -> torch.Tensor:
    """Schedule coefficient at step i as a float32 tensor broadcastable
    against `like` (a dimensioned tensor, so it promotes bf16 x to f32 as
    the JAX loop's f32 arrays do)."""
    return torch.tensor(np.float32(arr[i]), device=like.device).reshape(
        (1,) * like.dim())


def ddim_sample_loop(model_fn: ModelFn, z: torch.Tensor, schedule: Schedule,
                     in_channels: int = 4,
                     step_indices: Optional[Sequence[int]] = None,
                     capture_trajectory: bool = False):
    """Deterministic DDIM, eta = 0 (gaussian_diffusion.py:148-198). z:
    [B, C, ...] initial noise, already CFG-doubled by the caller. With
    capture_trajectory, also {'xs': each step's input [n_steps, B, ...],
    'ts': its timestep [n_steps, B]}: the reference's calib_data
    (:679-689)."""
    n = schedule.n_steps
    B = z.shape[0]
    steps = (range(n - 1, -1, -1) if step_indices is None
             else [int(i) for i in step_indices])
    x = z
    xs, ts = [], []
    for i in steps:
        t_orig = torch.full((B,), int(schedule.timestep_map[i]),
                            dtype=torch.int32, device=z.device)
        if capture_trajectory:
            xs.append(x)
            ts.append(t_orig)
        eps = model_fn(x, t_orig, i)[:, :in_channels]
        sr = _coef(schedule.sqrt_recip_alphas_cumprod, i, x)
        srm1 = _coef(schedule.sqrt_recipm1_alphas_cumprod, i, x)
        pred_xstart = sr * x - srm1 * eps
        acp_prev = _coef(schedule.alphas_cumprod_prev, i, x)
        # re-derive eps from xstart (identity without clipping)
        eps2 = (sr * x - pred_xstart) / srm1
        mean = (torch.sqrt(acp_prev) * pred_xstart
                + torch.sqrt(torch.clamp(1 - acp_prev, min=0.0)) * eps2)
        x = mean.to(x.dtype)
    if capture_trajectory:
        return x, {"xs": torch.stack(xs), "ts": torch.stack(ts)}
    return x
