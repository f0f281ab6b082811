"""IDDPM scheduler wrapper with classifier-free guidance (port of
`viditq_tpu/samplers/iddpm.py`): DDIM, or the ancestral loop with the
learned-range variance (`sampler_type="iddpm"`, OpenSora's own).

The CFG batch layout is the reference's: z is doubled, y is [cond; null]
along the batch, and eps is mixed as uncond + s * (cond - uncond).
`cfg_split=True` runs cond and uncond as separate forwards, so dynamic
per-token quant params are computed per branch (iddpm/__init__.py:140-159).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.samplers import gaussian_diffusion as gd

# model_apply(x, t, y, mask, qctx) -> [B, 2*C, ...]; a model is one
ModelApply = Callable[..., torch.Tensor]
# qctx_factory(t_id, step_idx) -> QuantCtx | None
QctxFactory = Callable[[int, int], Optional[QuantCtx]]


def default_qctx_factory(mode: str = "quant",
                         act_slot_map: Optional[Sequence[int]] = None
                         ) -> QctxFactory:
    """Per-step context: the original-scale timestep, the mode and, from
    `act_slot_map` ([1000] original timestep -> static act-table slot,
    `pipelines/ptq.act_slot_map_from_ts`; JAX iddpm.py:28-37), the slot
    (0 without a map)."""

    def factory(t_id, step_idx):
        slot = 0 if act_slot_map is None else int(act_slot_map[int(t_id)])
        return QuantCtx(t_id=int(t_id), mode=mode, act_slot=slot)
    return factory


class IDDPM:
    """iddpm/__init__.py:12-132."""

    def __init__(self, num_sampling_steps: Optional[int] = None,
                 timestep_respacing=None, noise_schedule: str = "linear",
                 diffusion_steps: int = 1000, cfg_scale: float = 4.0,
                 cfg_split: bool = False, in_channels: int = 4):
        self.schedule = gd.make_schedule(
            num_sampling_steps=num_sampling_steps,
            timestep_respacing=timestep_respacing,
            noise_schedule=noise_schedule, diffusion_steps=diffusion_steps)
        self.cfg_scale = cfg_scale
        self.cfg_split = cfg_split
        self.in_channels = in_channels

    def make_cfg_model_fn(self, model_apply: ModelApply, y: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          qctx_factory: Optional[QctxFactory] = None
                          ) -> gd.ModelFn:
        """forward_with_cfg (iddpm/__init__.py:135-184); eps split at
        in_channels."""
        s = self.cfg_scale
        c = self.in_channels

        def model_fn(x, t_orig, step_idx):
            B = x.shape[0]
            half = x[: B // 2]
            qctx = (qctx_factory(t_orig[0].item(), step_idx)
                    if qctx_factory is not None else None)
            if self.cfg_split:
                y_cond, y_uncond = torch.chunk(y, 2, dim=0)
                out_c = model_apply(half, t_orig[: B // 2], y_cond, mask, qctx)
                out_u = model_apply(half, t_orig[: B // 2], y_uncond, mask,
                                    qctx)
                out = torch.cat([out_c, out_u], dim=0)
            else:
                combined = torch.cat([half, half], dim=0)
                out = model_apply(combined, t_orig, y, mask, qctx)
            eps, rest = out[:, :c], out[:, c:]
            cond_eps, uncond_eps = torch.chunk(eps, 2, dim=0)
            half_eps = uncond_eps + s * (cond_eps - uncond_eps)
            eps = torch.cat([half_eps, half_eps], dim=0)
            return torch.cat([eps, rest], dim=1)
        return model_fn

    def sample(self, model_apply: ModelApply, z: torch.Tensor,
               y: torch.Tensor, mask: Optional[torch.Tensor] = None,
               sampler_type: str = "ddim",
               generator: Optional[torch.Generator] = None,
               qctx_factory: Optional[QctxFactory] = None,
               step_indices: Optional[Sequence[int]] = None,
               return_trajectory: bool = False,
               noise_fn: Optional[gd.NoiseFn] = None):
        """CFG sampling by DDIM ('ddim') or the ancestral loop ('iddpm',
        its draws from generator or noise_fn). z: [n, C, ...] (pre-CFG);
        y: [2n, 1, L, C_cap] = [cond; null]; mask: [n, L] or [2n, L].
        Returns the cond half of the final sample, and with
        return_trajectory the CFG-doubled {xs, ts} of every step
        (iddpm.py:86-111). step_indices: run only these (descending)
        spaced steps of DDIM."""
        z2 = torch.cat([z, z], dim=0)
        model_fn = self.make_cfg_model_fn(model_apply, y, mask, qctx_factory)
        if sampler_type == "ddim":
            out = gd.ddim_sample_loop(model_fn, z2, self.schedule,
                                      in_channels=self.in_channels,
                                      step_indices=step_indices,
                                      capture_trajectory=return_trajectory)
        elif sampler_type == "iddpm":
            if step_indices is not None:
                raise ValueError("step_indices runs a range of DDIM only")
            out = gd.p_sample_loop(model_fn, z2, self.schedule, generator,
                                   in_channels=self.in_channels,
                                   capture_trajectory=return_trajectory,
                                   noise_fn=noise_fn)
        else:
            raise ValueError(f"unknown sampler_type {sampler_type!r}")
        if return_trajectory:
            return torch.chunk(out[0], 2, dim=0)[0], out[1]
        return torch.chunk(out, 2, dim=0)[0]

    def denoise_range(self, model_apply: ModelApply, x2: torch.Tensor,
                      y: torch.Tensor, mask: Optional[torch.Tensor],
                      step_indices: Sequence[int],
                      qctx_factory: Optional[QctxFactory] = None
                      ) -> torch.Tensor:
        """DDIM over `step_indices` (descending) on an already CFG-doubled
        state x2 [2n, C, ...]; returns the doubled state. The building
        block of timestep-wise mixed precision's segmented path, each range
        on its own model (iddpm.py:113-125; reference
        quant_txt2video_mp.py:188-556)."""
        model_fn = self.make_cfg_model_fn(model_apply, y, mask, qctx_factory)
        return gd.ddim_sample_loop(model_fn, x2, self.schedule,
                                   in_channels=self.in_channels,
                                   step_indices=step_indices)
