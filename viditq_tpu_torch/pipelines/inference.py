"""Sampling pipelines: fp baseline, calibration-trajectory capture and
quantized inference (port of `viditq_tpu/pipelines/inference.py:30-81`,
without jit: PyTorch runs the loop eagerly). The model carries its own
weights and quant tables, so the JAX functions' `variables` argument has
no counterpart. Each drives the IDDPM (DDIM) and the DPM-Solver samplers;
only the DDIM loop takes `step_indices`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from viditq_tpu_torch.samplers.iddpm import default_qctx_factory


@torch.no_grad()
def fp_sample(model, sampler, z, y, mask=None,
              step_indices: Optional[Sequence[int]] = None):
    """fp/bf16 baseline generation (reference inference.py)."""
    return sampler.sample(model, z, y, mask, **_steps(step_indices))


@torch.no_grad()
def get_calib_data(model, sampler, z, y, mask=None) -> Dict:
    """fp sampling with trajectory capture -> calib data {samples, xs, ts,
    y, mask} (reference get_calib_data.py:24-145; JAX inference.py:
    43-63): xs [n_steps, 2n, ...] and ts [n_steps, 2n] in the [cond; null]
    layout the PTQ forwards take (a DPM-Solver trajectory, one batch, is
    doubled)."""
    samples, traj = sampler.sample(model, z, y, mask,
                                   return_trajectory=True)
    xs, ts = traj["xs"], traj["ts"]
    if xs.shape[1] == z.shape[0]:
        xs = torch.cat([xs, xs], dim=1)
        ts = torch.cat([ts, ts], dim=1)
    return {"samples": samples, "xs": xs, "ts": ts, "y": y, "mask": mask}


@torch.no_grad()
def quant_sample(model, sampler, z, y, mask=None,
                 step_indices: Optional[Sequence[int]] = None,
                 act_slot_map: Optional[Sequence[int]] = None):
    """Quantized inference (reference quant_txt2video.py:29-237): every
    forward gets a 'quant' QuantCtx for its timestep and, under a
    static-act plan, its table slot (`act_slot_map`, from `run_ptq`)."""
    return sampler.sample(model, z, y, mask,
                          qctx_factory=default_qctx_factory(
                              "quant", act_slot_map=act_slot_map),
                          **_steps(step_indices))


def _steps(step_indices):
    return {} if step_indices is None else {"step_indices": step_indices}
