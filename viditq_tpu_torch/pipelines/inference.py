"""Sampling pipelines: fp baseline and quantized inference (port of
`viditq_tpu/pipelines/inference.py:30-81`, without jit: PyTorch runs the
loop eagerly). The model carries its own weights and quant tables, so the
JAX functions' `variables` argument has no counterpart. Both drive the
IDDPM (DDIM) and the DPM-Solver samplers; only the DDIM loop takes
`step_indices`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from viditq_tpu_torch.samplers.iddpm import default_qctx_factory


@torch.no_grad()
def fp_sample(model, sampler, z, y, mask=None,
              step_indices: Optional[Sequence[int]] = None):
    """fp/bf16 baseline generation (reference inference.py)."""
    return sampler.sample(model, z, y, mask, **_steps(step_indices))


@torch.no_grad()
def quant_sample(model, sampler, z, y, mask=None,
                 step_indices: Optional[Sequence[int]] = None):
    """Quantized inference (reference quant_txt2video.py:29-237): every
    forward gets a QuantCtx in 'quant' mode for its timestep."""
    return sampler.sample(model, z, y, mask,
                          qctx_factory=default_qctx_factory("quant"),
                          **_steps(step_indices))


def _steps(step_indices):
    return {} if step_indices is None else {"step_indices": step_indices}
