"""Sampling pipelines: fp baseline, calibration-trajectory capture and
quantized inference (port of `viditq_tpu/pipelines/inference.py:30-81`,
without jit: PyTorch runs the loop eagerly). The model carries its own
weights and quant tables, so the JAX functions' `variables` argument has
no counterpart. Each drives every sampler of `samplers/`: `sampler_type`
('ddim' or 'iddpm') reaches the IDDPM wrapper only (a sampler with a
`schedule`, as in JAX), `generator`, where given, every sampler (the
stochastic ones draw from it), and only the DDIM loop takes
`step_indices`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from viditq_tpu_torch.samplers.iddpm import default_qctx_factory


def _kwargs(sampler, sampler_type, generator, step_indices=None, **kw):
    if hasattr(sampler, "schedule"):
        kw["sampler_type"] = sampler_type
    if step_indices is not None:
        kw["step_indices"] = step_indices
    if generator is not None:
        kw["generator"] = generator
    return kw


@torch.no_grad()
def fp_sample(model, sampler, z, y, mask=None,
              step_indices: Optional[Sequence[int]] = None,
              sampler_type: str = "ddim",
              generator: Optional[torch.Generator] = None):
    """fp/bf16 baseline generation (reference inference.py)."""
    return sampler.sample(model, z, y, mask, **_kwargs(
        sampler, sampler_type, generator, step_indices))


@torch.no_grad()
def get_calib_data(model, sampler, z, y, mask=None,
                   sampler_type: str = "ddim",
                   generator: Optional[torch.Generator] = None) -> Dict:
    """fp sampling with trajectory capture -> calib data {samples, xs, ts,
    y, mask} (reference get_calib_data.py:24-145; JAX inference.py:
    43-63): xs [n_steps, 2n, ...] and ts [n_steps, 2n] in the [cond; null]
    layout the PTQ forwards take (a one-batch trajectory, of the solvers
    and LCM, is doubled)."""
    samples, traj = sampler.sample(model, z, y, mask, **_kwargs(
        sampler, sampler_type, generator, return_trajectory=True))
    xs, ts = traj["xs"], traj["ts"]
    if xs.shape[1] == z.shape[0]:
        xs = torch.cat([xs, xs], dim=1)
        ts = torch.cat([ts, ts], dim=1)
    return {"samples": samples, "xs": xs, "ts": ts, "y": y, "mask": mask}


@torch.no_grad()
def quant_sample(model, sampler, z, y, mask=None,
                 step_indices: Optional[Sequence[int]] = None,
                 act_slot_map: Optional[Sequence[int]] = None,
                 sampler_type: str = "ddim",
                 generator: Optional[torch.Generator] = None,
                 mesh=None):
    """Quantized inference (reference quant_txt2video.py:29-237): every
    forward gets a 'quant' QuantCtx for its timestep and, under a
    static-act plan, its table slot (`act_slot_map`, from `run_ptq`).

    mesh: a `parallel.mesh.Mesh` whose dp axis shards the batch, as the
    JAX package's sampling jitted with z, y and mask sharded over dp
    (tests/test_parallel_inference.py:30). Each dp rank samples its rows
    of z, of y's cond and null halves and of mask; a dynamic act statistic
    that pools batch rows pools every dp rank's (`quant.core.pooled_over`),
    as GSPMD keeps the global batch; the samples are gathered, so every
    rank returns the whole batch. The other axes replicate. A generator
    is refused there: a rank would draw its slice's noise, not the global
    batch's."""
    kw = _kwargs(sampler, sampler_type, generator, step_indices,
                 qctx_factory=default_qctx_factory(
                     "quant", act_slot_map=act_slot_map))
    if mesh is None or mesh.shape["dp"] == 1:
        return sampler.sample(model, z, y, mask, **kw)
    from viditq_tpu_torch.parallel.mesh import batch_slice, gather_batch
    from viditq_tpu_torch.quant.core import pooled_over
    if generator is not None:
        raise ValueError("batch-sharded sampling draws no noise: run a "
                         "deterministic sampler without a generator")

    def rows(t):  # a [cond; null] tensor by halves
        if t is None or t.shape[0] == z.shape[0]:
            return batch_slice(t, mesh)
        return torch.cat([batch_slice(h, mesh) for h in t.chunk(2)])
    with pooled_over(mesh.group("dp")):
        out = sampler.sample(model, batch_slice(z, mesh), rows(y),
                             rows(mask), **kw)
    return gather_batch(out, mesh)
