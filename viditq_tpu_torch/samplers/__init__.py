"""Samplers: the DDIM loop with the IDDPM CFG wrapper and multistep
DPM-Solver, registered by the JAX package's scheduler names."""

from viditq_tpu_torch.models.registry import SCHEDULERS, register
from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
from viditq_tpu_torch.samplers.iddpm import IDDPM

register(SCHEDULERS, "iddpm")(IDDPM)
register(SCHEDULERS, "dpm-solver")(DPMSolverSampler)
