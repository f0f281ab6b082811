"""Samplers, registered by the JAX package's scheduler names: the IDDPM
wrapper (DDIM and the ancestral loop), the DPM-Solver family, SA-Solver,
LCM and EDM; and the training losses with the timestep samplers (port of
`viditq_tpu/samplers/__init__.py`)."""

from viditq_tpu_torch.models.registry import SCHEDULERS, register
from viditq_tpu_torch.samplers.diffusion_losses import (  # noqa: F401
    LossSecondMomentResampler, UniformSampler,
    create_named_schedule_sampler, discretized_gaussian_log_likelihood,
    normal_kl, training_losses_full, vb_terms)
from viditq_tpu_torch.samplers.dpm_solver import (  # noqa: F401
    DPMSolver, DPMSolverSampler, NoiseScheduleVP, dpm_solver_pp_2m)
from viditq_tpu_torch.samplers.extra_solvers import (  # noqa: F401
    EDMSampler, LCMScheduler, SASolverSampler)
from viditq_tpu_torch.samplers.gaussian_diffusion import (  # noqa: F401
    Schedule, ddim_sample_loop, get_named_beta_schedule, make_schedule,
    p_sample_loop, space_timesteps, training_losses)
from viditq_tpu_torch.samplers.iddpm import (  # noqa: F401
    IDDPM, default_qctx_factory)
from viditq_tpu_torch.samplers.sa_solver import SASolver  # noqa: F401

register(SCHEDULERS, "iddpm")(IDDPM)
register(SCHEDULERS, "dpm-solver")(DPMSolverSampler)
register(SCHEDULERS, "sa-solver")(SASolverSampler)
register(SCHEDULERS, "lcm")(LCMScheduler)
register(SCHEDULERS, "edm")(EDMSampler)
