"""The diffusion training step (port of `viditq_tpu/parallel/training.py`),
on one device or over a `parallel.mesh.Mesh`.

The JAX step is a pure function of (params, ema, opt_state, batch, rng)
compiled over a mesh. Here the model owns its parameters: a step runs
the forward and backward, then updates the parameters (float32
`nn.Parameter`s, whatever the model's compute dtype), the EMA and the
optimizer state in place, and returns the loss as a device tensor (no
host read).

Over a mesh (`make_train_step(..., mesh=)`, the JAX step jitted with
`shardings_for_state` and `batch_sharding`, training.py:193-230): the
step takes the global batch on every rank and draws the global noise,
then each dp rank keeps its slice of both (`batch_sharding`), so dp = n
computes what dp = 1 does: the local gradients are averaged over dp, the
loss likewise. ZeRO: each AdamW moment whose first axis divides by dp
holds this rank's slice of it (`shardings_for_state`); the rank updates
that slice of the parameter and the slices are all-gathered (every other
moment, and its update, is whole on every rank). The clip norm is the
whole gradient's. tp: `tp_shard_` cuts the blocks' linears by the
Megatron rules (`parallel.mesh.param_sharding_rules`): q/k/v, fc1,
q_linear and kv_linear column-parallel, proj and fc2 row-parallel (their
partial products summed over tp, the bias added once), each rank H/tp
heads; the moments follow the local shard (JAX shards them over dp
alone: the same numbers). A quantized plan at tp > 1 raises. The sp axis
replicates: the `train` command's model carries no sp mesh (as in JAX,
ROADMAP C21), so its sp ranks compute the same step.

`Optimizer` is the optax chain the JAX package builds, in its order:
global-norm clipping as optax computes it (g * max_norm / ||g|| when
||g|| >= max_norm, no epsilon; off at infinity), then AdamW (b1 0.9, b2
0.999, eps 1e-8, decoupled weight decay) at the step's learning rate, a
linear warmup from 0 (the first step's rate is 0) or a constant. Its
state is {'count', 'mu', 'nu'} whatever the clipping and warmup, so a
checkpoint restores across those settings; the count is also the
schedule's. The draws: the noise of a step comes from a `torch.Generator`
or from `noise_fn(shape, micro)` (tests pin it to the JAX draws, which
threefry makes and torch cannot).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from viditq_tpu_torch.parallel import comm
from viditq_tpu_torch.parallel.mesh import (Mesh, batch_slice, gather_params,
                                            shard_params, tp_layout)
from viditq_tpu_torch.samplers.diffusion_losses import (
    LossSecondMomentResampler, training_losses_full)
from viditq_tpu_torch.samplers.gaussian_diffusion import (Schedule,
                                                          training_losses)

Params = Dict[str, nn.Parameter]
# optax.adamw's defaults, which the JAX package keeps (training.py:42)
B1, B2, EPS = 0.9, 0.999, 1e-8
# noise_fn(shape, micro) -> float32 noise of a (micro)batch's x0 shape
NoiseFn = Callable[[tuple, int], torch.Tensor]


def trainable(model: nn.Module) -> Params:
    """The model's parameters that take gradients, by name (the quant
    tables are buffers: frozen)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def init_ema(params) -> Dict[str, torch.Tensor]:
    """float32 copies of the parameters."""
    return {n: p.detach().float().clone() for n, p in params.items()}


def clip_by_global_norm_(grads, max_norm: float, norm=None) -> torch.Tensor:
    """optax.clip_by_global_norm on a list of tensors, in place: each g
    becomes g / ||g|| * max_norm when ||g|| >= max_norm (and stays g
    exactly otherwise). norm: ||g|| of the whole gradient when `grads` is
    a shard of it. Returns ||g|| (a device scalar)."""
    if norm is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip or inf), adamw(schedule,
    weight_decay)) (training.py:25-42): see the module docstring."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    warmup_steps: int = 0

    def learning_rate(self, count: int) -> float:
        """The schedule at step count (0 first), in float32 as optax
        evaluates it: linear_schedule(0, lr, warmup_steps), else the
        constant lr."""
        lr = np.float32(self.lr)
        if not self.warmup_steps:
            return float(lr)
        c = np.float32(min(count, self.warmup_steps))
        frac = np.float32(1) - c / np.float32(self.warmup_steps)
        return float(-lr * frac + lr)

    def init(self, params) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()},
                "nu": {n: torch.zeros_like(p, dtype=torch.float32)
                       for n, p in params.items()}}

    @torch.no_grad()
    def step(self, params: Params, state: dict, grads=None,
             norm=None) -> dict:
        """One update of params from their `.grad` (None reads as zeros,
        JAX's gradient of an unused parameter), or from `grads` by name;
        updates state in place and returns it. norm: the whole gradient's
        norm for the clip, where params and grads are shards."""
        names = list(params)
        p = [params[n] for n in names]
        if grads is not None:
            g = [grads[n] for n in names]
        else:
            g = [params[n].grad if params[n].grad is not None
                 else torch.zeros_like(params[n]) for n in names]
        if self.grad_clip:
            clip_by_global_norm_(g, self.grad_clip, norm)
        lr = self.learning_rate(state["count"])
        count = state["count"] + 1
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - B1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - B2))
        f32 = np.float32
        bc1 = float(f32(1) - f32(B1) ** f32(count))
        bc2 = float(f32(1) - f32(B2) ** f32(count))
        upd = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)
        state["count"] = count
        return state


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.0,
                   grad_clip: float = 0.0, warmup_steps: int = 0
                   ) -> Optimizer:
    """The JAX package's make_optimizer (HybridAdam as AdamW, train.py:
    150-156; grad_clip the reference's max_norm, 0 = off; warmup_steps 0 =
    a constant rate)."""
    return Optimizer(lr=lr, weight_decay=weight_decay, grad_clip=grad_clip,
                     warmup_steps=warmup_steps)


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], params,
               decay: float = 0.9999) -> Dict[str, torch.Tensor]:
    """e * decay + p * (1 - decay) in float32, in place (the reference
    train_utils.update_ema; JAX's formula, two roundings)."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, torch._foreach_mul(
        [params[n].detach().float() for n in names], 1 - decay))
    return ema


def _draw(shape, generator, micro: int, noise_fn: Optional[NoiseFn],
          device) -> torch.Tensor:
    if noise_fn is not None:
        return noise_fn(tuple(shape), micro).to(device)
    if generator is None:
        raise ValueError("the training step draws noise: pass a generator "
                         "(or build the step with noise_fn)")
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device).to(device)


def _split(batch: dict, n: int):
    """The batch as n microbatches of contiguous rows (JAX reshape to
    [n, B / n, ...]); an uneven split raises."""
    B = batch["x0"].shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by grad_accum {n}")
    m = B // n
    return [{k: None if v is None else v[i * m:(i + 1) * m]
             for k, v in batch.items()} for i in range(n)]


# ---------------- over a mesh ----------------

def zero_slice(shape, mesh: Optional[Mesh]) -> Optional[slice]:
    """This dp rank's rows of a ZeRO-sharded moment of `shape` (its first
    axis divides by dp > 1, training.py:209-213), else None (whole)."""
    dp = 1 if mesh is None else mesh.shape["dp"]
    if dp == 1 or not len(shape) or shape[0] % dp or shape[0] < dp:
        return None
    n = shape[0] // dp
    r = mesh.coord["dp"]
    return slice(r * n, (r + 1) * n)


def shardings_for_state(mesh: Mesh, params):
    """(tp layouts, moment slices) by parameter name: each parameter's
    `mesh.tp_layout` (None: replicated) and the ZeRO slice of its moments
    (None: whole) (training.py:193-220); params are this rank's."""
    return ({n: (tp_layout(n) if mesh.shape["tp"] > 1 else None)
             for n in params},
            {n: zero_slice(p.shape, mesh) for n, p in params.items()})


def batch_sharding(mesh: Mesh, batch: dict) -> dict:
    """This dp rank's rows of every batch entry (training.py:223-230)."""
    return {k: None if v is None else batch_slice(v, mesh)
            for k, v in batch.items()}


def init_state(optimizer: Optimizer, params, mesh: Optional[Mesh]) -> dict:
    """The optimizer state over a mesh: each moment this rank's ZeRO slice
    of its parameter (or the whole)."""
    def zeros(p):
        sl = zero_slice(p.shape, mesh)
        return torch.zeros_like(p if sl is None else p[sl],
                                dtype=torch.float32)
    return {"count": 0, "mu": {n: zeros(p) for n, p in params.items()},
            "nu": {n: zeros(p) for n, p in params.items()}}


def tp_shard_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The model cut to this rank's tp shard, in place: the blocks'
    linears by `mesh.shard_params` (their Parameters replaced), marked
    column- or row-parallel, and every attention and MLP of the blocks
    narrowed to this rank's heads and hidden channels. A quantized plan
    raises: only the fp step runs under tp."""
    from viditq_tpu_torch.models.layers import (CrossAttention,
                                                KVCompressSelfAttention,
                                                Mlp, SelfAttention)
    from viditq_tpu_torch.quant.qlinear import QuantLinear
    n = mesh.shape["tp"]
    if n == 1 or any(getattr(m, "tp_mode", None) is not None
                     for m in model.modules()):  # once
        return model
    for name, m in model.named_modules():
        if isinstance(m, QuantLinear) and m.path is not None:
            raise ValueError(
                f"{name}: a quantized plan under tensor parallelism (tp > "
                "1) is not ported (queue item 6, parallelism: tp runs the "
                "fp train step)")
    full = {k: p.detach() for k, p in model.named_parameters()}
    for k, t in shard_params(full, mesh).items():
        if t.shape != full[k].shape:
            mname, _, leaf = k.rpartition(".")
            mod = model.get_submodule(mname)
            old = getattr(mod, leaf)
            setattr(mod, leaf, nn.Parameter(
                t.contiguous(), requires_grad=old.requires_grad))
    group = mesh.group("tp")
    for name, m in model.named_modules():
        if not name.startswith("blocks."):
            continue
        if isinstance(m, QuantLinear):
            lay = tp_layout(name + ".kernel")
            if lay is not None:
                m.tp_mode = "row" if lay[1] == "row" else "col"
                m.tp_group = group
                m.in_features, m.features = m.kernel.shape
        elif isinstance(m, (SelfAttention, CrossAttention)):
            if m.num_heads % n:
                raise ValueError(f"{name}: heads {m.num_heads} not "
                                 f"divisible by tp={n}")
            m.num_heads //= n
        elif isinstance(m, Mlp):
            m.hidden_features //= n
        elif isinstance(m, KVCompressSelfAttention):
            raise ValueError(f"{name}: KV-compressed attention under tp")
    return model


@torch.no_grad()
def mesh_update(optimizer: Optimizer, params: Params, state: dict,
                mesh: Mesh) -> None:
    """One optimizer update over a mesh from the parameters' `.grad`
    (already averaged over dp): the clip norm over the whole gradient (tp
    shards' squares summed over tp), each ZeRO-sliced parameter updated
    in its slice and all-gathered over dp."""
    layouts, slices = shardings_for_state(mesh, params)
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    norm = None
    if optimizer.grad_clip:
        dev = next(iter(params.values())).device
        sq_tp = torch.zeros((), device=dev)
        sq = torch.zeros((), device=dev)
        for n, g in grads.items():
            if layouts[n] is not None:
                sq_tp += g.float().square().sum()
            else:
                sq += g.float().square().sum()
        norm = (comm.all_reduce_(sq_tp, mesh.group("tp")) + sq).sqrt()
    views = {n: p.data if slices[n] is None else p.data[slices[n]]
             for n, p in params.items()}
    gviews = {n: g if slices[n] is None else g[slices[n]]
              for n, g in grads.items()}
    optimizer.step(views, state, grads=gviews, norm=norm)
    dp_group = mesh.group("dp")
    for n, p in params.items():
        if slices[n] is not None:
            p.data.copy_(comm.all_gather(views[n].clone(), dp_group, 0))


def gather_state(params, ema, opt_state, mesh: Mesh):
    """(params, ema, opt_state) whole on every rank, as one process holds
    them: ZeRO slices all-gathered over dp, tp shards over tp (every rank
    must call it)."""
    def whole_moments(d):
        out = {}
        for n, t in d.items():
            if zero_slice(params[n].shape, mesh) is not None:
                t = comm.all_gather(t, mesh.group("dp"), 0)
            out[n] = t
        return gather_params(out, mesh)
    p = gather_params({n: v.detach() for n, v in params.items()}, mesh)
    return (p, gather_params(ema, mesh),
            {"count": opt_state["count"], "mu": whole_moments(
                opt_state["mu"]), "nu": whole_moments(opt_state["nu"])})


def shard_state(ema, opt_state, mesh: Mesh):
    """A whole (ema, opt_state) cut to this rank's: tp shards, then the
    moments' ZeRO slices (the inverse of `gather_state`)."""
    def moments(d):
        out = {}
        for n, t in shard_params(d, mesh).items():
            sl = zero_slice(t.shape, mesh)
            out[n] = t if sl is None else t[sl].clone()
        return out
    return (shard_params(ema, mesh),
            {"count": opt_state["count"], "mu": moments(opt_state["mu"]),
             "nu": moments(opt_state["nu"])})


def make_train_step(model: nn.Module, schedule: Schedule,
                    optimizer: Optimizer, in_channels: int = 4,
                    ema_decay: float = 0.9999, loss_type: str = "mse",
                    schedule_sampler: Optional[str] = None,
                    grad_accum: int = 1,
                    noise_fn: Optional[NoiseFn] = None,
                    mesh: Optional[Mesh] = None):
    """train_step(ema, opt_state, batch, generator) -> loss (training.py:
    51-158): batch {'x0': [B, C, ...], 't': [B] spaced-step ids, 'y',
    'mask' (or None)} on the model's device.

    loss_type 'mse' with no schedule sampler takes the MSE fast path
    (`training_losses`); the other types (and 'uniform') the per-sample
    `training_losses_full`, whose vb term trains the variance head.
    grad_accum: the batch as that many microbatches (contiguous rows),
    their gradients summed and divided by grad_accum before one update, the
    loss likewise; each microbatch draws its own noise. schedule_sampler
    'loss-second-moment' returns train_step(ema, opt_state, batch,
    generator, sampler_state) -> (loss, sampler_state): t importance-drawn
    from the state (then the noise, from the same generator), the
    per-sample losses weighted by 1 / (T p), the state updated with them;
    `train_step.init_sampler_state(device)` is its initial state.

    mesh: the step over a mesh (module docstring): the batch is the global
    one on every rank, the model already `tp_shard_`ed, the optimizer
    state from `init_state`; the loss returned is the global batch's."""
    if schedule_sampler not in (None, "uniform", "loss-second-moment"):
        raise NotImplementedError(
            f"unknown schedule sampler: {schedule_sampler}")
    if mesh is not None and schedule_sampler == "loss-second-moment":
        raise NotImplementedError("loss-second-moment sampling over a mesh")
    if mesh is not None and mesh.shape["pp"] > 1:
        raise ValueError("a pp axis trains through "
                         "parallel/pipeline.make_pp_train_step")
    params = trainable(model)
    dp = 1 if mesh is None else mesh.shape["dp"]

    def per_sample_loss(batch, t, noise):
        def model_fn(x_t, tt):
            return model(x_t, tt, batch["y"], batch.get("mask"))
        if loss_type == "mse" and schedule_sampler is None:
            return training_losses(model_fn, batch["x0"], t, noise,
                                   schedule, in_channels)
        return training_losses_full(model_fn, batch["x0"], t, noise,
                                    schedule, loss_type,
                                    in_channels)["loss"]

    def apply_update(ema, opt_state):
        if mesh is None:
            optimizer.step(params, opt_state)
        else:
            mesh_update(optimizer, params, opt_state, mesh)
        for p in params.values():
            p.grad = None
        update_ema(ema, params, ema_decay)

    if schedule_sampler == "loss-second-moment":
        if grad_accum != 1:
            raise ValueError("grad_accum is not supported with "
                             "loss-second-moment sampling")
        resampler = LossSecondMomentResampler(schedule.n_steps)

        def train_step_ls(ema, opt_state, batch, generator, sampler_state):
            x0 = batch["x0"]
            t, w = resampler.sample(sampler_state, generator, x0.shape[0])
            t, w = t.to(x0.device), w.to(x0.device)
            noise = _draw(x0.shape, generator, 0, noise_fn, x0.device)
            losses = per_sample_loss(batch, t, noise)
            loss = torch.mean(w * losses)
            loss.backward()
            sampler_state = resampler.update(sampler_state, t,
                                             losses.detach())
            apply_update(ema, opt_state)
            return loss.detach(), sampler_state

        train_step_ls.init_sampler_state = resampler.init
        return train_step_ls

    def train_step(ema, opt_state, batch, generator=None):
        micro = _split(batch, grad_accum) if grad_accum > 1 else [batch]
        loss_sum = None
        for i, mb in enumerate(micro):
            # the global (micro)batch's noise, then this dp rank's rows
            noise = _draw(mb["x0"].shape, generator, i, noise_fn,
                          mb["x0"].device)
            if dp > 1:
                mb, noise = batch_sharding(mesh, mb), batch_slice(noise,
                                                                  mesh)
            loss = torch.mean(per_sample_loss(mb, mb["t"], noise))
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        if grad_accum > 1:
            with torch.no_grad():
                for p in params.values():
                    if p.grad is not None:
                        p.grad.div_(grad_accum)
            loss_sum = loss_sum / grad_accum
        if dp > 1:  # the local means' mean: the global batch's
            with torch.no_grad():
                group = mesh.group("dp")
                for p in params.values():
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    comm.all_reduce_(p.grad, group).div_(dp)
                loss_sum = comm.all_reduce_(loss_sum.clone(), group) / dp
        apply_update(ema, opt_state)
        return loss_sum

    return train_step


def make_qat_step(model: nn.Module, schedule: Schedule,
                  optimizer: Optimizer, qctx, in_channels: int = 4,
                  ema_decay: float = 0.9999,
                  noise_fn: Optional[NoiseFn] = None):
    """Quantization-aware training (training.py:161-192, the reference
    CLI's `qat` mode): qat_step(ema, opt_state, batch, generator) -> loss
    with the forward through the model's fake quantizers under qctx (the
    simulate path; 'nearest_ste' rounding passes the gradient straight
    through, `quant/core.round_ste`), the calibrated quant tables frozen
    (buffers) and the weights updated in full precision."""
    params = trainable(model)

    def qat_step(ema, opt_state, batch, generator=None):
        x0 = batch["x0"]
        noise = _draw(x0.shape, generator, 0, noise_fn, x0.device)

        def model_fn(x_t, t):
            return model(x_t, t, batch["y"], batch.get("mask"), qctx)
        loss = training_losses(model_fn, x0, batch["t"], noise, schedule,
                               in_channels)
        loss.backward()
        optimizer.step(params, opt_state)
        for p in params.values():
            p.grad = None
        update_ema(ema, params, ema_decay)
        return loss.detach()

    return qat_step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on device seeded by (seed, step): the port's fold_in,
    so step i draws the same whether or not the run resumed before it."""
    s = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(s[0]) << 31) ^ int(s[1]))
