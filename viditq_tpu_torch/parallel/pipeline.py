"""GPipe pipeline parallelism over the block stack (port of
`viditq_tpu/parallel/pipeline.py`).

Each rank of the pp axis holds depth/S contiguous blocks of the model's
unrolled `blocks` (`stage_range`; the JAX package shards the scanned
stack's leading axis instead, pipeline.py:28-32). The embed and final
parts run on every rank through the model's `stage='embed'`/`'final'`
(models/stdit.py, models/pixart.py). Microbatches stream stage to stage
by send/recv: stage s takes microbatch m from stage s - 1 once that stage
is done with it, which is JAX's tick schedule (tick t runs microbatch
t - s on stage s, M + S - 1 ticks, pipeline.py:62-87) without the idle
ticks spelled out. The last stage's outputs reach every rank by a
broadcast (JAX: a masked psum, :92-94). The tpe enters block 0 only
(:140-141).

Gradients (`make_pp_train_step`, GPipe training, :217-250): the forward
keeps each microbatch's stage input and output; after the loss's backward
has reached the broadcast outputs, `PipelinedModel.finish_backward` runs
the stages backward in turn, each receiving its outputs' cotangent from
the next stage and sending its inputs' cotangent to the one before
(JAX's ppermute transposes), then sums the embed outputs' cotangents over
the stages and runs the embed backward on every rank, so the embed and
final parameters' gradients are whole and alike on every rank and each
block's sits on the rank that holds it. Each rank updates the parameters
it holds (the blocks' stay pp-sharded, as in JAX); `gather_stages`
brings every block to every rank.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from viditq_tpu_torch.models.layers import call_block
from viditq_tpu_torch.parallel import comm
from viditq_tpu_torch.parallel.mesh import Mesh


def stage_range(depth: int, mesh: Mesh) -> range:
    """The blocks this rank's stage holds."""
    S = mesh.shape["pp"]
    if depth % S:
        raise ValueError(f"depth {depth} must divide the pp axis size {S}")
    per = depth // S
    s = mesh.coord["pp"]
    return range(s * per, (s + 1) * per)


def _microbatch(t: Optional[torch.Tensor], n_mb: int):
    if t is None:
        return [None] * n_mb
    if t.shape[0] % n_mb:
        raise ValueError(f"batch {t.shape[0]} not divisible by {n_mb} "
                         f"microbatches")
    return list(t.chunk(n_mb))


class Pipeline:
    """One pipelined pass over a mesh's pp axis (JAX `pipeline_apply`,
    pipeline.py:35-97): `forward` then, under autograd, `backward` with
    the outputs' cotangent."""

    def __init__(self, mesh: Mesh):
        self.S, self.sid = mesh.shape["pp"], mesh.coord["pp"]
        self.group, self.ranks = mesh.group("pp"), list(mesh.ranks["pp"])
        self.records = []

    def forward(self, block_step: Callable, indices, x_mb: List,
                extras_mb: List[Dict]) -> torch.Tensor:
        """block_step(i, x, extras) -> x runs block i (global index) of this
        stage on one microbatch. x_mb: the M microbatches (used on stage
        0); extras_mb: each microbatch's context. Returns the stack's
        output for the whole batch on every rank."""
        grad = torch.is_grad_enabled()
        last = self.S - 1
        outs = []
        for m, x0 in enumerate(x_mb):
            if self.sid == 0:
                x = x0
            else:
                x = comm.recv(x0.shape, x0.dtype, x0.device,
                              self.ranks[self.sid - 1], self.group, tag=m)
                if grad:
                    x.requires_grad_()
            y = x
            for i in indices:
                y = block_step(i, y, extras_mb[m])
            if self.sid < last:
                comm.send(y.detach(), self.ranks[self.sid + 1], self.group,
                          tag=m)
            if grad:
                self.records.append((x, y))
            outs.append(y.detach())
        x0 = x_mb[0]
        out = (torch.cat(outs) if self.sid == last else torch.empty(
            (len(x_mb) * x0.shape[0],) + tuple(x0.shape[1:]),
            dtype=x0.dtype, device=x0.device))
        return comm.broadcast_(out, self.ranks[last], self.group)

    def backward(self, grad_out: torch.Tensor) -> None:
        """The stages backward: grad_out is the cotangent of `forward`'s
        output, alike on every rank (the replicated head's)."""
        M = len(self.records)
        g_mb = grad_out.chunk(M)
        for m, (x, y) in enumerate(self.records):
            if self.sid == self.S - 1:
                g = g_mb[m]
            else:
                g = comm.recv(y.shape, y.dtype, y.device,
                              self.ranks[self.sid + 1], self.group,
                              tag=M + m)
            if y.requires_grad:
                torch.autograd.backward(y, g)
            if self.sid > 0:
                gx = (x.grad if x.grad is not None
                      else torch.zeros_like(x))
                comm.send(gx, self.ranks[self.sid - 1], self.group,
                          tag=M + m)
        self.records = []


class PipelinedModel:
    """model_fn(x, timestep, y, mask, qctx) of STDiT or PixArt with the
    block stack pipelined over the mesh's pp axis in n_microbatches
    microbatches; the samplers' and the losses' model function, and the
    port of JAX's `stdit_pipeline_forward` and `pixart_pipeline_forward`
    (pipeline.py:115-214, the whole output on every rank; PixArt's
    KV-compress stacks refused). Under autograd, call `finish_backward()`
    after the loss's backward."""

    def __init__(self, model, mesh: Mesh, n_microbatches: int,
                 data_info=None):
        from viditq_tpu_torch.models.pixart import PixArt
        self.model, self.mesh = model, mesh
        self.M = n_microbatches
        self.pixart = isinstance(model, PixArt)
        self.data_info = data_info
        if self.pixart:
            layers = set(model.kv_compress_layers)
            if layers and model.kv_compress_scale > 1:
                if layers >= set(range(model.depth)):
                    # a full-stack KV compress is uniform, but its blocks
                    # carry sr convs (pipeline.py:174-179)
                    raise ValueError("pipeline does not support KV-compress "
                                     "stacks")
                raise ValueError(
                    "pipeline needs a uniform block stack; this model has "
                    "a non-uniform stack (Σ KV-compress runs)")
        self.indices = stage_range(len(model.blocks), mesh)
        self.pending = None

    def _stage(self, stage, x, timestep, y, mask, qctx, x_tokens=None):
        kw = dict(stage=stage, x_tokens=x_tokens)
        if self.pixart:
            kw["data_info"] = self.data_info
        return self.model(x, timestep, y, mask, qctx, **kw)

    def __call__(self, x, timestep, y, mask=None, qctx=None):
        model = self.model
        emb = self._stage("embed", x, timestep, y, mask, qctx)
        xt, t0, y2, mask2, aux = emb
        grad = torch.is_grad_enabled()
        outs = (xt, t0, y2)
        if grad:
            outs = tuple(t.detach().requires_grad_() for t in outs)
        x_mb, t0_mb, y_mb = (_microbatch(t, self.M) for t in outs)
        mask_mb = _microbatch(mask2, self.M)
        extras = [{"t0": a, "y": b, "mask": c}
                  for a, b, c in zip(t0_mb, y_mb, mask_mb)]
        blocks, gc = model.blocks, model.grad_checkpoint

        if self.pixart:
            def step(i, h, e):
                return call_block(blocks[i], gc, h, e["y"], e["t0"],
                                  e["mask"], aux, qctx)
        else:
            def step(i, h, e):
                return call_block(blocks[i], gc, h, e["y"], e["t0"],
                                  e["mask"], aux if i == 0 else None, qctx)
        pipe = Pipeline(self.mesh)
        out = pipe.forward(step, self.indices, x_mb, extras)
        if grad:
            out.requires_grad_()
            self.pending = (pipe, (xt, t0, y2), outs, out)
        return self._stage("final", x, timestep, y, mask, qctx,
                           x_tokens=out)

    def finish_backward(self) -> None:
        """The pipeline's and the embed's backward, after the loss's has
        given the stack's output its cotangent."""
        pipe, embeds, leaves, out = self.pending
        self.pending = None
        g_out = (out.grad if out.grad is not None
                 else torch.zeros_like(out))
        pipe.backward(g_out)
        group, ranks = self.mesh.group("pp"), self.mesh.ranks["pp"]
        grads = []
        for k, leaf in enumerate(leaves):
            g = (leaf.grad if leaf.grad is not None
                 else torch.zeros_like(leaf))
            if k == 0:  # the stack's input: stage 0's alone
                comm.broadcast_(g, ranks[0], group)
            else:  # t0 and y: every stage's blocks read them
                comm.all_reduce_(g, group)
            grads.append(g)
        pairs = [(t, g) for t, g in zip(embeds, grads) if t.requires_grad]
        if pairs:
            torch.autograd.backward([t for t, _ in pairs],
                                    [g for _, g in pairs])


def holds(name: str, mesh: Mesh, depth: int) -> bool:
    """Whether this rank's stage holds parameter `name` (every parameter
    outside the block stack is held by all)."""
    if not name.startswith("blocks."):
        return True
    return int(name.split(".")[1]) in stage_range(depth, mesh)


def stage_params(model, mesh: Mesh) -> Dict:
    """The trainable parameters this rank's stage holds, by name."""
    from viditq_tpu_torch.parallel.training import trainable
    depth = len(model.blocks)
    return {n: p for n, p in trainable(model).items()
            if holds(n, mesh, depth)}


@torch.no_grad()
def gather_stages(tensors: Dict[str, torch.Tensor], mesh: Mesh, depth: int
                  ) -> None:
    """Every block's tensors (parameters or EMA, by name) broadcast from
    the stage that holds them, in place."""
    per = depth // mesh.shape["pp"]
    group, ranks = mesh.group("pp"), mesh.ranks["pp"]
    for name in sorted(tensors):
        if name.startswith("blocks."):
            owner = int(name.split(".")[1]) // per
            comm.broadcast_(tensors[name], ranks[owner], group)


def make_pp_train_step(model, schedule, optimizer, *, mesh: Mesh,
                       n_microbatches: int, in_channels: int = 4,
                       ema_decay: float = 0.9999, noise_fn=None):
    """GPipe training (pipeline.py:217-250): train_step(ema, opt_state,
    batch, generator) -> loss, the diffusion MSE loss through the
    pipelined forward, one optimizer update and EMA a batch, each over
    the parameters this stage holds (`stage_params`: build the EMA and the
    optimizer state from it). The clip norm is the whole gradient's: the
    held blocks' squares summed over the stages, the rest counted once."""
    from viditq_tpu_torch.parallel.training import _draw, update_ema
    from viditq_tpu_torch.samplers.gaussian_diffusion import training_losses
    params = stage_params(model, mesh)
    group = mesh.group("pp")

    def train_step(ema, opt_state, batch, generator=None):
        x0 = batch["x0"]
        noise = _draw(x0.shape, generator, 0, noise_fn, x0.device)
        fwd = PipelinedModel(model, mesh, n_microbatches)
        loss = training_losses(
            lambda x_t, tt: fwd(x_t, tt, batch["y"], batch.get("mask")),
            x0, batch["t"], noise, schedule, in_channels)
        loss.backward()
        fwd.finish_backward()
        norm = None
        if optimizer.grad_clip:
            sq = {True: torch.zeros((), device=x0.device),
                  False: torch.zeros((), device=x0.device)}
            for n, p in params.items():
                if p.grad is not None:
                    sq[n.startswith("blocks.")] += p.grad.float().square(
                    ).sum()
            norm = (comm.all_reduce_(sq[True], group) + sq[False]).sqrt()
        optimizer.step(params, opt_state, norm=norm)
        for p in params.values():
            p.grad = None
        update_ema(ema, params, ema_decay)
        return loss.detach()

    return train_step
