"""Training entry (port of `viditq_tpu/pipelines/train.py`; reference
`t2v/scripts/train.py`): diffusion MSE training with EMA, gradient
accumulation and clipping, LR warmup, full-state checkpoints, and
mid-epoch resume through `StatefulSampler`.

`train_loop` drives the steps (the reference's boosted loop body,
train.py:185-276) on synthetic batches or a batch iterator;
`train_entry` is the epoch-structured outer loop over a map-style
dataset with the resumable sampler; `make_encode_batch` maps raw items to
train batches. The model trains as built: `build_model` returns it in
eval mode, and neither package has dropout or caption dropout, so
`train()` would change nothing. The draws: step i's synthetic batch and
its noise come from generators seeded by (seed, i) and (seed, 10000 + i)
(`parallel/training.step_generator`, the JAX package's fold_in of the
step, :65-75, :144), so a resumed run draws what the uninterrupted one
drew; the draws are torch's, not threefry's. The running loss stays on
the device and is read on the host at log steps only. `mesh` (a
`parallel.mesh.Mesh`, train.py:104-127): the model is cut to this rank's
tp shard, the state and each global batch are sharded as
`parallel/training.py` describes, and the checkpoints are one whole state
written by rank 0 (gathered from every rank), which resumes at any world
size. `make_encode_batch(vae=...)` encodes pixel batches to latents inside
the loop. Not ported: the orbax format.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from viditq_tpu_torch.parallel.training import (
    gather_state, init_ema, init_state, make_optimizer, make_train_step,
    shard_state, step_generator, tp_shard_, trainable)
from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
from viditq_tpu_torch.utils import ckpt as ckpt_utils


def _log_jsonl(save_dir: str, rec: Dict):
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, "train_log.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _on_device(batch: Dict, device) -> Dict:
    """A batch's arrays as tensors on device (lists of strings kept)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def synthetic_batch(i: int, seed: int, batch: int, latent_shape,
                    caption_shape, n_steps: int, device) -> Dict:
    """Step i's synthetic batch: x0 and y N(0, 1) in float32, t uniform
    over n_steps, an all-ones mask (train.py:65-75)."""
    g = step_generator(seed, i, device)
    return {
        "x0": torch.randn((batch, *latent_shape), generator=g,
                          device=device),
        "t": torch.randint(0, n_steps, (batch,), generator=g,
                           device=device),
        "y": torch.randn((batch, *caption_shape), generator=g,
                         device=device),
        "mask": torch.ones((batch, caption_shape[-2]), dtype=torch.int32,
                           device=device)}


def train_loop(model, dataset_iter, *, latent_shape, caption_shape,
               num_steps: int = 100, lr: float = 1e-4,
               ema_decay: float = 0.9999, ckpt_every: int = 0,
               save_dir: str = "outputs/train", log_every: int = 10,
               seed: int = 0, resume_ema: Optional[Dict] = None,
               resume_opt_state=None, resume_from: Optional[str] = None,
               use_meta_counters: bool = True, grad_accum: int = 1,
               grad_clip: float = 0.0, warmup_steps: int = 0,
               loss_type: str = "mse", start_step: int = 0, epoch: int = 0,
               sampler=None, consumed_items: int = 0,
               on_step_end: Optional[Callable[[int], None]] = None,
               mesh=None):
    """Train `model` (its parameters in place) for steps start_step ..
    num_steps - 1. dataset_iter yields {'x0', 't', 'y', 'mask'} batches
    (numpy or tensors), or None for synthetic batches of 2 * grad_accum
    rows; a real iterator is already at the resume point.

    resume_from: a `save_train_state` file: the parameters, EMA and
    optimizer state, and with use_meta_counters the step and epoch of its
    meta. resume_ema / resume_opt_state carry those over from a previous
    call (train_entry's next epoch; the parameters are the model's).
    ckpt_every: write `train_state_<global step>.pt` with the meta
    {'epoch', 'step', 'global_step', 'sampler'} (consumed_items: the
    dataset items drawn from `sampler` before this call). Returns
    {'params', 'ema', 'opt_state', 'losses' (the logged averages),
    'step_losses' (each step's loss, a device tensor), 'meta',
    'ckpt' (the last checkpoint written, or None), 'ckpt_seconds' ({step
    index: the host seconds its checkpoint write took})}. Over a mesh the
    parameters, EMA and optimizer state returned are this rank's shards
    (`parallel/training.gather_state` joins them) and the losses the
    global batch's; rank 0 alone logs and writes."""
    device = next(model.parameters()).device
    schedule = make_schedule(num_sampling_steps=None,
                             timestep_respacing=[1000])
    lead = mesh is None or not dist.is_initialized() or dist.get_rank() == 0
    optimizer = make_optimizer(lr=lr, grad_clip=grad_clip,
                               warmup_steps=warmup_steps)
    meta = {}
    if resume_from:  # one whole state, whatever the world size
        p_saved, ema, opt_state, meta = ckpt_utils.load_train_state(
            resume_from, device)
        with torch.no_grad():
            for n, p in trainable(model).items():
                p.copy_(p_saved[n])
        if use_meta_counters:
            start_step = int(meta.get("step", start_step))
            epoch = int(meta.get("epoch", epoch))
    if mesh is not None:
        tp_shard_(model, mesh)
    params = trainable(model)
    if resume_from:
        if mesh is not None:
            ema, opt_state = shard_state(ema, opt_state, mesh)
    else:
        opt_state = (resume_opt_state if resume_opt_state is not None
                     else init_state(optimizer, params, mesh))
        ema = resume_ema if resume_ema is not None else init_ema(params)
    step_fn = make_train_step(model, schedule, optimizer,
                              ema_decay=ema_decay, loss_type=loss_type,
                              grad_accum=grad_accum, mesh=mesh)

    def synth(i):
        return synthetic_batch(i, seed, 2 * grad_accum, latent_shape,
                               caption_shape, schedule.n_steps, device)

    losses, step_losses, last_ckpt, ckpt_seconds = [], [], None, {}
    running_loss = torch.zeros((), device=device)  # no per-step host read
    log_count = 0
    items_per_step = None
    t_start = time.time()
    for i in range(start_step, num_steps):
        batch = (synth(i) if dataset_iter is None
                 else _on_device(next(dataset_iter), device))
        items_per_step = int(batch["x0"].shape[0])
        loss = step_fn(ema, opt_state, batch,
                       step_generator(seed, 10_000 + i, device))
        step_losses.append(loss)
        running_loss = running_loss + loss
        log_count += 1
        if (log_every and (i + 1) % log_every == 0) or i == num_steps - 1:
            avg = float(running_loss) / max(log_count, 1)
            rate = (i + 1 - start_step) / max(time.time() - t_start, 1e-9)
            losses.append(avg)
            if lead:
                _log_jsonl(save_dir, {"step": i + 1, "epoch": epoch,
                                      "loss": float(loss), "avg_loss": avg,
                                      "it_per_s": rate})
                print(f"step {i+1}/{num_steps} loss {float(loss):.4f} "
                      f"avg {avg:.4f} ({rate:.2f} it/s)", flush=True)
            running_loss, log_count = torch.zeros((), device=device), 0
        if ckpt_every and (i + 1) % ckpt_every == 0:
            os.makedirs(save_dir, exist_ok=True)
            global_step = epoch * num_steps + i + 1
            smeta = {"epoch": epoch, "step": i + 1,
                     "global_step": global_step}
            if sampler is not None:
                smeta["sampler"] = sampler.state_dict(
                    consumed_items + (i + 1 - start_step) * items_per_step)
            last_ckpt = os.path.join(save_dir,
                                     f"train_state_{global_step}.pt")
            t_save = time.time()
            state = ((params, ema, opt_state) if mesh is None
                     else gather_state(params, ema, opt_state, mesh))
            if lead:
                ckpt_utils.save_train_state(last_ckpt, *state, smeta)
            state = None
            ckpt_seconds[i] = time.time() - t_save
        if on_step_end is not None:
            on_step_end(i)
    return {"params": params, "ema": ema, "opt_state": opt_state,
            "losses": losses,
            "step_losses": (torch.stack(step_losses) if step_losses
                            else torch.zeros(0, device=device)),
            "meta": meta, "ckpt": last_ckpt, "ckpt_seconds": ckpt_seconds}


def make_encode_batch(vae=None, text_encoder=None,
                      schedule_steps: int = 1000, seed: int = 7,
                      null_caption_shape=None):
    """Raw {'video', 'text'} batches -> train batches (reference train.py:
    218-224 under no_grad; JAX train.py:188-220): encode(batch, step) ->
    {'x0', 't', 'y', 'mask'}, t drawn from a generator seeded by (seed,
    step). vae: a module with .encode (`models/vae.py`, e.g.
    `utils/workload.build_vae(cfg, device, decoder=False)`): the batch's
    pixels [B, 3, T, H, W] go to the VAE's device and x0 is their
    posterior mean, under no_grad (JAX encodes with rng None); without
    one, 'video' is x0 as it is. text_encoder: an object with
    .encode(prompts) -> {'y', 'mask'}; without one, the batch's own
    'y'/'mask', else zero embeds of null_caption_shape [1, L, C] with an
    all-ones mask, on x0's device."""

    def encode(batch, step: int):
        x = torch.as_tensor(np.asarray(batch["video"]))
        if vae is not None:
            p = next(vae.parameters())
            with torch.no_grad():
                x = vae.encode(x.to(p.device, p.dtype))
        if text_encoder is not None:
            enc = text_encoder.encode(batch["text"])
            y, mask = enc["y"], enc.get("mask")
        else:
            y, mask = batch.get("y"), batch.get("mask")
            if y is None and null_caption_shape is not None:
                y = torch.zeros((x.shape[0],) + tuple(null_caption_shape),
                                dtype=x.dtype, device=x.device)
                mask = torch.ones((x.shape[0], null_caption_shape[-2]),
                                  dtype=torch.int32, device=x.device)
        g = step_generator(seed, step, "cpu")
        t = torch.randint(0, schedule_steps, (x.shape[0],), generator=g)
        out = {"x0": x, "t": t, "y": y}
        if mask is not None:
            out["mask"] = mask
        return out

    return encode


def train_entry(model, dataset, *, latent_shape, caption_shape,
                epochs: int = 1, batch_size: int = 2,
                encode_batch: Optional[Callable] = None,
                resume_from: Optional[str] = None,
                sampler_seed: int = 0, shuffle: bool = True,
                rank: int = 0, world: int = 1, **loop_kw):
    """Epoch-structured training over a map-style dataset with the
    resumable StatefulSampler (reference train.py:178-286: set_epoch /
    set_start_index, mid-epoch resume from the checkpoint's meta).
    encode_batch(raw_batch, step) maps items to train batches
    (make_encode_batch); None passes them through. loop_kw goes to
    train_loop (lr, grad_accum, ckpt_every, ...); its on_step_end gets the
    global step index (epoch * steps per epoch + step). Returns the last
    epoch's train_loop result with 'step_losses' (every step run) and
    'ckpt_seconds' (keyed by global step index) over all epochs, or None
    when the checkpoint covers every epoch."""
    from viditq_tpu_torch.data.datasets import (StatefulSampler,
                                                batch_iterator)

    sampler = StatefulSampler(len(dataset), shuffle=shuffle,
                              seed=sampler_seed, rank=rank, world=world)
    n_per_epoch = len(dataset) // world // batch_size
    start_epoch, start_step, consumed = 0, 0, 0
    if resume_from and os.path.exists(resume_from + ".meta.json"):
        with open(resume_from + ".meta.json") as f:
            meta = json.load(f)
        start_epoch = int(meta.get("epoch", 0))
        start_step = int(meta.get("step", 0))
        if "sampler" in meta:
            sampler.load_state_dict(meta["sampler"])
            consumed = int(meta["sampler"].get("start_index", 0))
        if start_step >= n_per_epoch:  # the checkpoint closed its epoch
            start_epoch, start_step, consumed = start_epoch + 1, 0, 0
            sampler.set_start_index(0)

    out, step_losses, ckpt_seconds = None, [], {}
    user_end = loop_kw.pop("on_step_end", None)
    for epoch in range(start_epoch, epochs):
        sampler.set_epoch(epoch)
        epoch_start = start_step
        base = epoch * n_per_epoch
        on_end = (None if user_end is None
                  else (lambda i, b=base: user_end(b + i)))

        def batches():
            # the encode step index starts at the resume point, so its
            # draws are the uninterrupted run's
            for step, raw in enumerate(
                    batch_iterator(dataset, sampler, batch_size),
                    start=epoch_start):
                yield (encode_batch(raw, epoch * n_per_epoch + step)
                       if encode_batch is not None else raw)

        out = train_loop(model, batches(), latent_shape=latent_shape,
                         caption_shape=caption_shape,
                         num_steps=n_per_epoch, start_step=start_step,
                         epoch=epoch, sampler=sampler,
                         consumed_items=consumed,
                         resume_from=resume_from if epoch == start_epoch
                         else None, use_meta_counters=False,
                         on_step_end=on_end, **loop_kw)
        step_losses.append(out["step_losses"])
        ckpt_seconds.update({base + i: v
                             for i, v in out["ckpt_seconds"].items()})
        # later epochs start clean (reference train.py:284-286) and carry
        # the EMA and the optimizer state (the parameters are the model's)
        resume_from, start_step, consumed = None, 0, 0
        sampler.set_start_index(0)
        loop_kw["resume_ema"] = out["ema"]
        loop_kw["resume_opt_state"] = out["opt_state"]
    if out is not None:
        out["step_losses"] = torch.cat(step_losses)
        out["ckpt_seconds"] = ckpt_seconds
    return out
