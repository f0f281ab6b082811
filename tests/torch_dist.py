"""A pool of CPU ranks for the port's parallelism tests, and the functions
they run.

`RankPool(world)` spawns `world` interpreters (`multiprocessing`'s spawn
start method) that join one gloo process group through a file in a
temporary directory, with a time limit on every collective; `run(fn,
*args)` runs fn(*args) on every rank and returns the ranks' results in
rank order, or raises with a rank's traceback; a rank that does not
answer within the limit fails the call. After a failure the pool is shut
down and restarted at the next call, so one deadlock fails one test. The
ranks import torch and the port only (never JAX): the tests pass them
numpy arrays and the port's state dicts, and compare in the test process.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import traceback

import numpy as np

# a collective that waits longer fails the rank (and its test)
COLLECTIVE_TIMEOUT_S = 180
# the test process waits this long for a rank's answer
ANSWER_TIMEOUT_S = 300


def _worker(rank, world, init_file, tasks, results):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    while True:
        item = tasks.get()
        if item is None:
            break
        fn, args = item
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:  # report every failure, the pool goes on
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int):
        self.world = world
        self.procs = None

    def _start(self):
        ctx = mp.get_context("spawn")
        self.tmp = tempfile.TemporaryDirectory(prefix="rank_pool_")
        init = os.path.join(self.tmp.name, "pg")
        self.tasks = [ctx.Queue() for _ in range(self.world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.world, init, self.tasks[r],
                                        self.results))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args):
        if self.procs is None:
            self._start()
        for q in self.tasks:
            q.put((fn, args))
        out = {}
        try:
            for _ in range(self.world):
                rank, ok, val = self.results.get(timeout=ANSWER_TIMEOUT_S)
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{val}")
                out[rank] = val
        except (RuntimeError, queue.Empty):
            self.close(force=True)
            raise
        return [out[r] for r in range(self.world)]

    def close(self, force: bool = False):
        if self.procs is None:
            return
        if not force:
            for q in self.tasks:
                q.put(None)
        for p in self.procs:
            p.join(timeout=0 if force else 30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        assert not any(p.is_alive() for p in self.procs)
        self.procs = None
        self.tmp.cleanup()


# ---------------- the ranks' side ----------------

def _t(a):
    import torch
    return None if a is None else torch.from_numpy(np.asarray(a))


def _np(t):
    return None if t is None else t.detach().float().cpu().numpy()


def _mesh(ranks=None, **axes):
    from viditq_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(ranks=ranks, **axes)


def build(kind, cfg, state=None, plan=None, **kw):
    """The port's model of kind ('stdit' or 'pixart') in float32 under the
    plan (a YAML path, one of TOKEN_PLANS or None for fp), loading state
    (numpy by name)."""
    import torch
    from viditq_tpu_torch.models.pixart import PixArt
    from viditq_tpu_torch.models.stdit import STDiT
    from viditq_tpu_torch.utils.config import load_quant_config
    if plan in TOKEN_PLANS:
        kw["resolver"] = token_w8a8_resolver(plan == "token_w8a8_dyncb")
    elif plan is not None:
        kw["resolver"] = load_quant_config(plan).resolver()
    model = {"stdit": STDiT, "pixart": PixArt}[kind](
        dtype=torch.float32, **cfg, **kw)
    if state is not None:  # the quant tables may be left to calibrate
        res = model.load_state_dict({k: _t(v) for k, v in state.items()},
                                    strict=False)
        params = dict(model.named_parameters())
        assert not res.unexpected_keys and not any(
            k in params for k in res.missing_keys), res
    return model.eval()


def qctx_of(quant):
    from viditq_tpu_torch.quant.qlinear import QuantCtx
    return QuantCtx(mode="quant", t_id=500) if quant else None


def r_mesh(axes, ranks=None):
    """make_mesh's view on every rank: (shape, coord, ranks) or None."""
    m = _mesh(ranks=ranks, **axes)
    return None if m is None else (m.shape, m.coord, m.ranks)


def r_attention(which, q, k, v, sp, ranks=None):
    """ulysses_attention or ring_attention over an sp axis of the first
    `sp` ranks; the whole output on each rank in the mesh."""
    import torch
    from viditq_tpu_torch.parallel.ring import ring_attention
    from viditq_tpu_torch.parallel.ulysses import ulysses_attention
    mesh = _mesh(ranks=ranks, sp=sp)
    if mesh is None:
        return None
    fn = ulysses_attention if which == "ulysses" else ring_attention
    with torch.no_grad():
        return _np(fn(_t(q), _t(k), _t(v), mesh))


def r_stdit_sp(cfg, state, args, sp, sp_mode, plan=None, ranks=None):
    """The tiny STDiT's forward with sequence parallelism over sp ranks."""
    import torch
    mesh = _mesh(ranks=ranks, sp=sp)
    if mesh is None:
        return None
    model = build("stdit", cfg, state, plan, sp_mesh=mesh, sp_mode=sp_mode)
    x, t, y, mask = (_t(a) for a in args)
    with torch.no_grad():
        return _np(model(x, t.float(), y, mask, qctx_of(plan)))


def r_pp_forward(kind, cfg, state, args, pp, n_mb, plan=None, ranks=None):
    """The pipelined forward over pp ranks (every rank's whole output)."""
    import torch
    from viditq_tpu_torch.parallel.pipeline import PipelinedModel
    mesh = _mesh(ranks=ranks, pp=pp)
    if mesh is None:
        return None
    model = build(kind, cfg, state, plan)
    x, t, y, mask = (_t(a) for a in args)
    with torch.no_grad():
        return _np(PipelinedModel(model, mesh, n_mb)(
            x, t.float(), y, mask, qctx_of(plan)))


def r_pp_grads(cfg, state, args, pp, n_mb, ranks=None):
    """Gradients of sum(out^2) through the pipelined forward, every block
    gathered from its stage: {name: gradient}."""
    import torch
    from viditq_tpu_torch.parallel.pipeline import (PipelinedModel,
                                                    gather_stages)
    mesh = _mesh(ranks=ranks, pp=pp)
    if mesh is None:
        return None
    model = build("stdit", cfg, state)
    x, t, y, mask = (_t(a) for a in args)
    fwd = PipelinedModel(model, mesh, n_mb)
    out = fwd(x, t.float(), y, mask)
    torch.sum(out.float() ** 2).backward()
    fwd.finish_backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    gather_stages(grads, mesh, len(model.blocks))
    return {n: _np(g) for n, g in grads.items()}


def r_pp_train_step(cfg, state, batch, noise, pp, n_mb, lr, clip,
                    ranks=None):
    """One GPipe train step (AdamW at lr, clip): (loss, {name: param},
    {name: first moment}) with every block gathered from its stage."""
    import torch
    from viditq_tpu_torch.parallel import training as tr
    from viditq_tpu_torch.parallel.pipeline import (gather_stages,
                                                    make_pp_train_step,
                                                    stage_params)
    from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
    mesh = _mesh(ranks=ranks, pp=pp)
    if mesh is None:
        return None
    model = build("stdit", cfg, state)
    opt = tr.make_optimizer(lr=lr, grad_clip=clip)
    params = stage_params(model, mesh)
    ema, st = tr.init_ema(params), opt.init(params)
    step = make_pp_train_step(model, make_schedule(num_sampling_steps=10),
                              opt, mesh=mesh, n_microbatches=n_mb,
                              noise_fn=lambda shape, i: _t(noise))
    loss = step(ema, st, {k: _t(v) for k, v in batch.items()})
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    mu = {n: st["mu"].get(n, torch.zeros_like(p)) for n, p in out.items()}
    gather_stages(out, mesh, len(model.blocks))
    gather_stages(mu, mesh, len(model.blocks))
    return (float(loss), {n: _np(v) for n, v in out.items()},
            {n: _np(v) for n, v in mu.items()})


def r_train_step(cfg, state, batch, noise, axes, lr, clip, grad_accum=1,
                 ranks=None):
    """One train step over a (dp, tp) mesh, the global batch and noise
    given: (loss, whole params, whole ema, whole opt_state moments)."""
    import torch
    from viditq_tpu_torch.parallel import training as tr
    from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
    mesh = _mesh(ranks=ranks, **axes)
    if mesh is None:
        return None
    model = build("stdit", cfg, state)
    tr.tp_shard_(model, mesh)
    params = tr.trainable(model)
    opt = tr.make_optimizer(lr=lr, grad_clip=clip)
    st, ema = tr.init_state(opt, params, mesh), tr.init_ema(params)
    noises = [_t(n) for n in noise]
    step = tr.make_train_step(model, make_schedule(
        timestep_respacing=[1000]), opt, grad_accum=grad_accum, mesh=mesh,
                              noise_fn=lambda shape, i: noises[i])
    loss = step(ema, st, {k: _t(v) for k, v in batch.items()})
    p, e, s = tr.gather_state(params, ema, st, mesh)
    return (float(loss), {n: _np(v) for n, v in p.items()},
            {n: _np(v) for n, v in e.items()},
            {n: _np(v) for n, v in s["mu"].items()})


def r_train_loop(cfg, state, axes, steps, save_dir, resume=None, clip=1.0,
                 ckpt_every=0, ranks=None):
    """pipelines/train.train_loop over a mesh on synthetic batches:
    (step losses, whole params)."""
    import torch
    from viditq_tpu_torch.parallel import training as tr
    from viditq_tpu_torch.pipelines.train import train_loop
    mesh = _mesh(ranks=ranks, **axes)
    if mesh is None:
        return None
    model = build("stdit", cfg, state)
    T = cfg["input_size"]
    out = train_loop(model, None, latent_shape=(4, *T),
                     caption_shape=(1, cfg["model_max_length"],
                                    cfg["caption_channels"]),
                     num_steps=steps, lr=1e-3, grad_clip=clip,
                     save_dir=save_dir, resume_from=resume,
                     ckpt_every=ckpt_every, log_every=0, mesh=mesh)
    p, _, _ = tr.gather_state(out["params"], out["ema"], out["opt_state"],
                              mesh)
    return ([float(v) for v in out["step_losses"]],
            {n: _np(v) for n, v in p.items()}, out["ckpt"])


# the simulate-backend W8A8 plans built in code: the JAX test's, and the
# same with the 'dynamic' channel-balance type
TOKEN_PLANS = ("token_w8a8", "token_w8a8_dyncb")
DYNCB_ALPHA = (0.5,)


def token_w8a8_resolver(dynamic_cb: bool = False):
    """The JAX test's W8A8 (tests/test_parallel_inference.py:21-30):
    per-channel W8, dynamic per-token A8 on the simulate backend, five
    layers fp; dynamic_cb: each layer channel-balanced by the 'dynamic'
    type (cs from the live input's maxima, alpha DYNCB_ALPHA)."""
    from viditq_tpu_torch.quant.naming import resolve_layer_spec
    from viditq_tpu_torch.quant.spec import (LayerQuantSpec, QuantSpec,
                                             SmoothQuantSpec)
    spec = LayerQuantSpec(
        weight=QuantSpec(n_bits=8, granularity="channel", channel_axis=-1,
                         round_mode="nearest"),
        act=QuantSpec(n_bits=8, granularity="token",
                      round_mode="nearest_ste", dynamic=True),
        smooth_quant=SmoothQuantSpec(
            enable=dynamic_cb, channel_wise_scale_type="dynamic",
            alpha=DYNCB_ALPHA))
    fp = ("x_embedder", "t_block", "t_embedder", "y_embedder",
          "final_layer")
    return lambda name: resolve_layer_spec(name, spec, fp)


def dp_sample(cfg, state, plan, z, y_c, mask, steps, mesh=None):
    """2-step CFG DDIM under plan (one of TOKEN_PLANS or a YAML path, the
    weight tables in state or calibrated) through `quant_sample`, the batch
    sharded over the mesh's dp axis where one is given (one process: no
    mesh); the whole samples."""
    import torch
    from viditq_tpu_torch.pipelines.inference import quant_sample
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    model = build("stdit", cfg, state, plan)
    if plan not in TOKEN_PLANS:
        pack_native_weights(calibrate_weight_tables(model))
    z, y_c, mask = (_t(a) for a in (z, y_c, mask))
    y = torch.cat([y_c, y_c * 0])  # [cond; null]
    return _np(quant_sample(model, IDDPM(num_sampling_steps=steps,
                                         cfg_scale=4.0), z, y, mask,
                            mesh=mesh))


def r_dp_sample(cfg, state, plan, z, y_c, mask, steps, axes):
    mesh = _mesh(**axes)
    return dp_sample(cfg, state, plan, z, y_c, mask, steps, mesh)


def r_tp_quantized(cfg, plan, ranks):
    """tp_shard_ of a model under a quantized plan (it raises)."""
    from viditq_tpu_torch.parallel import training as tr
    mesh = _mesh(ranks=ranks, tp=len(ranks))
    if mesh is None:
        return None
    tr.tp_shard_(build("stdit", cfg, None, plan), mesh)
