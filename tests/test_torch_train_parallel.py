"""The port's training over a mesh (`parallel/training.py`: dp with ZeRO
moments, tp by the Megatron rules; `pipelines/train.train_loop(mesh=)`;
`train --dp/--sp/--tp` under torchrun) against the JAX package's
`train_loop` on a `make_mesh` mesh and against the port's single process,
on a pool of 4 gloo CPU ranks started once for the file. The model is the
tiny STDiT of `tests/torch_parity.py` in float32 on numpy weights x 0.1.

JAX's train step runs jitted over its mesh, where its Pallas interpret
mode does not compose on the CPU, so JAX's side is its XLA path (XLA f32
attention against the kernels' bf16 q.k in the port, ROADMAP C15); the
port is fed the noise JAX's step draws from its key (threefry cannot be
drawn in torch). Tolerances:
- against JAX, one step at lr 1e-3 with clipping at 1.0: the loss 1e-3
  relative; the parameters' change (new - initial) 5e-2 relative in norm
  over the whole model and at cosine > 0.99 (AdamW's first update is
  ~lr * sign(g), so a gradient near zero may take either sign in the two
  libraries: tests/test_torch_train.py holds the same on JAX's kernel
  path at 1e-4 and 0.99);
- against the port's single process on the same batch and noise (the
  local means averaged over dp, the partial products of a row-parallel
  layer summed over tp: summation order only): the loss 1e-6 relative;
  the first moments, (1 - b1) times the gradients, 1e-4 relative per
  tensor (or within 1e-9); the EMA that of the parameters got, 1e-6; the
  parameters' update 1e-2 relative in norm at cosine > 0.9999, no
  parameter more than 2 lr a step apart (AdamW's first update is ~lr *
  g / (|g| + eps), so a gradient within float noise of eps moves its
  parameter by up to lr: measured 5.3e-4 and 1 - cos 1.8e-7);
- train_loop resumed at another world size from a checkpoint written by
  one process, and the CLI at --dp 2 under torchrun against --dp 1: the
  losses 1e-5 relative, the parameters' update as above.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import RankPool, build, r_train_loop, r_train_step
from torch_parity import TINY, inputs, randomize, rel_err
from viditq_tpu.models.stdit import STDiT as JSTDiT
from viditq_tpu.parallel.mesh import make_mesh as j_make_mesh
from viditq_tpu.pipelines.train import train_loop as j_train_loop
from viditq_tpu_torch.parallel import training as tr
from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

LR, CLIP = 1e-3, 1.0
JAX_LOSS, JAX_STEP, JAX_COS = 1e-3, 5e-2, 0.99
SELF_LOSS, SELF_ABS = 1e-6, 1e-6
SELF_GRAD, SELF_GRAD_ABS = 1e-4, 1e-9
SELF_UPDATE, SELF_COS = 1e-2, 0.9999
RESUME_LOSS = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its params (numpy), the port's state, a batch of 2)."""
    x, _, y, mask = inputs()
    batch = {"x0": x, "t": np.array([10, 900], np.int32), "y": y,
             "mask": mask}
    jm = JSTDiT(dtype=jnp.float32, **TINY)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), x, np.zeros(2, np.float32),
                         y, mask)
    params = randomize(v["params"], 0, 0.1)
    sd = {k: t.numpy() for k, t in state_dict_from_flax(params).items()}
    return jm, params, sd, batch


def _jax_step(jm, params, batch, axes, save_dir):
    """JAX's train_loop, one step on `batch` over a make_mesh mesh of
    `axes`: (loss, params after, the noise its step drew)."""
    n = int(np.prod(list(axes.values())))
    mesh = j_make_mesh(**axes, devices=jax.devices()[:n])
    rng = jax.random.PRNGKey(3)
    out = j_train_loop(jm, iter([batch]), latent_shape=None,
                       caption_shape=None, num_steps=1, lr=LR,
                       grad_clip=CLIP, mesh=mesh, rng=rng, log_every=0,
                       resume_params=params, save_dir=str(save_dir))
    noise = jax.random.normal(jax.random.fold_in(rng, 10_000),
                              batch["x0"].shape, jnp.float32)
    flat = state_dict_from_flax(jax.tree.map(np.asarray, out["params"]))
    loss = out["losses"][-1]
    return loss, {k: t.numpy() for k, t in flat.items()}, np.asarray(noise)


def _same_update(got, want, init, steps=1):
    """got and want moved init alike: the whole model's update within
    SELF_UPDATE relative in norm at cosine > SELF_COS, no parameter more
    than 2 lr a step apart (AdamW's bound)."""
    names = sorted(want)
    assert set(got) == set(names)
    d_got = np.concatenate([(got[k] - init[k]).ravel() for k in names])
    d_want = np.concatenate([(want[k] - init[k]).ravel() for k in names])
    cos = d_got @ d_want / (np.linalg.norm(d_got) * np.linalg.norm(d_want))
    assert rel_err(d_got, d_want) <= SELF_UPDATE
    assert cos > SELF_COS
    for k in names:
        assert np.abs(got[k] - want[k]).max() <= 2 * LR * steps, k


def _single_step(sd, batch, noise, grad_accum=1):
    model = build("stdit", TINY, sd)
    params = tr.trainable(model)
    opt = tr.make_optimizer(lr=LR, grad_clip=CLIP)
    st, ema = opt.init(params), tr.init_ema(params)
    noises = [torch.from_numpy(n) for n in noise]
    step = tr.make_train_step(model, make_schedule(
        timestep_respacing=[1000]), opt, grad_accum=grad_accum,
                              noise_fn=lambda shape, i: noises[i])
    loss = float(step(ema, st, {k: torch.from_numpy(v)
                                for k, v in batch.items()}))
    return (loss, {n: p.detach().numpy() for n, p in params.items()},
            {n: e.numpy() for n, e in ema.items()},
            {n: m.numpy() for n, m in st["mu"].items()})


@pytest.mark.parametrize("axes", [{"dp": 2}, {"tp": 2}])
def test_mesh_step_matches_jax_train_loop(pool, tiny, axes, tmp_path):
    """One step at dp = 2 (each rank one row, the AdamW moments ZeRO-
    sharded) and at tp = 2 (two heads a rank, kv_linear's k and v heads
    paired) against JAX's train_loop on the same mesh."""
    jm, params, sd, batch = tiny
    want_loss, want, noise = _jax_step(jm, params, batch, axes, tmp_path)
    n = int(np.prod(list(axes.values())))
    loss, got, _, _ = pool.run(r_train_step, TINY, sd, batch, [noise], axes,
                               LR, CLIP, 1, list(range(n)))[0]
    assert abs(loss - want_loss) <= JAX_LOSS * abs(want_loss)
    names = sorted(want)
    d_got = np.concatenate([(got[k] - sd[k]).ravel() for k in names])
    d_want = np.concatenate([(want[k] - sd[k]).ravel() for k in names])
    assert rel_err(d_got, d_want) <= JAX_STEP
    cos = d_got @ d_want / (np.linalg.norm(d_got) * np.linalg.norm(d_want))
    assert cos > JAX_COS


@pytest.mark.parametrize("axes,grad_accum", [
    ({"dp": 2}, 1), ({"tp": 2}, 1), ({"dp": 2, "tp": 2}, 1),
    ({"dp": 2, "sp": 2}, 2)])
def test_mesh_step_equals_single_process(pool, tiny, axes, grad_accum):
    """dp, tp, dp x tp, and dp with replicated sp ranks and gradient
    accumulation, against one process on the same global batch and noise:
    the loss, and the parameters, EMA and first moments gathered whole."""
    _, _, sd, batch = tiny
    if grad_accum > 1:
        batch = {k: np.concatenate([v, v[::-1]]) for k, v in batch.items()}
    rng = np.random.default_rng(5)
    mb = batch["x0"].shape[0] // grad_accum
    noise = [rng.standard_normal((mb, *batch["x0"].shape[1:])).astype(
        np.float32) for _ in range(grad_accum)]
    n = int(np.prod(list(axes.values())))
    got = pool.run(r_train_step, TINY, sd, batch, noise, axes, LR, CLIP,
                   grad_accum, list(range(n)))
    for g in got[1:n]:
        assert g[0] == got[0][0]
    want = _single_step(sd, batch, noise, grad_accum)
    assert abs(got[0][0] - want[0]) <= SELF_LOSS * abs(want[0])
    _same_update(got[0][1], want[1], sd)
    for k, mu in want[3].items():  # (1 - b1) g: the gradients
        assert np.abs(got[0][3][k] - mu).max() <= SELF_GRAD_ABS or (
            rel_err(got[0][3][k], mu) <= SELF_GRAD), k
    for k, e in want[2].items():  # the EMA of the parameters got
        ema = sd[k] * 0.9999 + got[0][1][k] * (1 - 0.9999)
        assert np.abs(got[0][2][k] - ema).max() <= SELF_ABS, k


def test_tp_refuses_a_quantized_plan(pool):
    from torch_parity import SM8
    from torch_dist import r_tp_quantized
    with pytest.raises(RuntimeError, match="item 6"):
        pool.run(r_tp_quantized, TINY, SM8, [0, 1])


def test_train_loop_resumes_at_another_world_size(pool, tiny, tmp_path):
    """One process trains 2 synthetic steps with a checkpoint after step 1;
    dp=2 x tp=2 resumes from it: its step-2 loss and parameters are the
    one process's, and its own checkpoint is one whole state."""
    from viditq_tpu_torch.pipelines.train import train_loop
    from viditq_tpu_torch.utils import ckpt
    _, _, sd, _ = tiny
    model = build("stdit", TINY, sd)
    out = train_loop(model, None, latent_shape=(4, *TINY["input_size"]),
                     caption_shape=(1, 8, 32), num_steps=2, lr=1e-3,
                     grad_clip=CLIP, save_dir=str(tmp_path / "one"),
                     ckpt_every=1, log_every=0)
    first = str(tmp_path / "one" / "train_state_1.pt")
    losses, got, last = pool.run(
        r_train_loop, TINY, sd, {"dp": 2, "tp": 2}, 2,
        str(tmp_path / "four"), first, CLIP, 2)[0]
    want = [float(v) for v in out["step_losses"]]
    assert len(losses) == 1
    assert abs(losses[0] - want[1]) <= RESUME_LOSS * abs(want[1])
    _same_update(got, {n: p.detach().numpy() for n, p in
                       out["params"].items()}, sd, 2)
    p2, ema2, st2, meta = ckpt.load_train_state(last)
    assert meta["step"] == 2 and st2["count"] == 2
    for n, p in out["params"].items():
        assert p2[n].shape == p.shape, n
        assert st2["mu"][n].shape == p.shape, n
        assert ema2[n].shape == p.shape, n


def _torchrun(tmp, *extra, nproc=2):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", "viditq_tpu_torch.cli",
           "train", "--device", "cpu", "--config",
           "configs/workload/opensora_tiny.py", "--save_dir", str(tmp),
           *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_train_dp2_under_torchrun_equals_dp1(tmp_path):
    """`python -m torch.distributed.run --nproc_per_node 2 -m
    viditq_tpu_torch.cli train ... --dp 2` gives the losses and the
    checkpoint of `--dp 1` on the same seed."""
    import json
    from viditq_tpu_torch import cli
    from viditq_tpu_torch.utils import ckpt
    steps = ["--num_steps", "2", "--ckpt_every", "2", "--grad_clip", "1.0"]
    res = _torchrun(tmp_path / "dp2", "--dp", "2", *steps)
    assert res.returncode == 0, res.stderr[-3000:]
    one = cli.main(["train", "--device", "cpu", "--config",
                    "configs/workload/opensora_tiny.py", "--save_dir",
                    str(tmp_path / "dp1"), *steps])
    logs = [json.loads(line) for line in
            open(tmp_path / "dp2" / "train_log.jsonl")]
    assert len(logs) == 1  # rank 0 alone logs
    assert abs(logs[0]["loss"] - one["losses"][-1]) <= (
        RESUME_LOSS * abs(one["losses"][-1]))
    assert abs(logs[0]["avg_loss"] - np.mean(one["losses"])) <= (
        RESUME_LOSS * abs(np.mean(one["losses"])))
    p2, _, _, meta = ckpt.load_train_state(
        str(tmp_path / "dp2" / "train_state_2.pt"))
    assert meta["step"] == 2
    from viditq_tpu_torch.utils import workload
    cfg = workload.load_py_config("configs/workload/opensora_tiny.py")
    init = {n: p.detach().numpy() for n, p in workload.jax_init_(
        workload.build_model(cfg, device="cpu"), 0).named_parameters()}
    _same_update({n: v.numpy() for n, v in p2.items()},
                 {n: v.detach().numpy() for n, v in one["params"].items()},
                 init, 2)


def test_cli_train_world_size_must_match(tmp_path):
    res = _torchrun(tmp_path, "--dp", "2", "--num_steps", "1", nproc=1)
    assert res.returncode != 0
    assert "world size 1 differs from --dp x --sp x --tp = 2" in (
        res.stderr + res.stdout)
