"""The port's GPipe pipeline (`viditq_tpu_torch/parallel/pipeline.py`)
against the JAX package's (`tests/test_pipeline_pp.py`), on a pool of 4
gloo CPU ranks started once for the file. The models are JAX's pipeline
test configuration (depth 8, C = 64, 4 heads, a 4x16x16 latent) on numpy
weights x 0.1, bridged from JAX's scanned layout.

JAX's Pallas interpret mode does not compose with a mesh program on the
CPU, so JAX's pipeline runs its XLA path (as its own tests do); its
output there equals its single-chip forward (tests/test_pipeline_pp.py).
Tolerances:
- fp forward (STDiT, PixArt) and gradients: the port's pipeline 1e-6 from
  its single process (the same per-microbatch sums), 5e-4 from JAX's
  pipeline (its XLA f32 attention against the kernels' bf16 q.k, ROADMAP
  C15); gradients per tensor above 1e-6 of the largest gradient norm
  (below it, within twice that) 2e-3 relative from JAX's (JAX's test's
  2e-3) and 1e-5 from the single process (the embed's cotangents summed
  over the stages in another order).
- quantized forward, JAX's test spec (W8 per-channel, dynamic per-token
  A8 on the simulate backend): a token's act scale pools over the batch
  rows of its view (token granularity, group shape (1, N, 1)), so each
  microbatch pools over its own rows. The port's pipeline equals its
  single process run on the same microbatches 1e-6, and lies 1e-3..5e-2
  from the whole batch's forward: the microbatch split is the C4 offset
  (ROADMAP). Against JAX's pipeline on the same split: 1e-2 (the int8
  noise floor).
- sm8 (per-row dynamic quantization): the pipeline equals one process on
  the whole batch, 1e-6.
- one GPipe train step (AdamW at lr 1e-3, clipping at 1.0): the loss
  1e-6 relative, every parameter 1e-5 (a hundredth of AdamW's first step,
  ~lr) and the first moments, (1 - b1) times the clipped gradient, as
  the gradients (GRAD_SELF) from the single-process step (measured
  2.0e-6); against JAX's `make_pp_train_step` on a pp=2 mesh, fed JAX's
  noise: the loss 1e-3 relative, the first moments as the gradients
  against JAX's (GRAD_REL: the clip norm summed over the stages scales
  them), the parameters' change 5e-2 relative in norm at cosine > 0.99
  (AdamW's first update is ~lr * sign(g): a gradient near zero may take
  either sign in the two libraries, tests/test_torch_train_parallel.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import (RankPool, build, qctx_of, r_pp_forward, r_pp_grads,
                        r_pp_train_step)
from torch_parity import SM8, build_jax, rel_err
from viditq_tpu.models.pixart import PixArt as JPixArt
from viditq_tpu.models.stdit import STDiT as JSTDiT
from viditq_tpu.parallel.mesh import make_mesh as j_make_mesh
from viditq_tpu.parallel.pipeline import (pixart_pipeline_forward as
                                          j_pixart_pp)
from viditq_tpu.parallel.pipeline import (stdit_pipeline_forward as
                                          j_stdit_pp)
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import calibrate_weight_tables as j_calibrate
from viditq_tpu.quant import LayerQuantSpec as JLayerQuantSpec
from viditq_tpu.quant import QuantSpec as JQuantSpec
from viditq_tpu.quant import resolve_layer_spec as j_resolve
from viditq_tpu_torch.parallel.pipeline import PipelinedModel, stage_range
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

SELF_TOL = 1e-6
JAX_XLA_TOL = 5e-4
GRAD_REL, GRAD_FLOOR = 2e-3, 1e-6
GRAD_SELF = 1e-5
STEP_TOL = 1e-5  # a hundredth of the lr, AdamW's first step
SPLIT_OFFSET = (1e-3, 5e-2)
JAX_LOSS, JAX_STEP, JAX_COS = 1e-3, 5e-2, 0.99
QUANT_JAX_TOL = 1e-2
CFG = dict(input_size=(4, 16, 16), hidden_size=64, depth=8, num_heads=4,
           caption_channels=32, model_max_length=8)
PIXART = dict(input_size=16, hidden_size=64, depth=8, num_heads=4,
              caption_channels=32, model_max_length=8)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _inputs(kind="stdit", B=4):
    rng = np.random.default_rng(0)
    shape = (B, 4, 4, 16, 16) if kind == "stdit" else (B, 4, 16, 16)
    x = rng.standard_normal(shape).astype(np.float32)
    t = np.array([500.0, 100.0, 30.0, 900.0][:B], np.float32)
    y = rng.standard_normal((B, 1, 8, 32)).astype(np.float32)
    mask = np.ones((B, 8), np.int32)
    mask[-1, 5:] = 0
    return x, t, y, mask


@functools.lru_cache(maxsize=None)
def _jax(kind="stdit", quant=False):
    """(JAX scanned model, its variables as numpy, the port's state), under
    JAX's quantized test spec where quant."""
    resolver = _j_resolver() if quant else None
    cls, cfg = (JSTDiT, CFG) if kind == "stdit" else (JPixArt, PIXART)
    kw = {} if resolver is None else {"resolver": resolver}
    model = cls(dtype=jnp.float32, scan_blocks=True, **cfg, **kw)
    x, t, y, mask = _inputs(kind)
    v = dict(jax.jit(functools.partial(model.init, qctx=JQuantCtx(
        mode="fp")))(jax.random.PRNGKey(0), x, t, y, mask))
    rng = np.random.default_rng(0)
    v["params"] = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32),
        v["params"])
    if resolver is not None:
        v["quant"] = jax.tree.map(np.asarray, j_calibrate(
            v["params"], v["quant"], resolver))
    else:
        v.pop("quant", None)
    sd = state_dict_from_flax(v["params"], v.get("quant"))
    return model, v, {k: t.numpy() for k, t in sd.items()}


def _j_resolver():
    w8 = JQuantSpec(n_bits=8, granularity="channel", channel_axis=-1)
    a8 = JQuantSpec(n_bits=8, granularity="token", dynamic=True)
    fp = ("x_embedder", "t_block", "t_embedder", "y_embedder",
          "final_layer")
    return lambda n: j_resolve(n, JLayerQuantSpec(weight=w8, act=a8), fp)


def _single(kind, cfg, state, args, plan=None):
    model = build(kind, cfg, state, plan)
    x, t, y, mask = (torch.from_numpy(a) for a in args)
    with torch.no_grad():
        return model(x, t, y, mask, qctx_of(plan)).numpy()


@pytest.mark.parametrize("kind,pp,n_mb", [("stdit", 4, 4), ("stdit", 2, 4),
                                          ("pixart", 4, 4)])
def test_pp_forward_matches_jax_and_single(pool, kind, pp, n_mb):
    """tests/test_pipeline_pp.py:32, :47 (M != S) and :119."""
    jm, jv, sd = _jax(kind)
    args = _inputs(kind)
    mesh = j_make_mesh(pp=pp, devices=jax.devices()[:pp])
    jpp = j_stdit_pp if kind == "stdit" else j_pixart_pp
    want = np.asarray(jpp(jm, jv, *args, mesh=mesh, n_microbatches=n_mb))
    cfg = CFG if kind == "stdit" else PIXART
    got = pool.run(r_pp_forward, kind, cfg, sd, args, pp, n_mb, None,
                   list(range(pp)))
    for g in got[1:pp]:
        np.testing.assert_array_equal(g, got[0])
    assert rel_err(got[0], _single(kind, cfg, sd, args)) <= SELF_TOL
    assert rel_err(got[0], want) <= JAX_XLA_TOL


def test_pp_quantized_split_is_c4(pool):
    """JAX's quantized pipeline test (tests/test_pipeline_pp.py:62-97) on
    the port: the pipeline equals one process on the same microbatches;
    the whole batch's forward differs by the per-token scale pooling."""
    jm, jv, sd = _jax("stdit", True)
    args = _inputs()
    qctx = JQuantCtx(mode="quant", t_id=jnp.asarray(500))
    mesh = j_make_mesh(pp=2, devices=jax.devices()[:2])
    want = np.asarray(j_stdit_pp(jm, jv, *args, qctx, mesh=mesh,
                                 n_microbatches=2))
    got = pool.run(r_pp_forward, "stdit", CFG, sd, args, 2, 2, "token_w8a8",
                   [0, 1])
    np.testing.assert_array_equal(got[0], got[1])
    assert rel_err(got[0], want) <= QUANT_JAX_TOL
    halves = [_single("stdit", CFG, sd, tuple(a[i:i + 2] for a in args),
                      "token_w8a8") for i in (0, 2)]
    assert rel_err(got[0], np.concatenate(halves)) <= SELF_TOL
    whole = _single("stdit", CFG, sd, args, "token_w8a8")
    assert SPLIT_OFFSET[0] <= rel_err(got[0], whole) <= SPLIT_OFFSET[1]


def test_pp_sm8_equals_one_process(pool):
    """Per-row dynamic quantization (the fused sm8 plan, K1-K5's plain
    versions here) does not see the microbatch split."""
    _, jv = build_jax(SM8)
    sd = {k: v.numpy() for k, v in state_dict_from_flax(
        jv["params"], jv["quant"]).items()}
    from torch_parity import TINY, inputs
    x, t, y, mask = inputs(batch=4)
    args = (x, t.astype(np.float32), y, mask)
    got = pool.run(r_pp_forward, "stdit", TINY, sd, args, 2, 2, SM8,
                   [0, 1])
    assert rel_err(got[0], _single("stdit", TINY, sd, args, SM8)) \
        <= SELF_TOL


def _grad_close(got, want, names, tol=GRAD_REL):
    scale = max(float(np.linalg.norm(want[n])) for n in names)
    for n in names:
        if np.linalg.norm(want[n]) > GRAD_FLOOR * scale:
            assert rel_err(got[n], want[n]) <= tol, n
        else:
            assert np.linalg.norm(got[n]) <= 2 * GRAD_FLOOR * scale, n


def test_pp_gradients_match_jax_and_single(pool):
    """tests/test_pipeline_pp.py:135-155: the gradients of sum(out^2)
    through the pipeline."""
    jm, jv, sd = _jax("stdit")
    args = _inputs()
    mesh = j_make_mesh(pp=2, devices=jax.devices()[:2])

    def loss(vs):
        out = j_stdit_pp(jm, vs, *args, mesh=mesh, n_microbatches=2)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    g = jax.jit(jax.grad(loss))({"params": jv["params"]})["params"]
    want = {k: t.numpy() for k, t in state_dict_from_flax(g).items()}
    got = pool.run(r_pp_grads, CFG, sd, args, 2, 2, [0, 1])[0]
    assert set(got) == set(want)
    _grad_close(got, want, list(want))
    model = build("stdit", CFG, sd)
    x, t, y, mask = (torch.from_numpy(a) for a in args)
    torch.sum(model(x, t, y, mask) ** 2).backward()
    single = {n: p.grad.numpy() if p.grad is not None
              else np.zeros(p.shape, np.float32)
              for n, p in model.named_parameters()}
    _grad_close(got, single, list(single), GRAD_SELF)


def test_pp_train_step_matches_plain(pool):
    """tests/test_pipeline_pp.py:158-185 with the port's optimizer (AdamW,
    clipping at 1.0): one GPipe step equals one plain step."""
    from viditq_tpu_torch.parallel import training as tr
    from viditq_tpu_torch.samplers.gaussian_diffusion import make_schedule
    _, _, sd = _jax("stdit")
    x, _, y, mask = _inputs()
    batch = {"x0": x, "t": np.array([1, 5, 3, 7]), "y": y, "mask": mask}
    noise = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32)
    loss, got, mu = pool.run(r_pp_train_step, CFG, sd, batch, noise, 2, 2,
                             1e-3, 1.0, [0, 1])[0]
    model = build("stdit", CFG, sd)
    opt = tr.make_optimizer(lr=1e-3, grad_clip=1.0)
    params = tr.trainable(model)
    step = tr.make_train_step(model, make_schedule(num_sampling_steps=10),
                              opt, noise_fn=lambda s, i: torch.from_numpy(
                                  noise))
    st = opt.init(params)
    want = float(step(tr.init_ema(params), st,
                      {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(loss - want) <= SELF_TOL * abs(want)
    for n, p in model.named_parameters():
        assert np.abs(got[n] - p.detach().numpy()).max() <= STEP_TOL, n
    _grad_close(mu, {n: m.numpy() for n, m in st["mu"].items()},
                list(st["mu"]), GRAD_SELF)


def test_pp_train_step_matches_jax(pool):
    """JAX's `make_pp_train_step` (tests/test_pipeline_pp.py:158-185) with
    the JAX package's optimizer (AdamW at 1e-3, clipping at 1.0) on a pp=2
    mesh, against the port's on the same batch, weights and noise."""
    from viditq_tpu.parallel.pipeline import make_pp_train_step
    from viditq_tpu.parallel.training import make_optimizer
    from viditq_tpu.samplers import make_schedule
    jm, jv, sd = _jax("stdit")
    x, _, y, mask = _inputs()
    batch = {"x0": x, "t": np.array([1, 5, 3, 7]), "y": y, "mask": mask}
    mesh = j_make_mesh(pp=2, devices=jax.devices()[:2])
    opt = make_optimizer(lr=1e-3, grad_clip=1.0)
    params = jv["params"]
    rng = jax.random.PRNGKey(4)
    step = jax.jit(make_pp_train_step(jm, make_schedule(
        num_sampling_steps=10), opt, mesh=mesh, n_microbatches=2))
    p1, _, st, want_loss = step(params, params, opt.init(params), batch, rng)
    adam = next(s for s in jax.tree.leaves(
        st, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    flat = {k: t.numpy() for k, t in state_dict_from_flax(jax.tree.map(
        np.asarray, p1)).items()}
    want_mu = {k: t.numpy() for k, t in state_dict_from_flax(jax.tree.map(
        np.asarray, adam.mu)).items()}
    noise = np.asarray(jax.random.normal(rng, x.shape, jnp.float32))
    loss, got, mu = pool.run(r_pp_train_step, CFG, sd, batch, noise, 2, 2,
                             1e-3, 1.0, [0, 1])[0]
    assert abs(loss - float(want_loss)) <= JAX_LOSS * abs(float(want_loss))
    assert set(mu) == set(want_mu)
    _grad_close(mu, want_mu, list(want_mu))
    names = sorted(flat)
    d_got = np.concatenate([(got[k] - sd[k]).ravel() for k in names])
    d_want = np.concatenate([(flat[k] - sd[k]).ravel() for k in names])
    assert rel_err(d_got, d_want) <= JAX_STEP
    cos = d_got @ d_want / (np.linalg.norm(d_got) * np.linalg.norm(d_want))
    assert cos > JAX_COS


def test_pipeline_refuses_kv_compress_stacks():
    """pipeline.py:170-181: a Σ stack with KV-compressed runs, and a
    whole stack compressed, both refuse."""
    from viditq_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh()
    for layers in ((1,), (0, 1)):
        model = build("pixart", dict(PIXART, depth=2), None,
                      kv_compress_sampling="conv", kv_compress_scale=2,
                      kv_compress_layers=layers)
        with pytest.raises(ValueError, match="uniform|KV-compress"):
            PipelinedModel(model, mesh, 1)
    with pytest.raises(ValueError, match="depth 8 must divide"):
        stage_range(8, dataclasses.replace(mesh, shape={**mesh.shape,
                                                        "pp": 3}))
