"""The port's training (`viditq_tpu_torch/parallel/training.py`,
`pipelines/train.py`) against the JAX package's on the tiny STDiT of
`tests/torch_parity.py` in float32 (the JAX side on its kernel path,
Pallas interpret mode; both backward passes recompute the attention
through the plain f32 softmax).

The JAX draws (threefry) cannot be made in torch, so each comparison
feeds the port the noise the JAX step draws from its key
(`noise_fn`). Tolerances, each held per tensor in norm: the loss 1e-5
relative; the gradients 1e-3 relative for tensors above 1e-6 of the
largest gradient norm (measured: below 1e-5, `GRAD_REL`); the
optimizer against optax on given gradients 1e-6; after one AdamW step,
whose first update is ~lr * sign(g) (a gradient near zero may take
either sign in the two libraries), the parameters within 1e-4 of JAX's
while the step moves them by ~1e-2 of their norm, and the two steps'
directions at cosine > 0.99; resume and gradient checkpointing exactly
(`torch.equal`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import (KINDS, LATENT, TINY, inputs, jax_kernel_path,
                          randomize, rel_err)
from viditq_tpu.data.datasets import StatefulSampler as JStatefulSampler
from viditq_tpu.data.datasets import batch_iterator as j_batch_iterator
from viditq_tpu.models.stdit import STDiT as JSTDiT
from viditq_tpu.parallel import training as jtr
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import QuantSpec as JQuantSpec
from viditq_tpu.quant import LayerQuantSpec as JLayerQuantSpec
from viditq_tpu.quant import calibrate_weight_tables as j_calibrate
from viditq_tpu.quant import resolve_layer_spec as j_resolve
from viditq_tpu.samplers import make_schedule as j_make_schedule
from viditq_tpu.samplers.gaussian_diffusion import (
    training_losses as j_training_losses)
from viditq_tpu_torch.data.datasets import StatefulSampler, batch_iterator
from viditq_tpu_torch.models.stdit import STDiT
from viditq_tpu_torch.parallel import training as tr
from viditq_tpu_torch.pipelines.train import (make_encode_batch,
                                              train_entry, train_loop)
from viditq_tpu_torch.quant.naming import resolve_layer_spec
from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.quant.spec import LayerQuantSpec, QuantSpec
from viditq_tpu_torch.samplers.gaussian_diffusion import (make_schedule,
                                                          training_losses)
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

LOSS_REL = 1e-5
GRAD_REL = 1e-3
GRAD_FLOOR = 1e-6  # tensors below this share of the largest norm
OPT_REL = 1e-6
STEP_PARAM_REL = 1e-4
STEP_COS = 0.99
# QAT: int8 fake quant turns an ulp of difference at a rounding tie into a
# whole code (measured 1.9e-5 loss, 3.2e-3 gradient, 3.1e-4 parameters
# after the step)
QAT_LOSS_REL = 1e-4
QAT_GRAD_REL = 1e-2
QAT_PARAM_REL = 1e-3
LR = 1e-3
T_IDS = np.array([10, 900])
# JAX's QAT test spec (tests/test_parallel.py:77-122)
QAT_FP = ("x_embedder", "t_block", "t_embedder", "y_embedder",
          "final_layer")


def _batch(n=2, seed=0):
    x, _, y, mask = inputs(batch=n, seed=seed)
    t = np.resize(T_IDS, n).astype(np.int32)
    return {"x0": x, "t": t, "y": y, "mask": mask}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _qat_resolvers():
    jw = JQuantSpec(n_bits=8, granularity="channel", channel_axis=-1,
                    round_mode="nearest_ste")
    ja = JQuantSpec(n_bits=8, granularity="token", round_mode="nearest_ste",
                    dynamic=True)
    pw = QuantSpec(n_bits=8, granularity="channel", channel_axis=-1,
                   round_mode="nearest_ste")
    pa = QuantSpec(n_bits=8, granularity="token", round_mode="nearest_ste",
                   dynamic=True)
    return (lambda n: j_resolve(n, JLayerQuantSpec(weight=jw, act=ja),
                                QAT_FP),
            lambda n: resolve_layer_spec(n, LayerQuantSpec(weight=pw,
                                                           act=pa), QAT_FP))


def _pair(qat: bool = False):
    """(JAX model, JAX variables, port model) of the tiny STDiT in float32
    on equal weights (numpy draws x 0.1, seed 0); qat: under JAX's QAT
    spec, the weight tables calibrated by the JAX package and bridged."""
    jres, pres = _qat_resolvers() if qat else (None, None)
    jm = JSTDiT(dtype=jnp.float32, resolver=jres, **TINY) if qat else \
        JSTDiT(dtype=jnp.float32, **TINY)
    b = _batch()
    v = dict(jax.jit(functools.partial(jm.init, qctx=JQuantCtx(mode="fp")))(
        jax.random.PRNGKey(0), b["x0"], b["t"].astype(np.float32), b["y"],
        b["mask"]))
    v["params"] = randomize(v["params"], 0, 0.1)
    kw = {"resolver": pres} if qat else {}
    pm = STDiT(dtype=torch.float32, **TINY, **kw)
    if qat:
        v["quant"] = jax.tree.map(np.asarray, j_calibrate(
            v["params"], v["quant"], jres))
        pm.load_state_dict(state_dict_from_flax(v["params"], v["quant"]))
    else:
        v.pop("quant", None)
        pm.load_state_dict(state_dict_from_flax(v["params"]))
    return jm, v, pm.eval()


@pytest.fixture(scope="module")
def pair():
    """The fp pair (`_pair`), built once for the module."""
    return _pair()


@pytest.fixture(scope="module")
def qat_pair():
    return _pair(qat=True)


def _flat(tree):
    """A flax tree as {port name: array} (the bridge's names and
    layouts)."""
    return {k: v.numpy() for k, v in state_dict_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def _grad_errs(got, want):
    """{name: rel err in norm} over the tensors above GRAD_FLOOR of the
    largest gradient norm."""
    top = max(np.linalg.norm(w) for w in want.values())
    return {k: rel_err(got[k], w) for k, w in want.items()
            if np.linalg.norm(w) > GRAD_FLOOR * top}


def _assert_step(got, want, before, grads, lr, what,
                 param_rel=STEP_PARAM_REL):
    """One AdamW step's parameters (module docstring): within
    STEP_PARAM_REL in norm, their moves at cosine > STEP_COS; a tensor
    whose gradient `_grad_errs` leaves out (rounding noise: the q.k
    softmax does not depend on k's bias) moves by at most lr an
    element."""
    for k, w in want.items():
        g = got[k]
        if k not in grads:
            assert np.abs(g - before[k]).max() <= lr * (1 + 1e-3), (what, k)
            continue
        assert rel_err(g, w) <= param_rel, (what, k, rel_err(g, w))
        dg, dw = (g - before[k]).ravel(), (w - before[k]).ravel()
        if np.linalg.norm(dw) > 0:
            cos = float(dg @ dw / (np.linalg.norm(dg) * np.linalg.norm(dw)))
            assert cos > STEP_COS, (what, k, cos)


@pytest.fixture(scope="module")
def jax_step(pair):
    """The JAX package's make_train_step (lr LR, grad_clip 1.0), one step
    jitted on the kernel path, and the noise it drew."""
    jm, v, _ = pair
    sched = j_make_schedule(timestep_respacing=[1000])
    opt = jtr.make_optimizer(lr=LR, grad_clip=1.0)
    b = _batch()
    rng = jax.random.PRNGKey(3)
    step = jax.jit(jtr.make_train_step(jm, sched, opt, ema_decay=0.9))
    with jax_kernel_path():
        p1, e1, o1, loss = step(v["params"], v["params"],
                                opt.init(v["params"]), b, rng)
    noise = np.asarray(jax.random.normal(rng, b["x0"].shape, jnp.float32))

    def loss_fn(p):
        def model_fn(x_t, tt):
            return jm.apply({"params": p}, x_t, tt, b["y"], b["mask"])
        return j_training_losses(model_fn, b["x0"], b["t"], noise, sched, 4)

    with jax_kernel_path():
        l0, g0 = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    return {"loss": float(loss), "params": _flat(p1), "ema": _flat(e1),
            "mu": _flat(o1[1][0].mu), "noise": noise, "value": float(l0),
            "grads": _flat(g0), "batch": b}


def test_training_losses_and_gradients_match_jax(pair, jax_step):
    """training_losses and every parameter's gradient on the tiny STDiT
    against jax.value_and_grad, on JAX's noise."""
    _, _, pm = pair
    b, sched = _t(jax_step["batch"]), make_schedule(
        timestep_respacing=[1000])
    loss = training_losses(
        lambda x_t, tt: pm(x_t, tt, b["y"], b["mask"]), b["x0"], b["t"],
        torch.from_numpy(jax_step["noise"].copy()), sched, 4)
    assert abs(float(loss.detach()) / jax_step["value"] - 1) <= LOSS_REL
    # the null caption embedding takes no part (JAX: a zero gradient)
    grads = torch.autograd.grad(loss, list(pm.parameters()),
                                allow_unused=True)
    got = {n: np.zeros(tuple(p.shape), np.float32) if g is None
           else g.numpy() for (n, p), g in zip(pm.named_parameters(), grads)}
    assert [n for n, g in got.items() if not g.any()] == [
        "y_embedder.y_embedding"]
    assert got.keys() == jax_step["grads"].keys()
    errs = _grad_errs(got, jax_step["grads"])
    assert len(errs) > 0.9 * len(got)
    assert max(errs.values()) <= GRAD_REL, max(errs.items(),
                                               key=lambda kv: kv[1])


def test_train_step_matches_jax(pair, jax_step):
    """One whole make_train_step step (clip 1.0, AdamW, EMA 0.9): the
    loss, the gradients in Adam's first moment, the parameters and the
    EMA."""
    _, _, pm = pair
    model = _copy(pm)
    params = tr.trainable(model)
    before = {n: p.detach().numpy().copy() for n, p in params.items()}
    opt = tr.make_optimizer(lr=LR, grad_clip=1.0)
    ema, state = tr.init_ema(params), opt.init(params)
    noise = torch.from_numpy(jax_step["noise"].copy())
    step = tr.make_train_step(model, make_schedule(timestep_respacing=[
        1000]), opt, ema_decay=0.9, noise_fn=lambda shape, i: noise)
    loss = step(ema, state, _t(jax_step["batch"]))
    assert abs(float(loss) / jax_step["loss"] - 1) <= LOSS_REL
    assert state["count"] == 1
    mu = {n: m.numpy() for n, m in state["mu"].items()}
    errs = _grad_errs(mu, jax_step["mu"])
    assert max(errs.values()) <= GRAD_REL
    got = {n: p.detach().numpy() for n, p in params.items()}
    _assert_step(got, jax_step["params"], before, errs, LR, "params")
    # the EMA at 0.9 moves a tenth of the step
    _assert_step({n: e.numpy() for n, e in ema.items()}, jax_step["ema"],
                 before, errs, LR / 10, "ema")


def _copy(model):
    import copy
    return copy.deepcopy(model)


def _optax_run(params, grads, **kw):
    opt = jtr.make_optimizer(**kw)
    state = opt.init(params)
    out = []
    for g in grads:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append((jax.tree.map(np.asarray, params), state))
    return out


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_matches_optax(weight_decay):
    """make_optimizer against the JAX package's optax chain on one given
    sequence of 5 gradients, clipping triggered at steps 1, 2 and 4 and a
    warmup of 2 (the first step's rate is 0: the identity)."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8), "b": (8,), "c": (3, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    scales = [3.0, 2.0, 0.05, 4.0, 0.1]  # global norms ~ 3x, 2x, ..
    grads = [{k: (rng.standard_normal(s) * sc / 5).astype(np.float32)
              for k, s in shapes.items()} for sc in scales]
    kw = dict(lr=1e-2, weight_decay=weight_decay, grad_clip=0.5,
              warmup_steps=2)
    want = _optax_run(params, grads, **kw)
    opt = tr.make_optimizer(**kw)
    p = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()}
    state = opt.init(p)
    for i, g in enumerate(grads):
        for k, v in g.items():
            p[k].grad = torch.from_numpy(v.copy())
        opt.step(p, state)
        wp, ws = want[i]
        adam = ws[1][0]
        assert state["count"] == int(adam.count) == i + 1
        for k in shapes:
            got = p[k].detach().numpy()
            if i == 0:  # warmup's first rate is 0
                assert np.array_equal(got, params[k])
            np.testing.assert_allclose(got, wp[k], rtol=OPT_REL,
                                       atol=OPT_REL * 1e-2)
            # the moments take the clipped gradients, whose global norm
            # sums in another order: held in norm
            assert rel_err(state["mu"][k], adam.mu[k]) <= OPT_REL
            assert rel_err(state["nu"][k], adam.nu[k]) <= OPT_REL
    norms = [np.sqrt(sum((v ** 2).sum() for v in g.values())) for g in grads]
    assert [n >= 0.5 for n in norms] == [True, True, False, True, False]


def test_optimizer_state_has_one_structure():
    """The state is the same with and without clipping and warmup, so a
    checkpoint restores across those settings (training.py:33-39)."""
    p = {"w": torch.nn.Parameter(torch.ones(3))}
    states = [tr.make_optimizer(grad_clip=c, warmup_steps=w).init(p)
              for c in (0.0, 1.0) for w in (0, 5)]
    for s in states:
        assert s.keys() == {"count", "mu", "nu"}
        assert s["mu"].keys() == s["nu"].keys() == {"w"}


@pytest.mark.parametrize("decay", [0.9999, 0.9])
def test_update_ema_matches_jax(decay):
    rng = np.random.default_rng(1)
    e = {"a": rng.standard_normal((64, 33)).astype(np.float32)}
    p = {"a": rng.standard_normal((64, 33)).astype(np.float32)}
    want = np.asarray(jtr.update_ema(e, p, decay)["a"])
    got = tr.update_ema({"a": torch.from_numpy(e["a"].copy())},
                        {"a": torch.from_numpy(p["a"])}, decay)["a"]
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


class _Recorder:
    """An optimizer stand-in that keeps the gradients a step hands it."""

    def __init__(self):
        self.grads = None

    def step(self, params, state):
        self.grads = {n: None if p.grad is None else p.grad.clone()
                      for n, p in params.items()}
        return state


def test_grad_accum_matches_manual_microbatching(pair):
    """grad_accum=2: the mean of the two microbatches' gradients and
    losses, each microbatch on its own noise, before one update."""
    _, _, pm = pair
    model = _copy(pm)
    b = _t(_batch(4, seed=5))
    noises = [torch.randn((2, 4, *LATENT), generator=torch.Generator(
        ).manual_seed(i)) for i in range(2)]
    rec = _Recorder()
    sched = make_schedule(timestep_respacing=[1000])
    params = tr.trainable(model)
    step = tr.make_train_step(model, sched, rec, grad_accum=2,
                              noise_fn=lambda shape, i: noises[i])
    loss = step(tr.init_ema(params), {}, b)
    want, wl = None, 0.0
    for i in range(2):
        mb = {k: v[2 * i:2 * i + 2] for k, v in b.items()}
        li = training_losses(lambda x, t: model(x, t, mb["y"], mb["mask"]),
                             mb["x0"], mb["t"], noises[i], sched, 4)
        gi = torch.autograd.grad(li, list(params.values()),
                                 materialize_grads=True)
        want = gi if want is None else [a + c for a, c in zip(want, gi)]
        wl = wl + li.detach()
    assert torch.equal(loss, wl / 2)
    for (n, _), w in zip(params.items(), want):
        g = rec.grads[n]
        assert torch.equal(torch.zeros_like(w) if g is None else g, w / 2), n
    with pytest.raises(ValueError, match="not divisible"):
        step(tr.init_ema(params), {}, {k: v[:3] for k, v in b.items()})


def test_grad_accum_step_matches_jax(pair):
    """grad_accum=2 against the JAX package's scanned step (each
    microbatch on the noise JAX draws from its split key)."""
    jm, v, pm = pair
    b = _batch(4, seed=5)
    rng = jax.random.PRNGKey(11)
    sched = j_make_schedule(timestep_respacing=[1000])
    opt = jtr.make_optimizer(lr=LR, grad_clip=1.0)
    step = jax.jit(jtr.make_train_step(jm, sched, opt, grad_accum=2))
    with jax_kernel_path():
        p1, _, o1, loss = step(v["params"], v["params"],
                               opt.init(v["params"]), b, rng)
    keys = jax.random.split(rng, 2)
    noises = [torch.from_numpy(np.asarray(jax.random.normal(
        keys[i], (2, 4, *LATENT), jnp.float32))) for i in range(2)]
    model = _copy(pm)
    params = tr.trainable(model)
    before = {n: p.detach().numpy().copy() for n, p in params.items()}
    popt = tr.make_optimizer(lr=LR, grad_clip=1.0)
    state = popt.init(params)
    pstep = tr.make_train_step(model, make_schedule(timestep_respacing=[
        1000]), popt, grad_accum=2, noise_fn=lambda shape, i: noises[i])
    got_loss = pstep(tr.init_ema(params), state, _t(b))
    assert abs(float(got_loss) / float(loss) - 1) <= LOSS_REL
    errs = _grad_errs({n: m.numpy() for n, m in state["mu"].items()},
                      _flat(o1[1][0].mu))
    assert max(errs.values()) <= GRAD_REL
    _assert_step({n: p.detach().numpy() for n, p in params.items()},
                 _flat(p1), before, errs, LR, "params")


def test_qat_step_matches_jax(qat_pair):
    """make_qat_step on JAX's QAT spec (W8 per-channel and A8 dynamic
    per-token, both 'nearest_ste'; five layers fp) with JAX's weight
    tables: one step's loss and gradients (STE through the fake
    quantizers) against the JAX package's."""
    jm, v, pm = qat_pair
    b = _batch()
    sched = j_make_schedule(timestep_respacing=[1000])
    opt = jtr.make_optimizer(lr=LR)
    rng = jax.random.PRNGKey(42)
    step = jax.jit(jtr.make_qat_step(
        jm, sched, opt, JQuantCtx(mode="quant", t_id=jnp.asarray(500))))
    with jax_kernel_path():
        p1, _, o1, loss = step(v["params"], v["quant"], v["params"],
                               opt.init(v["params"]), b, rng)
    noise = torch.from_numpy(np.asarray(jax.random.normal(
        rng, b["x0"].shape, jnp.float32)))
    model = _copy(pm)
    params = tr.trainable(model)
    before = {n: p.detach().numpy().copy() for n, p in params.items()}
    popt = tr.make_optimizer(lr=LR)
    state = popt.init(params)
    qstep = tr.make_qat_step(model, make_schedule(timestep_respacing=[1000]),
                             popt, QuantCtx(mode="quant", t_id=500),
                             noise_fn=lambda shape, i: noise)
    got = qstep(tr.init_ema(params), state, _t(b))
    assert abs(float(got) / float(loss) - 1) <= QAT_LOSS_REL
    errs = _grad_errs({n: m.numpy() for n, m in state["mu"].items()},
                      _flat(o1[1][0].mu))
    assert max(errs.values()) <= QAT_GRAD_REL
    _assert_step({n: p.detach().numpy() for n, p in params.items()},
                 _flat(p1), before, errs, LR, "params",
                 param_rel=QAT_PARAM_REL)


def test_qat_loss_falls_through_ste():
    """8 QAT steps (lr 2e-3) on one batch and one noise draw, on the JAX
    test's model (a 2x8x8 latent, C 32, one block): the loss falls, and
    the fake-quantized weights move (test_parallel.py:77-122)."""
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.utils.workload import random_init_
    model = STDiT(input_size=(2, 8, 8), hidden_size=32, depth=1,
                  num_heads=4, caption_channels=16, model_max_length=4,
                  dtype=torch.float32, resolver=_qat_resolvers()[1])
    random_init_(model, 0, 0.1)
    calibrate_weight_tables(model)
    params = tr.trainable(model)
    opt = tr.make_optimizer(lr=2e-3)
    state, ema = opt.init(params), tr.init_ema(params)
    g = torch.Generator().manual_seed(0)
    b = {"x0": torch.randn((2, 4, 2, 8, 8), generator=g),
         "t": torch.tensor([1, 5]),
         "y": torch.randn((2, 1, 4, 16), generator=g),
         "mask": torch.ones((2, 4), dtype=torch.int32)}
    noise = torch.randn((2, 4, 2, 8, 8), generator=g)
    step = tr.make_qat_step(model, make_schedule(num_sampling_steps=10),
                            opt, QuantCtx(mode="quant", t_id=500),
                            noise_fn=lambda shape, i: noise)
    fc1 = model.blocks[0].mlp.fc1
    w0 = _fake_quant_weight(fc1)
    losses = [float(step(ema, state, b)) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert not torch.equal(_fake_quant_weight(fc1), w0)


def _fake_quant_weight(layer):
    from viditq_tpu_torch.quant import core
    spec = layer.lspec.weight
    return core.fake_quant(layer.kernel.detach().float(),
                           layer.w_delta[spec.bit_idx, 0],
                           layer.w_zp[spec.bit_idx, 0], spec)


@pytest.mark.parametrize("kind", ["stdit", "sigma", "latte"])
def test_grad_checkpoint_equals_plain(kind):
    """grad_checkpoint=True gives the loss and every gradient of False
    exactly, and runs each block's forward twice (forward, recompute);
    PixArt-Σ with KV compression (tiny Σ's block 1), Latte with its
    spatial and temporal blocks."""
    _, pcls, cfg, latent = KINDS[kind]
    x, _, y, mask = inputs(kind=kind)
    b = _t({"x0": x, "t": T_IDS.astype(np.int64), "y": y, "mask": mask})
    noise = torch.randn(b["x0"].shape,
                        generator=torch.Generator().manual_seed(1))
    sched = make_schedule(timestep_respacing=[1000])
    out = []
    for gc in (False, True):
        torch.manual_seed(0)
        model = pcls(dtype=torch.float32, grad_checkpoint=gc, **cfg)
        from viditq_tpu_torch.utils.workload import random_init_
        random_init_(model, 0, 0.1)
        calls = []
        for blk in model.blocks:  # module hooks do not see the recompute
            blk.forward = _counted(blk.forward, calls)
        loss = training_losses(
            lambda xt, tt: model(xt, tt, b["y"], b["mask"]), b["x0"],
            b["t"], noise, sched, 4)
        grads = torch.autograd.grad(loss, list(model.parameters()),
                                    materialize_grads=True)
        out.append((loss, grads, len(calls)))
    (l0, g0, c0), (l1, g1, c1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, c) for a, c in zip(g0, g1))
    assert (c0, c1) == (len(model.blocks), 2 * len(model.blocks))


def _counted(fn, calls):
    def run(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    return run


TRAIN_KW = dict(latent_shape=(4, *LATENT), caption_shape=(1, 8, 32),
                lr=1e-3, log_every=0, grad_clip=1.0)


def test_resume_equals_uninterrupted(pair, tmp_path):
    """4 synthetic steps with a checkpoint every 2 against 2 steps resumed
    from the step-2 file: parameters, EMA and optimizer state equal;
    the meta's counters and the step losses too."""
    _, _, pm = pair
    full = train_loop(_copy(pm), None, num_steps=4, ckpt_every=2,
                      save_dir=str(tmp_path / "a"), **TRAIN_KW)
    resumed = train_loop(_copy(pm), None, num_steps=4,
                         resume_from=str(tmp_path / "a" / "train_state_2.pt"),
                         save_dir=str(tmp_path / "b"), **TRAIN_KW)
    assert resumed["meta"] == {"epoch": 0, "step": 2, "global_step": 2}
    assert full["ckpt"].endswith("train_state_4.pt")
    for k in ("params", "ema"):
        for n, v in full[k].items():
            assert torch.equal(v, resumed[k][n]), (k, n)
    assert full["opt_state"]["count"] == resumed["opt_state"]["count"] == 4
    for n, v in full["opt_state"]["mu"].items():
        assert torch.equal(v, resumed["opt_state"]["mu"][n])
    assert torch.equal(full["step_losses"][2:], resumed["step_losses"])
    assert full["step_losses"].shape == (4,)


class _DictDataset:
    """Items of train batches ('t' a spaced-step id of the 1000 steps)."""

    def __init__(self, n):
        r = np.random.default_rng(9)
        self.items = [{"x0": r.standard_normal((4, *LATENT)).astype(
            np.float32), "t": int(r.integers(0, 1000)),
            "y": r.standard_normal((1, 8, 32)).astype(np.float32),
            "mask": np.ones((8,), np.int32)} for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class _VideoDataset(_DictDataset):
    """Raw items for make_encode_batch: latents as 'video', no caption."""

    def __init__(self, n):
        super().__init__(n)
        self.items = [{"video": it["x0"]} for it in self.items]


@pytest.mark.parametrize("case", ["mid_epoch", "rollover", "encode"])
def test_train_entry_resume(pair, tmp_path, case):
    """train_entry resumed from its step-2 checkpoint equals the
    uninterrupted run (torch.equal): mid-epoch (the sampler's start index
    in the meta; 8 items, 4 steps an epoch), at an epoch's end (4 items,
    2 steps an epoch, 2 epochs: the resume starts epoch 1), and with
    make_encode_batch's draws (its step index continues at the resume
    point; null captions)."""
    _, _, pm = pair
    ds, epochs, kw = _DictDataset(8), 1, dict(TRAIN_KW)
    if case == "rollover":
        ds, epochs = _DictDataset(4), 2
    if case == "encode":
        ds = _VideoDataset(8)
        kw["encode_batch"] = make_encode_batch(null_caption_shape=(1, 8, 32))
    full = train_entry(_copy(pm), ds, epochs=epochs, batch_size=2,
                       ckpt_every=2, save_dir=str(tmp_path / "a"), **kw)
    resumed = train_entry(
        _copy(pm), ds, epochs=epochs, batch_size=2,
        resume_from=str(tmp_path / "a" / "train_state_2.pt"),
        save_dir=str(tmp_path / "b"), **kw)
    for k in ("params", "ema"):
        for n, v in full[k].items():
            assert torch.equal(v, resumed[k][n]), (k, n)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n,seed,epoch,rank,world,start", [
    (10, 0, 0, 0, 1, 0), (11, 3, 2, 1, 2, 2), (17, 5, 1, 2, 4, 1)])
def test_stateful_sampler_order_matches_jax(n, seed, epoch, rank, world,
                                            start, shuffle):
    """The port's copy of StatefulSampler gives the JAX sampler's order,
    its resume state and its batches."""
    samplers = []
    for cls in (JStatefulSampler, StatefulSampler):
        s = cls(n, shuffle=shuffle, seed=seed, rank=rank, world=world)
        s.set_epoch(epoch)
        s.set_start_index(start)
        samplers.append(s)
    j, p = samplers
    assert p.state_dict(3) == j.state_dict(3)
    assert [int(i) for i in p] == [int(i) for i in j]
    assert p.start_index == j.start_index == 0  # the resume point is spent
    ds = [{"v": np.full((2,), i, np.float32), "s": f"item{i}"}
          for i in range(n)]
    jb = list(j_batch_iterator(ds, j, 3))
    pb = list(batch_iterator(ds, p, 3))
    assert len(jb) == len(pb) > 0
    for a, c in zip(jb, pb):
        assert np.array_equal(a["v"], c["v"]) and a["s"] == c["s"]


def test_make_encode_batch_paths():
    """Null captions of null_caption_shape with an all-ones mask; the
    batch's own captions; a text encoder's; a VAE's posterior mean of the
    batch's pixels (a VAE raised until it was ported)."""
    video = np.zeros((2, 4, *LATENT), np.float32)
    enc = make_encode_batch(null_caption_shape=(1, 8, 32))
    out = enc({"video": video}, 3)
    assert out["y"].shape == (2, 1, 8, 32) and not out["y"].any()
    assert out["mask"].dtype == torch.int32 and bool(out["mask"].all())
    assert torch.equal(out["t"], enc({"video": video}, 3)["t"])
    assert out["t"].min() >= 0 and out["t"].max() < 1000

    class Text:
        def encode(self, prompts):
            return {"y": torch.ones((len(prompts), 1, 8, 32)),
                    "mask": torch.ones((len(prompts), 8))}
    out = make_encode_batch(text_encoder=Text())(
        {"video": video, "text": ["a", "b"]}, 0)
    assert bool(out["y"].all())
    from viditq_tpu_torch.models.vae import Encoder, VideoAutoencoderKL
    vae = VideoAutoencoderKL(decoder=False).eval()
    vae.module.encoder = Encoder(block_out_channels=(32, 32),
                                 layers_per_block=1)
    pixels = np.random.default_rng(2).uniform(
        -1, 1, (2, 3, 2, 8, 8)).astype(np.float32)
    out = make_encode_batch(vae=vae, null_caption_shape=(1, 8, 32))(
        {"video": pixels}, 3)
    with torch.no_grad():
        want = vae.encode(torch.from_numpy(pixels))
    assert out["x0"].shape == (2, 4, 2, 4, 4) and not out["x0"].requires_grad
    assert torch.equal(out["x0"], want)
    assert out["y"].shape == (2, 1, 8, 32)


def test_loss_second_moment_step(pair):
    """make_train_step with the loss-second-moment sampler: a finite
    loss, the state holding this batch's two losses; grad_accum refuses
    it; an unknown sampler name raises."""
    _, _, pm = pair
    model = _copy(pm)
    params = tr.trainable(model)
    opt = tr.make_optimizer()
    sched = make_schedule(num_sampling_steps=8)
    step = tr.make_train_step(model, sched, opt, loss_type="rescaled_mse",
                              schedule_sampler="loss-second-moment")
    sstate = step.init_sampler_state()
    loss, sstate = step(tr.init_ema(params), opt.init(params), _t(_batch()),
                        torch.Generator().manual_seed(1), sstate)
    assert np.isfinite(float(loss))
    assert int(sstate.counts.sum()) == 2
    with pytest.raises(ValueError, match="grad_accum"):
        tr.make_train_step(model, sched, opt, grad_accum=2,
                           schedule_sampler="loss-second-moment")
    with pytest.raises(NotImplementedError, match="schedule sampler"):
        tr.make_train_step(model, sched, opt, schedule_sampler="lossy")
