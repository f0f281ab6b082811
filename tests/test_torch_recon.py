"""AdaRound reconstruction (`viditq_tpu_torch/quant/reconstruction.py`) and
the `ptq` command that runs it, against the JAX package's, on the same
weights and data (numpy draws from a seed).

The JAX package draws its minibatch rows with threefry; the port cannot
reproduce those draws, so each comparison is made where the draw cannot
matter or is pinned:
  * the functions on captured rows that are one row repeated (every draw
    is that row);
  * `ptq` at block granularity (`w4a8_adaround.yaml` as written, iters cut
    to 10) on calibration data whose two CFG rows are made equal, so
    every minibatch of the block input is one row repeated;
  * `ptq` at layer granularity (a copy with `granularity: layer`): a
    layer's rows are its tokens, which differ, so both packages' draws are
    pinned to rows 0..bs-1 (JAX's `jax.random.randint` and the port's
    `_draw` patched alike);
  * on random rows, the pieces: the loss, its gradient with respect to
    alpha and one Adam step.

The CLI runs take weights at 0.02 (the bench's scale, as
`tests/test_torch_analysis.py` does): at 0.1 the kernel path's bf16 q.k
rounds a few scores the other way in the two packages, the block inputs
after the first attention part by ~1e-3, and Adam's sign-like first steps
(±lr whatever the gradient's size) carry that into the alphas: their
moves then agreed to 8.5e-2 on one draw of the data, against 1e-5 at
0.02.

Tolerances, each with its reason. The loss and its gradient agree to f32
summation order (1e-5 relative); the reconstruction error alone, ~1e-4
before the warmup's end, to 1e-7 absolute where the act step size is
learned (an act code at a rounding tie flips with the step size's last
ulp).
Adam divides each update by the root of its own squared gradient, so an
entry whose gradient is near zero takes a step of up to lr whichever
sign its rounding noise gives it: the learned alphas are held by how much
of their move from the initial alpha agrees (the norm of the difference
over the norm of the move: `MOVE_REL`, 1e-2; readings 7e-6 to 3e-5, and
2.9e-3 where the act step size is learned too), by the hard rounding (alpha >= 0)
agreeing at all but `FLIP_FRAC` of the entries, and by no entry parting by
more than 2 * lr * iters; a learned act step size by its move too. One
Adam step from the same gradient: the new alphas within 2 ulp of the
largest (`optax.adam` and `torch.optim.Adam` order the float operations
otherwise). Weight tables (w_delta, w_zp): equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from test_torch_cli import (STDIT_CFG, _run, _weights, kernel_path_config,
                            port_noise)
from torch_parity import rel_err
from viditq_tpu import cli as j_cli
from viditq_tpu.pipelines import analysis as janalysis
from viditq_tpu.quant import core as jcore
from viditq_tpu.quant import reconstruction as JR
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines import analysis
from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant import reconstruction as R
from viditq_tpu_torch.quant.qlinear import QuantLinear
from viditq_tpu_torch.utils.config import load_quant_config

ADAROUND = "configs/opensora/w4a8_adaround.yaml"
ITERS = 10
# the CLI runs' weights (header)
WEIGHT_SCALE = 0.02
MOVE_REL = 1e-2
FLIP_FRAC = 1e-3
LOSS_REL = 1e-5
LOSS_ATOL = 1e-7
ADAM_ULP = 2
DENOISE_REL = 2e-2


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def plan_copy(tmp, name, granularity="block", iters=ITERS, optimize=True):
    """A copy of the AdaRound plan: its iterations cut, its granularity
    set, or (optimize False) no optimisation section."""
    with open(ADAROUND) as f:
        y = yaml.safe_load(f)
    opt = y["quant"]["weight"]["optimization"]
    opt.update(iters=iters, granularity=granularity)
    if not optimize:
        y["quant"]["weight"]["optimization"] = None
    path = str(tmp / name)
    with open(path, "w") as f:
        yaml.safe_dump(y, f)
    return path


def assert_alphas_close(got, want, init, lr, iters, what=""):
    """The learned alphas (see the header): the move from init agrees to
    MOVE_REL, the hard rounding at all but FLIP_FRAC, no entry parts by
    more than 2 * lr * iters."""
    got, want, init = (np.asarray(a, np.float64) for a in (got, want, init))
    move = np.linalg.norm(want - init)
    assert move > 0, what
    assert np.linalg.norm(got - want) / move <= MOVE_REL, (
        what, np.linalg.norm(got - want) / move)
    assert ((got >= 0) != (want >= 0)).mean() <= FLIP_FRAC, what
    assert np.abs(got - want).max() <= 2 * lr * iters, what


def _ckpt(d):
    data = np.load(os.path.join(d, "quant_ckpt.npz"))
    return {k: data[k] for k in data.files if k != "__meta__"}


def _pinned_draws(mp):
    """Both packages' minibatch rows pinned to 0..bs-1 (mod n)."""
    mp.setattr(jax.random, "randint",
               lambda key, shape, minval, maxval, dtype=jnp.int32:
               jnp.arange(shape[0], dtype=dtype) % maxval)
    mp.setattr(R, "_draw", lambda g, n, bs, device: torch.arange(bs) % n)


@pytest.fixture(scope="module")
def ptq_runs(tmp_path_factory):
    """Both CLIs' `ptq` on the AdaRound plan at block and at layer
    granularity, and the port's without reconstruction (the initial
    alphas), on the port's `get-calib-data` (the file crosses to JAX) with
    its CFG rows made equal: {name: output directory}."""
    tmp = tmp_path_factory.mktemp("recon_cli")
    config = kernel_path_config(STDIT_CFG, tmp)
    jpath, ppath, z = _weights(config, tmp, seed=1, scale=WEIGHT_SCALE)
    d = {k: str(tmp / k) for k in ("jcal", "jblock", "pblock", "jlayer",
                                   "player", "pinit")}
    _run(cli.main, "get-calib-data", config, d["jcal"], ppath,
         "--num_samples", "1")
    cal = os.path.join(d["jcal"], "calib_data.npz")
    data = dict(np.load(cal))
    data["xs"][:, 1] = data["xs"][:, 0]
    data["ts"][:, 1] = data["ts"][:, 0]
    data["y"][1] = data["y"][0]
    np.savez(cal, **data)
    plans = {"block": plan_copy(tmp, "block.yaml"),
             "layer": plan_copy(tmp, "layer.yaml", "layer"),
             "none": plan_copy(tmp, "none.yaml", optimize=False)}
    out = {}
    for gran in ("block", "layer"):
        args = ("--ptq_config", plans[gran], "--calib_data", cal)
        with pytest.MonkeyPatch.context() as mp:
            if gran == "layer":
                _pinned_draws(mp)
            _run(j_cli.main, "ptq", config, d["j" + gran], jpath, *args)
            out[gran] = _run(cli.main, "ptq", config, d["p" + gran], ppath,
                             *args)
    _run(cli.main, "ptq", config, d["pinit"], ppath, "--ptq_config",
         plans["none"], "--calib_data", cal)
    return {"dirs": d, "plans": plans, "config": config, "jpath": jpath,
            "ppath": ppath, "z": z, "cal": cal, "out": out}


@pytest.mark.parametrize("gran", ["block", "layer"])
def test_cli_ptq_alphas_match_jax(ptq_runs, gran):
    d = ptq_runs["dirs"]
    jt, pt, init = (_ckpt(d["j" + gran]), _ckpt(d["p" + gran]),
                    _ckpt(d["pinit"]))
    assert jt.keys() == pt.keys() == init.keys()
    alphas = sorted(k for k in jt if k.endswith("::w_alpha"))
    # every quantized linear of both blocks, fp-listed layers excepted
    assert len(alphas) == 2 * 13
    plan = load_quant_config(ptq_runs["plans"][gran])
    lr = plan.weight_opt.alpha_lr
    for k, v in jt.items():
        if k in alphas:
            if gran == "layer" and "kv_linear" in k:
                # layer reconstruction skips the kv linear: its init
                np.testing.assert_array_max_ulp(pt[k], v, maxulp=4)
                assert np.array_equal(pt[k], init[k])
                continue
            assert_alphas_close(pt[k], v, init[k], lr, ITERS, k)
        else:
            assert np.array_equal(pt[k], v), k
    out = ptq_runs["out"][gran]
    assert out["recon_seconds"] > 0
    if gran == "block":
        assert len(out["recon_timings"]["block_s"]) == 2
        assert len(out["recon_timings"]["capture_s"]) == 2


def test_quant_generate_both_backends_keep_the_learned_rounding(ptq_runs,
                                                                tmp_path):
    """quant-generate from the block checkpoint on the simulate and the
    native backend (K7a -> K7b, the slabs packed with floor + (alpha >=
    0)); the JAX CLI samples from the port's checkpoint (the file crosses
    to JAX) within the denoise tolerance."""
    from viditq_tpu_torch.quant.native_pack import pack_native_weights
    from viditq_tpu_torch.utils import ckpt, workload
    d = ptq_runs["dirs"]
    qck = os.path.join(d["pblock"], "quant_ckpt.npz")
    common = ("--num_samples", "1", "--ptq_config", ptq_runs["plans"]["block"],
              "--quant_ckpt", qck)
    with port_noise(ptq_runs["z"]):
        for backend in ("simulate", "native"):
            _run(cli.main, "quant-generate", ptq_runs["config"],
                 str(tmp_path / backend), ptq_runs["ppath"], *common,
                 "--backend", backend)
    _run(j_cli.main, "quant-generate", ptq_runs["config"],
         str(tmp_path / "jax"), ptq_runs["jpath"], *common)
    sim, nat, jgen = (np.load(str(tmp_path / n / "quant_samples.npz"))[
        "samples"] for n in ("simulate", "native", "jax"))
    assert np.isfinite(nat).all() and sim.shape == nat.shape
    assert rel_err(nat, sim) <= DENOISE_REL
    assert rel_err(sim, jgen) <= DENOISE_REL
    # the packed codes are the learned hard rounding, not nearest
    cfg = workload.load_py_config(ptq_runs["config"])
    plan = load_quant_config(ptq_runs["plans"]["block"]).with_backend(
        "native")
    model = workload.build_model(cfg, plan.resolver(), device="cpu")
    ckpt.load_params_into(model, ptq_runs["ppath"])
    ckpt.load_quant_ckpt(qck, model)
    lin = model.blocks[0].mlp.fc1
    with torch.no_grad():  # every alpha flipped: rounds against nearest
        lin.w_alpha.neg_()
    pack_native_weights(model)
    d0 = lin.w_delta[0, 0]
    want = (torch.floor(lin.kernel / d0) + (lin.w_alpha >= 0).float()
            + lin.w_zp[0, 0]).clamp(0, 15) - 8
    assert torch.equal(lin.w_int[0].float(), want)
    nearest = (torch.round(lin.kernel / d0) + lin.w_zp[0, 0]).clamp(0, 15) - 8
    assert not torch.equal(want, nearest)


def test_resume_and_load_a_jax_w_alpha_checkpoint(ptq_runs, tmp_path):
    """A JAX-written quant_ckpt.npz holding w_alpha: `ptq
    --resume_with_w_quantized` takes its weight tables and alphas as they
    are, and `quant-generate` with it samples what the resumed file
    gives."""
    d = ptq_runs["dirs"]
    jfile = os.path.join(d["jblock"], "quant_ckpt.npz")
    cli.main(["ptq", "--config", ptq_runs["config"], "--save_dir",
              str(tmp_path / "res"), "--ckpt_path", ptq_runs["ppath"],
              "--device", "cpu", "--ptq_config", ptq_runs["plans"]["none"],
              "--calib_data", ptq_runs["cal"], "--resume_with_w_quantized",
              jfile])
    got, want = _ckpt(str(tmp_path / "res")), _ckpt(d["jblock"])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    common = ("--num_samples", "1", "--ptq_config", ptq_runs["plans"]["none"])
    with port_noise(ptq_runs["z"]):
        for name, f in (("j", jfile), ("r", str(tmp_path / "res" /
                                                "quant_ckpt.npz"))):
            _run(cli.main, "quant-generate", ptq_runs["config"],
                 str(tmp_path / name), ptq_runs["ppath"], *common,
                 "--quant_ckpt", f)
    a, b = (np.load(str(tmp_path / n / "quant_samples.npz"))["samples"]
            for n in ("j", "r"))
    assert np.array_equal(a, b)


def _repeated_rows(seed, k, f, n=48):
    """(kernel [k, f], bias [f], x [n, k], y [n, f]): one input row
    repeated n times and its fp output."""
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((k, f)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(f) * 0.1).astype(np.float32)
    row = rng.standard_normal((1, k)).astype(np.float32)
    x = np.repeat(row, n, axis=0)
    return kernel, bias, x, x @ kernel + bias


def _cfgs(**kw):
    base = dict(iters=20, batch_size=8, lr_alpha=1e-2, lambda_coeff=0.01,
                warmup=0.2)
    base.update(kw)
    return JR.ReconConfig(**base), R.ReconConfig(**base)


@pytest.mark.parametrize("target", ["weight", "weight_and_activation"])
def test_layer_reconstruction_matches_jax(target):
    jl = j_load(ADAROUND).default_layer
    pl = load_quant_config(ADAROUND).default_layer
    if target == "weight_and_activation":  # a static act: its step learned
        jl = dataclasses.replace(jl, act=dataclasses.replace(
            jl.act, dynamic=False))
        pl = dataclasses.replace(pl, act=dataclasses.replace(
            pl.act, dynamic=False))
    kernel, bias, x, y = _repeated_rows(10, 48, 40)
    jcfg, pcfg = _cfgs(opt_target=target, lr_delta=1e-3)
    want = JR.layer_reconstruction(jnp.asarray(kernel), jnp.asarray(bias),
                                   jnp.asarray(x), jnp.asarray(y), jl, jcfg)
    got = R.layer_reconstruction(t(kernel), t(bias), t(x), t(y), pl, pcfg)
    for k in ("w_delta", "w_zp"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    init = core.adaround_init_alpha(t(kernel), got["w_delta"])
    assert_alphas_close(got["w_alpha"], want["w_alpha"], init, 1e-2, 20)
    np.testing.assert_allclose(got["recon_losses"].numpy(),
                               np.asarray(want["recon_losses"]),
                               rtol=LOSS_REL, atol=LOSS_ATOL)
    if target == "weight_and_activation":
        a0, _ = core.compute_qparams(t(x)[None], dataclasses.replace(
            pl.act, granularity="tensor"))
        a, ja = got["a_delta"].item(), np.asarray(want["a_delta"]).item()
        assert abs(a - ja) <= MOVE_REL * abs(ja - a0.item())
    else:
        assert "a_delta" not in got


def test_mlp_block_reconstruction_matches_jax():
    lspec = load_quant_config(ADAROUND).default_layer
    rng = np.random.default_rng(11)
    k1 = (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((64, 32)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    x = np.repeat(rng.standard_normal((1, 32)).astype(np.float32), 40, 0)
    h = np.asarray(jax.nn.gelu(jnp.asarray(x @ k1 + b1), approximate=True))
    y = h @ k2 + b2
    jcfg, pcfg = _cfgs()
    want = JR.mlp_block_reconstruction(
        *(jnp.asarray(a) for a in (k1, b1, k2, b2, x, y)),
        j_load(ADAROUND).default_layer, jcfg)
    got = R.mlp_block_reconstruction(*(t(a) for a in (k1, b1, k2, b2, x, y)),
                                     lspec, pcfg)
    for name, k in (("fc1", k1), ("fc2", k2)):
        assert np.array_equal(got[name]["w_delta"].numpy(),
                              np.asarray(want[name]["w_delta"]))
        init = core.adaround_init_alpha(t(k), got[name]["w_delta"])
        assert_alphas_close(got[name]["w_alpha"], want[name]["w_alpha"],
                            init, 1e-2, 20, name)
    np.testing.assert_allclose(got["recon_losses"].numpy(),
                               np.asarray(want["recon_losses"]),
                               rtol=LOSS_REL, atol=1e-9)


def test_model_reconstruction_with_a_cb_layer_matches_jax():
    """model_reconstruction over three layers: a channel-balancing layer
    (its rounding learned on kernel * cs[0], its input over cs[0]), a
    kv_linear (skipped) and a layer whose spec does not round by AdaRound
    (skipped), against the JAX function on the same tables."""
    base = load_quant_config(ADAROUND).default_layer
    jbase = j_load(ADAROUND).default_layer

    def cb(s):
        return dataclasses.replace(s, smooth_quant=dataclasses.replace(
            s.smooth_quant, enable=True,
            timerange=((0, 500), (501, 1000)), alpha=(0.5, 0.5)))

    def nearest(s):
        return dataclasses.replace(s, weight=dataclasses.replace(
            s.weight, round_mode="nearest"))
    specs = {"cb": (cb(jbase), cb(base)), "kv_linear": (jbase, base),
             "plain": (nearest(jbase), nearest(base))}
    rng = np.random.default_rng(12)
    K, F = 32, 24
    model = torch.nn.Module()
    quant, params, io, jio = {}, {}, {}, {}
    for i, (name, (js, ps)) in enumerate(specs.items()):
        lin = QuantLinear(K, F, ps, dtype=torch.float32)
        kernel, bias, x, y = _repeated_rows(20 + i, K, F)
        with torch.no_grad():
            lin.kernel.copy_(t(kernel))
            lin.bias.copy_(t(bias))
            if lin.momentum_cb:
                lin.act_scale.copy_(t(np.abs(rng.standard_normal((2, K)))
                                      .astype(np.float32)))
        setattr(model, name, lin)
        params[name] = {"kernel": jnp.asarray(kernel),
                        "bias": jnp.asarray(bias)}
        io[name] = (t(x), t(y))
        jio[name] = (jnp.asarray(x), jnp.asarray(y))
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    calibrate_weight_tables(model)
    for name, lin in model.named_children():
        quant[name] = {k: jnp.asarray(getattr(lin, k).numpy())
                       for k in ("w_delta", "w_zp", "w_alpha", "act_scale",
                                 "cb_scale") if hasattr(lin, k)}
    init = {n: m.w_alpha.clone() for n, m in model.named_children()
            if m.adaround}
    _, pcfg = _cfgs()
    jcfg, _ = _cfgs()
    jvars = JR.model_reconstruction(
        {"params": params, "quant": quant}, jio,
        lambda n: specs[n][0], jcfg)
    R.model_reconstruction(model, io, pcfg)
    jq = jvars["quant"]
    assert "w_alpha" not in jq["plain"] and not model.plain.adaround
    for name in ("cb", "kv_linear"):
        lin = model.get_submodule(name)
        for k in ("w_delta", "w_zp"):
            assert np.array_equal(getattr(lin, k).numpy(),
                                  np.asarray(jq[name][k])), (name, k)
    assert torch.equal(model.kv_linear.w_alpha, init["kv_linear"])
    assert_alphas_close(model.cb.w_alpha, jq["cb"]["w_alpha"], init["cb"],
                        1e-2, 20, "cb")
    # the CB layer learned on the folded lattice: its w_delta at timerange
    # 0 is that of kernel * cs[0]
    cs0 = model.cb.cb_scale[0]
    d, _ = core.compute_qparams(model.cb.kernel * cs0[:, None],
                                model.cb.lspec.weight)
    assert torch.equal(model.cb.w_delta[0, 0], d)


def test_recon_pieces_on_random_rows_match_jax():
    """On random rows (no repeats): the AdaRound layer loss, its gradient
    with respect to alpha, and one Adam step from that gradient."""
    rng = np.random.default_rng(13)
    lspec = load_quant_config(ADAROUND).default_layer
    jspec = j_load(ADAROUND).default_layer
    kernel = (rng.standard_normal((40, 24)) * 0.1).astype(np.float32)
    x = rng.standard_normal((16, 40)).astype(np.float32)
    y = (x @ kernel + rng.standard_normal((16, 24)) * 0.01).astype(
        np.float32)
    d, z = jcore.compute_qparams(jnp.asarray(kernel), jspec.weight)
    alpha0 = np.asarray(jcore.adaround_init_alpha(jnp.asarray(kernel), d))
    alpha0 = alpha0 + (rng.standard_normal(alpha0.shape) * 0.3).astype(
        np.float32)
    jcfg, pcfg = _cfgs(iters=10)
    step = 5  # after the warmup: the round loss counts
    n_levels = jspec.weight.n_levels()

    def jloss(alpha):
        floor = jnp.floor(jnp.asarray(kernel) / d)
        soft = jcore.adaround_soft_targets(alpha)
        w = (jnp.clip(floor + soft + z, 0, n_levels - 1) - z) * d
        xq = jcore.fake_quant_dynamic(jnp.asarray(x)[None], jspec.act)[0]
        rec = jnp.mean((xq @ w - jnp.asarray(y)) ** 2)
        b = JR.temp_decay(step, jcfg.iters, jcfg.warmup, *jcfg.b_range)
        return rec + jcfg.lambda_coeff * jnp.sum(
            1.0 - jnp.abs(2.0 * soft - 1.0) ** b)
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(alpha0))
    tx = optax.adam(jcfg.lr_alpha)
    upd, _ = tx.update(jg, tx.init(jnp.asarray(alpha0)))
    jnew = np.asarray(optax.apply_updates(jnp.asarray(alpha0), upd))

    pd, pz = core.compute_qparams(t(kernel), lspec.weight)
    alpha = t(alpha0).requires_grad_()
    w = R._soft_weight(t(kernel), torch.floor(t(kernel) / pd), alpha, pd, pz,
                       lspec.weight)
    xq = core.fake_quant_dynamic(t(x)[None], lspec.act)[0]
    loss = (torch.mean((xq @ w - t(y)) ** 2)
            + R.round_loss((alpha,), step, pcfg))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_REL * abs(float(jl))
    jg = np.asarray(jg)
    assert np.linalg.norm(alpha.grad.numpy() - jg) / np.linalg.norm(jg) \
        <= LOSS_REL
    opt = torch.optim.Adam([alpha], lr=pcfg.lr_alpha)
    alpha.grad = t(jg)  # one step from the same gradient
    opt.step()
    np.testing.assert_allclose(
        alpha.detach().numpy(), jnew, rtol=0,
        atol=ADAM_ULP * np.spacing(np.abs(jnew).max()))
    assert not np.array_equal(jnew, alpha0)
    # temp_decay is JAX's in float32 at every step, warmup included
    for s in range(0, 10):
        assert float(R.temp_decay(s, 10, 0.2)) == float(
            JR.temp_decay(s, 10, 0.2))


def test_calibrate_ptqd_k_matches_jax(tmp_path):
    rng = np.random.default_rng(14)
    fp = rng.standard_normal((5, 2, 4, 8, 8)).astype(np.float32)
    q = (fp * (1 + rng.uniform(-0.05, 0.05, (5, 1, 1, 1, 1)))
         + rng.standard_normal(fp.shape) * 0.01).astype(np.float32)
    np.savez(tmp_path / "fp.npz", outs=fp)
    np.savez(tmp_path / "q.npz", outs=q)
    os.makedirs(tmp_path / "j")  # the JAX command writes into it as it is
    args = ["calibrate-ptqd-k", "--fp_trajectory", str(tmp_path / "fp.npz"),
            "--quant_trajectory", str(tmp_path / "q.npz")]
    j_cli.main(args + ["--save_dir", str(tmp_path / "j")])
    out = cli.main(args + ["--save_dir", str(tmp_path / "p")])
    want = np.load(tmp_path / "j" / "ptqd_k.npy")
    got = np.load(out["out"])
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got, analysis.calibrate_ptqd_k(fp, q))
    for step in (0, 3):
        np.testing.assert_array_equal(
            analysis.apply_ptqd_correction(t(q[step]), got, step).numpy(),
            np.asarray(janalysis.apply_ptqd_correction(
                jnp.asarray(q[step]), jnp.asarray(want), step)))


def test_pixart_block_reconstruction_runs():
    """The port's PixArt blocks reconstruct too (`standalone_block`; the
    tiny Σ's 2304 tokens stream their kv in float32 on the CPU): the
    alphas move from their init, the rest of the tables stay. Without KV
    compression: its `sr` conv quantizes its weight on the fly with no
    alpha, so an AdaRound plan that reaches it raises ValueError, in the
    JAX package as here (layers.py:257-262)."""
    from torch_parity import TINY_SIGMA, inputs
    from viditq_tpu_torch.models.pixart import PixArt
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.utils import workload
    plan = load_quant_config(ADAROUND)
    model = PixArt(resolver=plan.resolver(), dtype=torch.float32,
                   **{**TINY_SIGMA, "kv_compress_layers": ()})
    workload.random_init_(model, 0, 0.1)
    calibrate_weight_tables(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x, t_, y, mask = inputs(batch=1, kind="sigma")
    _, pcfg = _cfgs(iters=2, warmup=0.0)
    timings = {}
    R.model_block_reconstruction(
        model, (t(x), t(t_.astype(np.float32)), t(y), t(mask)), pcfg,
        mask=t(mask), timings=timings)
    assert len(timings["block_s"]) == len(timings["capture_s"]) == 2
    after = model.state_dict()
    moved = [k for k in before if k.endswith("w_alpha")
             and not torch.equal(before[k], after[k])]
    assert len(moved) == sum(k.endswith("w_alpha") for k in before) > 0
    assert all(torch.equal(before[k], after[k]) for k in before
               if not k.endswith("w_alpha"))

