"""The port's training initialiser (`utils/workload.jax_init_`) against the
JAX package's `model.init` on every tiny model of `tests/torch_parity.py`
under the sm8 plan.

Threefry cannot be drawn in torch, so the draws are compared as
distributions, parameter by parameter, after the bridge maps each JAX leaf
to the port's name: the shapes equal; a constant leaf (zeros, ones, the
KV-compress 1/r^2) equal; else the means within 6 sigma * sqrt(2 / n) and
the standard deviations within 6 sigma / sqrt(n) of each other (sigma the
JAX leaf's standard deviation, n its element count: six standard errors of
the difference of two draws of n); a xavier-uniform kernel inside its limit
sqrt(6 / (fan_in + fan_out)) in both packages, a truncated normal inside 2
of its scale. The quant tables are buffers and must equal their JAX
initial values.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_parity import KINDS, SM8, build_port, data_info, inputs
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.utils import workload
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

SIGMAS = 6.0


def _jax_init(kind):
    jcls, _, cfg, _ = KINDS[kind]
    model = jcls(resolver=j_load(SM8).resolver(), dtype=jax.numpy.float32,
                 **cfg)
    x, t, y, mask = inputs(kind=kind)
    extra = ({"data_info": data_info(x.shape[0])}
             if cfg.get("micro_condition") else {})
    v = jax.jit(functools.partial(model.init, qctx=JQuantCtx(mode="fp")))(
        jax.random.PRNGKey(0), x, t, y, mask, **extra)
    return state_dict_from_flax(jax.tree.map(np.asarray, v["params"]),
                                jax.tree.map(np.asarray, v["quant"]))


def _owner(model, name):
    mname, _, leaf = name.rpartition(".")
    return model.get_submodule(mname) if mname else model, leaf


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_init_matches_flax_distributions(kind):
    want = _jax_init(kind)
    model = build_port(SM8, kind=kind)
    workload.jax_init_(model, seed=0)
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    assert set(params) <= set(want), sorted(set(params) - set(want))
    checked = {"constant": 0, "uniform": 0, "normal": 0, "table": 0}
    for name, ref in want.items():
        ref = ref.double()
        if name in buffers:
            assert torch.equal(buffers[name].double(), ref), name
            checked["table"] += 1
            continue
        got = params[name].detach().double()
        assert got.shape == ref.shape, name
        n = ref.numel()
        sigma = float(ref.std()) if n > 1 else 0.0
        if sigma == 0.0:
            assert torch.equal(got, ref), name
            checked["constant"] += 1
            continue
        assert abs(float(got.mean() - ref.mean())) <= (
            SIGMAS * sigma * (2.0 / n) ** 0.5), name
        assert abs(float(got.std()) - sigma) <= SIGMAS * sigma / n ** 0.5, \
            name
        mod, leaf = _owner(model, name)
        init = getattr(mod, "kernel_init", None) if leaf == "kernel" else None
        if init == "xavier_uniform":
            limit = (6.0 / sum(ref.shape)) ** 0.5
            assert float(got.abs().max()) <= limit, name
            assert float(ref.abs().max()) <= limit, name
            checked["uniform"] += 1
        else:
            if init == "lecun_normal":
                cut = 2 * ref.shape[0] ** -0.5 / workload.TRUNC_STD
                assert float(got.abs().max()) <= cut * (1 + 1e-6), name
                assert float(ref.abs().max()) <= cut * (1 + 1e-6), name
            checked["normal"] += 1
    assert checked["uniform"] and checked["normal"] and checked["constant"]
    assert set(want) - set(params) - set(buffers) == set()


def test_train_starts_from_the_jax_init(tmp_path):
    """The `train` command draws with `jax_init_` (seed 0) unless it
    resumes: its model before the first step is `jax_init_`'s draw, which
    differs from inference's N(0, 0.02)."""
    from viditq_tpu_torch import cli
    seen = {}
    real = workload.jax_init_

    def spy(model, seed=0):
        out = real(model, seed)
        seen["params"] = {n: p.detach().clone()
                          for n, p in model.named_parameters()}
        return out
    try:
        workload.jax_init_ = spy
        cli.main(["train", "--device", "cpu", "--config",
                  "configs/workload/opensora_tiny.py", "--num_steps", "1",
                  "--save_dir", str(tmp_path)])
    finally:
        workload.jax_init_ = real
    cfg = workload.load_py_config("configs/workload/opensora_tiny.py")
    fresh = workload.jax_init_(workload.build_model(cfg, device="cpu"), 0)
    for n, p in fresh.named_parameters():
        assert torch.equal(seen["params"][n], p), n
    table = fresh.blocks[0].scale_shift_table
    assert abs(float(table.detach().std()) - table.shape[-1] ** -0.5) < 0.05


@pytest.mark.parametrize("kind", ["video_encoder", "temporal_decoder"])
def test_jax_init_matches_flax_vae(kind):
    """The VAE's leaves against `vae.init`'s: the full-width
    VideoAutoencoderKL's encoder (what `train` and `extract-features`
    build; JAX's `train` inits `method=vae.encode`) and a narrow temporal
    decoder (the (3, 1, 1) convs and mix_factor): shapes equal, constants
    equal, lecun-normal kernels within their cut, means and standard
    deviations within 6 standard errors."""
    from viditq_tpu.models import vae as JV
    from viditq_tpu_torch.models import vae as V
    from viditq_tpu_torch.utils.bridge import vae_state_dict_from_flax
    if kind == "video_encoder":
        jm, method = JV.VideoAutoencoderKL(), "encode"
        probe = np.zeros((1, 3, 1, 8, 8), np.float32)
        port = V.VideoAutoencoderKL(decoder=False)
    else:
        jm, method = JV.VideoAutoencoderKLTemporalDecoder(
            num_frames=2, block_out_channels=(32, 32), layers_per_block=1), None
        probe = np.zeros((1, 4, 2, 4, 4), np.float32)
        port = V.VideoAutoencoderKLTemporalDecoder(
            num_frames=2, block_out_channels=(32, 32), layers_per_block=1)
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), probe,
                                method=method))()
    want = vae_state_dict_from_flax(jax.tree.map(np.asarray, v["params"]))
    workload.jax_init_(port, seed=0)
    params = dict(port.named_parameters())
    assert set(params) == set(want)
    kinds = {"constant": 0, "normal": 0}
    for name, ref in want.items():
        ref, got = ref.double(), params[name].detach().double()
        assert got.shape == ref.shape, name
        n = ref.numel()
        sigma = float(ref.std()) if n > 1 else 0.0
        if sigma == 0.0:
            assert torch.equal(got, ref), name
            kinds["constant"] += 1
            continue
        assert abs(float(got.mean() - ref.mean())) <= (
            SIGMAS * sigma * (2.0 / n) ** 0.5), name
        assert abs(float(got.std()) - sigma) <= SIGMAS * sigma / n ** 0.5, \
            name
        cut = 2 * ref[0].numel() ** -0.5 / workload.TRUNC_STD
        assert float(got.abs().max()) <= cut * (1 + 1e-6), name
        assert float(ref.abs().max()) <= cut * (1 + 1e-6), name
        kinds["normal"] += 1
    assert kinds["constant"] and kinds["normal"]
