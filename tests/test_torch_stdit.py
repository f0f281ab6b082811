"""The port's STDiT slice against the JAX package on equal weights: the
weight bridge (scanned and unrolled layouts), the fp forward, the sm8
forward, and a 3-step CFG DDIM denoise in fp and sm8. The JAX side runs
its kernel path (Pallas interpret mode), which is the port's one dataflow.

Tolerances: fp outputs 1e-4 relative (float32 in both; both round q and k
to bf16 inside the attention, and a summation-order difference before such
a cast can move a value by one bf16 step). sm8: 1e-2 relative for the
forward, 2e-2 for the 3-step CFG denoise. Every int8 layer turns float
differences of an ulp into whole code flips, so the quantized model has a
noise floor: the JAX package's own sm8 output moves by ~3e-3 when its
input moves by 1e-7..1e-6 relative (test_sm8_reference_noise_floor), and
the two libraries' float kernels (exp, tanh, sums) differ by about that
much before the first quantizer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SM8, build_jax, build_port, inputs, jax_kernel_path,
                          rel_err)
from viditq_tpu.pipelines.inference import fp_sample as j_fp_sample
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.utils.ckpt import stack_block_params
from viditq_tpu_torch.pipelines.inference import fp_sample, quant_sample
from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

FP_TOL = 1e-4
SM8_TOL = 1e-2
SM8_DENOISE_TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    jmodel, jv = build_jax(SM8)
    return jmodel, jv, build_port(SM8, jv)


@pytest.fixture(scope="module")
def jax_forward(models):
    """The JAX model's kernel-path forward, compiled once per mode."""
    jmodel, jv, _ = models
    fns = {quant: jax.jit(lambda x, t, y, m, _q=quant: jmodel.apply(
        jv, x, t, y, m, qctx=JQuantCtx(mode="quant") if _q else None))
        for quant in (False, True)}

    def run(quant, x, t, y, mask):
        with jax_kernel_path():
            return np.asarray(fns[quant](x, t, y, mask))
    return run


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_bridge_unrolled_and_scanned_layouts(models):
    jmodel, jv, port = models
    sd_un = state_dict_from_flax(jv["params"], jv["quant"])
    # the scanned layout (scan_blocks=True): every block leaf stacked on a
    # leading depth axis under one 'blocks' container
    jsc, jv_sc = build_jax(SM8, scan_blocks=True)
    stacked = {c: stack_block_params(jv[c], 2) for c in ("params", "quant")}
    shapes = jax.tree.map(np.shape, stacked)
    assert shapes == jax.tree.map(np.shape, jv_sc)
    sd_sc = state_dict_from_flax(stacked["params"], stacked["quant"])
    assert sd_un.keys() == sd_sc.keys() == port.state_dict().keys()
    for k in sd_un:
        assert torch.equal(sd_un[k], sd_sc[k]), k
        assert torch.equal(sd_un[k], port.state_dict()[k]), k
    # JAX layouts: Dense [K, N]; the x_embedder conv kernel as patch rows
    assert tuple(sd_un["blocks.1.mlp.fc1.kernel"].shape) == (64, 256)
    assert tuple(sd_un["blocks.1.mlp.fc1.w_int"].shape) == (1, 64, 256)
    np.testing.assert_array_equal(
        sd_un["x_embedder.proj.kernel"].numpy(),
        jv["params"]["x_embedder"]["proj"]["kernel"].reshape(16, 64))


def _port_forward(port, quant, x, t, y, mask):
    with torch.no_grad():
        return port(_t(x), _t(t), _t(y), _t(mask),
                    qctx=QuantCtx(mode="quant") if quant else None).numpy()


def test_fp_forward_matches_jax(models, jax_forward):
    args = inputs()
    want = jax_forward(False, *args)
    got = _port_forward(models[2], False, *args)
    assert got.shape == want.shape == (2, 8, *args[0].shape[2:])
    assert rel_err(got, want) < FP_TOL


def test_sm8_forward_matches_jax_kernel_path(models, jax_forward):
    args = inputs()
    want = jax_forward(True, *args)
    got = _port_forward(models[2], True, *args)
    assert np.isfinite(got).all()
    assert rel_err(got, want) < SM8_TOL
    # the port reproduces the reference's quantization, not just the fp
    # model: it is nearer the JAX sm8 output than its own fp output is
    fp = _port_forward(models[2], False, *args)
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


def test_sm8_reference_noise_floor(jax_forward):
    # why the sm8 tolerance is not tighter: the reference itself moves by
    # a few 1e-3 under a 1e-7 relative perturbation of its input
    x, t, y, mask = inputs()
    xp = (x * (1 + 1e-7 * np.random.default_rng(1).standard_normal(x.shape))
          ).astype(np.float32)
    floor = rel_err(jax_forward(True, xp, t, y, mask),
                    jax_forward(True, x, t, y, mask))
    assert 1e-3 < floor < SM8_TOL


@pytest.mark.parametrize("quant,cfg_split", [(False, False), (False, True),
                                             (True, False)],
                         ids=["fp", "fp-cfg_split", "sm8"])
def test_ddim_cfg_denoise_matches_jax(models, quant, cfg_split):
    jmodel, jv, port = models
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    kw = dict(num_sampling_steps=3, cfg_scale=4.0, cfg_split=cfg_split)
    with jax_kernel_path():
        run = j_quant_sample if quant else j_fp_sample
        want = run(jmodel, jv, JIDDPM(**kw), jnp.asarray(x), jnp.asarray(y2),
                   jnp.asarray(mask))
    run = quant_sample if quant else fp_sample
    got = run(port, IDDPM(**kw), _t(x), _t(y2), _t(mask))
    assert got.shape == (1, 4, *x.shape[2:])
    assert rel_err(got.numpy(), want) < (SM8_DENOISE_TOL if quant
                                         else FP_TOL)
    # the latent moved away from the noise it started from
    assert rel_err(got.numpy(), x) > 0.01
