"""The port's STDiT on the native int8 backend under the reference ViDiT-Q
W8A8 plan (`w8a8_dynamic.yaml`: asymmetric per-channel weights, asymmetric
dynamic per-token activations), against the JAX package on equal weights.
The JAX side runs impl 'pallas' in interpret mode (K7a/K7b really run);
the port runs its one native dataflow, K7a -> K7b.

Tolerances: forward 1e-2 and 3-step CFG DDIM denoise 2e-2 relative, the
sm8 limits, for the same reason (`tests/test_torch_stdit.py`): every int8
layer turns float differences of an ulp into whole code flips. The JAX
package's 'xla' and 'pallas' impls agree to 1e-6: that is the ground of
the port's one dataflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (DYN, build_jax, build_port, inputs,
                          jax_kernel_path, native_plan, rel_err)
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.samplers.iddpm import IDDPM

FWD_TOL = 1e-2
DENOISE_TOL = 2e-2
PLAIN = [(FM, n) for n in ("ln_modulate_quantize_plain", "quantize_rows_plain",
                           "int8_consumer_matmul_plain",
                           "fused_dynq_int8_matmul_plain")] + [
    (A, "attention_bnhd_plain"), (A, "attention_bnhd_stream_plain"),
    (IM, "dynamic_quant_rows_plain"), (IM, "int8_matmul_plain")]


@pytest.fixture(scope="module")
def models():
    jmodel, jv = build_jax(DYN, plan_fn=native_plan("pallas"))
    return jmodel, jv, build_port(DYN, jv, plan_fn=native_plan())


@pytest.fixture(scope="module")
def jax_forward(models):
    jmodel, jv, _ = models
    fn = jax.jit(lambda x, t, y, m: jmodel.apply(
        jv, x, t, y, m, qctx=JQuantCtx(mode="quant")))

    def run(*args):
        with jax_kernel_path():
            return np.asarray(fn(*args))
    return run


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_forward(port, x, t, y, mask):
    with torch.no_grad():
        return port(_t(x), _t(t), _t(y), _t(mask),
                    qctx=QuantCtx(mode="quant")).numpy()


def test_plan_runs_asymmetric_native_specs(models):
    spec = models[2].blocks[0].attn.q.lspec
    assert (spec.backend, spec.impl) == ("native", None)
    assert not spec.weight.sym and not spec.act.sym and spec.act.dynamic
    assert spec.softmax is None and spec.attn_act is None


def test_native_forward_matches_jax_pallas_path(models, jax_forward):
    args = inputs()
    want = jax_forward(*args)
    got = _port_forward(models[2], *args)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    # the port reproduces the quantization, not just the fp model
    with torch.no_grad():
        fp = models[2](*(_t(a) for a in args)).numpy()
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


def test_jax_xla_and_pallas_impls_agree(models, jax_forward):
    jmodel, jv = build_jax(DYN, plan_fn=native_plan("xla"))
    args = inputs()
    with jax_kernel_path():
        xla = np.asarray(jax.jit(lambda x, t, y, m: jmodel.apply(
            models[1], x, t, y, m, qctx=JQuantCtx(mode="quant")))(*args))
    assert rel_err(xla, jax_forward(*args)) < 1e-6


def test_native_denoise_matches_jax(models):
    jmodel, jv, port = models
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    kw = dict(num_sampling_steps=3, cfg_scale=4.0)
    with jax_kernel_path():
        want = j_quant_sample(jmodel, jv, JIDDPM(**kw), jnp.asarray(x),
                              jnp.asarray(y2), jnp.asarray(mask))
    got = quant_sample(port, IDDPM(**kw), _t(x), _t(y2), _t(mask))
    assert got.shape == (1, 4, *x.shape[2:])
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01


def test_cpu_forward_runs_only_the_native_plain_versions(models,
                                                         monkeypatch):
    calls = {name: 0 for _, name in PLAIN}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name in PLAIN:
        spy(mod, name)
    _port_forward(models[2], *inputs())
    # per block: K7a for the two shared q/k/v inputs and for the 7 linears
    # that quantize their own input; K7b for all 13 linears
    depth = len(models[2].blocks)
    assert calls.pop("dynamic_quant_rows_plain") == 9 * depth
    assert calls.pop("int8_matmul_plain") == 13 * depth
    assert calls.pop("attention_bnhd_plain") == 3 * depth
    assert not any(calls.values()), calls


def test_port_calibrate_and_pack_match_jax(models):
    _, jv, _ = models
    port = build_port(DYN, jv, fp_only=True, plan_fn=native_plan())
    calibrate_weight_tables(port)
    pack_native_weights(port)
    sd = port.state_dict()
    n = 0
    for i in range(2):
        for path in ("attn.q", "attn.proj", "attn_temp.v",
                     "cross_attn.kv_linear", "mlp.fc1", "mlp.fc2"):
            jq = jv["quant"][f"blocks_{i}"]
            for seg in path.split("."):
                jq = jq[seg]
            name = f"blocks.{i}.{path}"
            for key in ("w_int", "w_colsum", "w_delta", "w_zp"):
                np.testing.assert_array_equal(sd[f"{name}.{key}"].numpy(),
                                              jq[key], err_msg=name + key)
            n += 1
    assert n == 12
    # asymmetric tables: zero points inside [0, 255], codes over the
    # whole signed range
    zps = torch.cat([v.flatten() for k, v in sd.items()
                     if k.endswith("w_zp")])
    assert float(zps.min()) >= 0 and float(zps.max()) <= 255
    assert float(zps.max()) > 0
