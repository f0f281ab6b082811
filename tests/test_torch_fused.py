"""The port's STDiT under the fused W8A8 plans against the JAX package on
equal weights: `w8a8_tpu_fused.yaml` (the reference semantics, asymmetric
per-channel weights and asymmetric dynamic per-token acts, through the
fused int8 dataflow: K1 asym with row sums, K2's zero-point epilogues, the
attention's asym emission, K4's GELU handoff, K5 asym) and
`w8a8_tpu_fused_sym.yaml` (the same dataflow symmetric, with fc1's int8
emission). The JAX side runs its kernel path (Pallas interpret mode).

Tolerances: forward 1e-2 and 3-step CFG DDIM denoise 2e-2 relative, the
sm8 limits, for the same reason (`tests/test_torch_stdit.py`): every int8
layer turns float differences of an ulp into whole code flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (FUSED, SYM, build_jax, build_port, inputs,
                          jax_kernel_path, rel_err)
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
PLANS = {"asym": FUSED, "sym": SYM}
PLAIN = [(FM, n) for n in ("ln_modulate_quantize_plain", "quantize_rows_plain",
                           "int8_consumer_matmul_plain",
                           "fused_dynq_int8_matmul_plain")] + [
    (A, "attention_bnhd_plain"), (A, "attention_bnhd_stream_plain"),
    (IM, "dynamic_quant_rows_plain"), (IM, "int8_matmul_plain")]


@pytest.fixture(scope="module")
def built():
    """(JAX model, variables, port model, jitted JAX forward) per plan,
    built on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            jmodel, jv = build_jax(PLANS[kind])
            fn = jax.jit(lambda x, t, y, m: jmodel.apply(
                jv, x, t, y, m, qctx=JQuantCtx(mode="quant")))
            cache[kind] = (jmodel, jv, build_port(PLANS[kind], jv), fn)
        return cache[kind]
    return get


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_forward(port, x, t, y, mask, quant=True):
    with torch.no_grad():
        return port(_t(x), _t(t), _t(y), _t(mask),
                    qctx=QuantCtx(mode="quant") if quant else None).numpy()


def test_fused_plan_is_asymmetric_on_the_fused_impl(built):
    port = built("asym")[2]
    for lin in (port.blocks[0].attn.q, port.blocks[0].mlp.fc2,
                port.blocks[0].cross_attn.kv_linear):
        spec = lin.lspec
        assert lin.fused and (spec.backend, spec.impl) == ("native", "fused")
        assert not spec.weight.sym and not spec.act.sym
        assert spec.act.dynamic and spec.softmax is None


@pytest.mark.parametrize("kind", list(PLANS))
def test_fused_forward_matches_jax_kernel_path(built, kind):
    _, _, port, fn = built(kind)
    args = inputs()
    with jax_kernel_path():
        want = np.asarray(fn(*args))
    got = _port_forward(port, *args)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    # the port reproduces the quantization, not just the fp model
    fp = _port_forward(port, *args, quant=False)
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


@pytest.mark.parametrize("kind", list(PLANS))
def test_fused_denoise_matches_jax(built, kind):
    jmodel, jv, port, _ = built(kind)
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


def test_cpu_fused_asym_forward_runs_only_the_fused_plain_versions(
        built, monkeypatch):
    calls = {name: 0 for _, name in PLAIN}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name in PLAIN:
        spy(mod, name)
    port = built("asym")[2]
    _port_forward(port, *inputs())
    # per block: K1 for attn q/k/v and for fc1; K2 for the 9 linears on a
    # prequant (q/k/v twice, the three projs, fc1 in bf16, fc2), and for
    # cross q_linear and kv_linear inside K5; K4 for the temporal q/k/v,
    # inside the two K5s and the GELU handoff; K3 with asym emission at
    # each of the three attention sites; K5's plain version at q_linear and
    # kv_linear (its wrapper's CPU path, which calls K4's and K2's)
    depth = len(port.blocks)
    assert calls.pop("fused_dynq_int8_matmul_plain") == 2 * depth
    assert calls.pop("ln_modulate_quantize_plain") == 2 * depth
    assert calls.pop("int8_consumer_matmul_plain") == 13 * depth
    assert calls.pop("quantize_rows_plain") == 4 * depth
    assert calls.pop("attention_bnhd_plain") == 3 * depth
    assert not any(calls.values()), calls


def test_port_calibrate_and_pack_match_jax_on_fused_layers(built):
    # the asym tables of a fused-impl layer cross the bridge and come out
    # of the port's own calibrate + pack as the JAX package writes them
    _, jv, _, _ = built("asym")
    port = build_port(FUSED, jv, fp_only=True)
    calibrate_weight_tables(port)
    pack_native_weights(port)
    sd = port.state_dict()
    bridged = build_port(FUSED, jv).state_dict()
    n = 0
    for i in range(2):
        for path in ("attn.q", "attn_temp.proj", "cross_attn.kv_linear",
                     "mlp.fc1", "mlp.fc2"):
            jq = jv["quant"][f"blocks_{i}"]
            for seg in path.split("."):
                jq = jq[seg]
            name = f"blocks.{i}.{path}"
            for key in ("w_int", "w_colsum", "w_delta", "w_zp"):
                np.testing.assert_array_equal(sd[f"{name}.{key}"].numpy(),
                                              jq[key], err_msg=name + key)
                assert torch.equal(bridged[f"{name}.{key}"],
                                   sd[f"{name}.{key}"])
            n += 1
    assert n == 10
    zps = torch.cat([v.flatten() for k, v in sd.items()
                     if k.endswith("w_zp")])
    assert float(zps.min()) >= 0 and float(zps.max()) <= 255


def test_fused_and_native_asym_dataflows_agree(built):
    # the fused reference plan and `w8a8_dynamic.yaml` on the native
    # backend carry the same asym semantics on the same tables: on the
    # float32 tiny model their outputs are much nearer each other than
    # either is to the fp output (run with -s for the numbers)
    from torch_parity import DYN, native_plan
    _, jv, fused, _ = built("asym")
    native = build_port(DYN, jv, plan_fn=native_plan())
    args = inputs()
    got = _port_forward(fused, *args)
    ref = _port_forward(native, *args)
    fp = _port_forward(fused, *args, quant=False)
    print(f"tiny STDiT, one forward: fused vs native {rel_err(got, ref):.3g}"
          f", fused vs fp {rel_err(got, fp):.3g}, native vs fp "
          f"{rel_err(ref, fp):.3g}")
    assert rel_err(got, ref) < 0.5 * min(rel_err(got, fp), rel_err(ref, fp))
