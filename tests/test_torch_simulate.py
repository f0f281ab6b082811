"""The port's simulate (fake-quant) backend, weight-only native layers and
the plans that run them, against the JAX package on equal weights and
inputs (numpy draws from a seed).

Layer level: a `QuantLinear` of each package, the JAX tables bridged into
the port's, and the two tensors each hands to its dense product (the
fake-quantized act and weight; `_dense` / `dense` are spied) held to one
float32 ulp: the quantizers are the same formulas in the same order, and
the jitted XLA of the JAX package may round a fused multiply once where
the port rounds twice (C8). The layer output is held to 1e-2 relative.
Cases: dynamic acts under each token layout (the per-position pooling of
the spatial and temporal views and the packed cross_kv view), the
'dynamic' and momentum CB types, the q-diffusion split, weight-only W8
and the nibble-packed W4.

Model level: the tiny STDiT of `tests/torch_parity.py` under the
reference plans as written (`viditq_w8a8`, `viditq_w6a6`) and an
attention quantizer combination the kernels do not take (the attn8
plan's quantizers on the simulate backend: the fake-quant fallback), one
forward within 1e-2 and a 2-step CFG DDIM within 2e-2, the limits of the
int8 model tests (`tests/test_torch_stdit.py`): every quantizer turns
float differences of an ulp into whole code flips. The hybrid plan and
the plan resolution: `tests/test_torch_plans.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (build_jax, build_port, inputs, jax_kernel_path,
                          rel_err)
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import calibrate_weight_tables as j_calibrate
from viditq_tpu.quant.native_pack import pack_native_weights as j_pack
from viditq_tpu.quant.qlinear import QuantLinear as JQuantLinear
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.models import layers as L
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant import core as pcore
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.bridge import state_dict_from_flax
from viditq_tpu_torch.utils.config import load_quant_config

W8A8 = "configs/opensora/viditq_w8a8.yaml"
W6A6 = "configs/opensora/viditq_w6a6.yaml"
HYBRID = "configs/opensora/w8a8_tpu_hybrid.yaml"
ATTN8 = "configs/opensora/w8a8_tpu_fused_attn8.yaml"
LAYER_TOL = 1e-2
FWD_TOL = 1e-2
DENOISE_TOL = 2e-2


def spec_pair(plan, name="blocks.0.attn.q", change=None):
    """The layer spec of `name` under `plan` in both packages, each passed
    through `change` (the same dataclasses.replace on either class)."""
    out = []
    for load in (j_load, load_quant_config):
        s = load(plan).resolver()(name)
        out.append(change(s) if change else s)
    return out


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


class DenseSpy:
    """Records the (act, weight) each package hands its dense product."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        j_dense, p_dense = JQuantLinear._dense, QuantLinear.dense

        def jd(mod, x, kernel, bias):
            self.jax.append((np.asarray(x), np.asarray(kernel)))
            return j_dense(mod, x, kernel, bias)

        def pd(mod, x, kernel=None):
            k = mod.kernel if kernel is None else kernel
            self.port.append((x.detach().numpy().copy(),
                              k.detach().float().numpy().copy()))
            return p_dense(mod, x, kernel)
        monkeypatch.setattr(JQuantLinear, "_dense", jd)
        monkeypatch.setattr(QuantLinear, "dense", pd)

    def check(self):
        assert len(self.jax) == len(self.port) >= 1
        for (jx, jw), (px, pw) in zip(self.jax, self.port):
            np.testing.assert_array_max_ulp(px, jx, maxulp=1)
            np.testing.assert_array_max_ulp(pw, jw, maxulp=1)
        self.jax.clear()
        self.port.clear()


def layer_pair(specs, x, features=48, seed=0, sq_stat=(), **fields):
    """(JAX layer, its variables, port layer): float32 layers of `features`
    outputs on inputs shaped like x, random weights x 0.1, the JAX tables
    calibrated (after 'sq_stat' forwards on x at each timestep of sq_stat)
    and packed, and bridged into the port's."""
    jspec, pspec = specs
    K = x.shape[-1]
    rng = np.random.default_rng(seed)
    jl = JQuantLinear(features, lspec=jspec, dtype=jnp.float32, **fields)
    v = jl.init(jax.random.PRNGKey(0), jnp.asarray(x),
                qctx=JQuantCtx(mode="fp"))
    params = {"kernel": (rng.standard_normal((K, features)) * 0.1
                         ).astype(np.float32),
              "bias": (rng.standard_normal(features) * 0.1
                       ).astype(np.float32)}
    quant, qstats = v.get("quant", {}), v.get("qstats", {})
    for t in sq_stat:
        _, upd = jl.apply({"params": params, "quant": quant,
                           "qstats": qstats}, jnp.asarray(x),
                          qctx=JQuantCtx(mode="sq_stat", t_id=t),
                          mutable=["quant", "qstats"])
        quant, qstats = upd["quant"], upd["qstats"]
    quant = j_pack(params, j_calibrate(params, quant, lambda n: jspec),
                   lambda n: jspec)
    jv = {"params": params, "quant": quant, "qstats": qstats}
    # JAX's n_prompt unpacks its packed prompts; the port's come dense
    pl = QuantLinear(K, features, pspec, dtype=torch.float32,
                     **{k: v for k, v in fields.items() if k != "n_prompt"})
    pl.load_state_dict(state_dict_from_flax(params, quant, qstats))
    return jl, jv, pl


def run_pair(jl, jv, pl, x, spy, **ctx):
    want = np.asarray(jl.apply(jv, jnp.asarray(x), qctx=JQuantCtx(**ctx)))
    with torch.no_grad():
        got = pl(_t(x), QuantCtx(**ctx)).numpy()
    spy.check()
    assert got.shape == want.shape
    assert rel_err(got, want) < LAYER_TOL
    return got


def jax_forwards(jmodel, jv, args, ctxs=((0, 0),)):
    """The JAX model's quant forward on its kernel path at each (t_id,
    act_slot) of ctxs: one compiled program, the variables and the
    indices its arguments."""
    fn = jax.jit(lambda v, q, *a: jmodel.apply(v, *a, qctx=q))
    with jax_kernel_path():
        return [np.asarray(fn(jv, JQuantCtx(mode="quant", t_id=jnp.int32(t),
                                            act_slot=jnp.int32(s)), *args))
                for t, s in ctxs]


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# (token_layout fields, input shape): STDiT's spatial view of [(B T), S, C]
# (B = 2, T = 2, S = 8), its temporal view of [(B S), T, C], cross_kv's
# prompts [B, P, C] (P = 6; JAX's `n_prompt`) and the plain [B, N, C]
LAYOUTS = {
    "plain": ({}, (2, 16, 64)),
    "spatial": (dict(token_layout="spatial", d_t=2, d_s=8), (4, 8, 64)),
    "temporal": (dict(token_layout="temporal", d_t=2, d_s=8), (16, 2, 64)),
    "cross_kv": (dict(token_layout="cross_kv", n_prompt=6), (2, 6, 64)),
}


@pytest.mark.parametrize("plan", [W8A8, W6A6])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_dynamic_act_fake_quant_matches_jax(plan, layout, monkeypatch):
    fields, shape = LAYOUTS[layout]
    x = _x(shape)
    specs = spec_pair(plan)
    assert specs[1].backend == "simulate" and specs[1].act.dynamic
    jl, jv, pl = layer_pair(specs, x, **fields)
    assert pl.path == "simulate" and not pl.native
    spy = DenseSpy(monkeypatch)
    got = run_pair(jl, jv, pl, x, spy)
    # the view's pooling is part of the semantics: the plain view on the
    # same input computes other scales
    if layout in ("spatial", "temporal", "cross_kv"):
        flat = QuantLinear(64, 48, specs[1], dtype=torch.float32)
        flat.load_state_dict(pl.state_dict())
        with torch.no_grad():
            assert not np.allclose(flat(_t(x), QuantCtx()).numpy(), got)


def _smooth(kind, **kw):
    def change(s):
        return dataclasses.replace(s, smooth_quant=type(s.smooth_quant)(
            enable=True, channel_wise_scale_type=kind, alpha=(0.5, 0.7),
            timerange=((0, 500), (501, 1000)), **kw))
    return change


@pytest.mark.parametrize("t_id", [100, 900])
def test_dynamic_cb_type_matches_jax(t_id, monkeypatch):
    x = _x((2, 16, 64), scale=2.0)
    specs = spec_pair(W8A8, change=_smooth("dynamic"))
    jl, jv, pl = layer_pair(specs, x)
    assert not hasattr(pl, "cb_scale")  # cs comes from the live input
    spy = DenseSpy(monkeypatch)
    run_pair(jl, jv, pl, x, spy, t_id=t_id)
    # still a ValueError on the native backend, as in JAX
    with pytest.raises(ValueError, match="momentum"):
        QuantLinear(64, 48, dataclasses.replace(specs[1], backend="native"))


@pytest.mark.parametrize("frozen", [True, False])
def test_momentum_cb_frozen_tr0_weights_match_jax(frozen, monkeypatch):
    x = _x((2, 16, 64), scale=2.0)
    specs = spec_pair(W8A8, change=_smooth(
        "momentum_act_max", frozen_tr0_weights=frozen))
    jl, jv, pl = layer_pair(specs, x, sq_stat=(100, 900))
    assert torch.equal(pl.cb_scale, _t(jv["quant"]["cb_scale"]))
    spy = DenseSpy(monkeypatch)
    for t in (100, 900):
        run_pair(jl, jv, pl, x, spy, t_id=t)


def test_split_matches_jax(monkeypatch):
    x = _x((2, 16, 64))
    specs = spec_pair("configs/pixart/w8a8_q_diffusion.yaml",
                      change=lambda s: dataclasses.replace(s, split=24))
    jl, jv, pl = layer_pair(specs, x)
    spy = DenseSpy(monkeypatch)
    got = run_pair(jl, jv, pl, x, spy)
    # the two groups are the point: one group over all 64 channels differs
    aspec, wspec = specs[1].act, specs[1].weight
    w = pl.kernel.detach().float()
    d, z = pcore.compute_qparams(w, wspec)
    one = (pcore.fake_quant_dynamic(_t(x), aspec)
           @ pcore.fake_quant(w, d, z, wspec) + pl.bias.detach()).numpy()
    assert not np.allclose(one, got, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="split"):
        QuantLinear(64, 48, dataclasses.replace(specs[1], backend="native"))


@pytest.mark.parametrize("bits,sym,K", [(8, False, 64), (4, False, 65),
                                        (4, True, 64)],
                         ids=["w8", "w4-nibbles-odd-K", "w4-sym"])
def test_weight_only_matches_jax(bits, sym, K, monkeypatch):
    x = _x((2, 16, K))

    def change(s):
        return dataclasses.replace(s, weight=dataclasses.replace(
            s.weight, n_bits=bits, sym=sym))
    specs = spec_pair(HYBRID, change=change)
    jl, jv, pl = layer_pair(specs, x)
    assert pl.path == "weight_only" and pl.pack4 == (bits == 4 and not sym)
    rows = (K + 1) // 2 if pl.pack4 else K
    assert tuple(pl.w_int.shape) == (1, rows, 48)
    # the port's own packing gives the JAX package's slab
    jw = _t(jv["quant"]["w_int"])
    assert torch.equal(pl.w_int, jw)
    pl.w_int.zero_()
    pack_native_weights(pl)
    assert torch.equal(pl.w_int, jw)
    assert torch.equal(pl.w_colsum, _t(jv["quant"]["w_colsum"]))
    spy = DenseSpy(monkeypatch)
    run_pair(jl, jv, pl, x, spy)


# ---- model level ----

def _attn8_simulate(plan):
    """The attn8 plan's quantizers on the simulate backend with the
    default impl: its per-token q/k/v and softmax quantizers are then no
    kernel mode (`attn_quant_exec_flags` takes them under impl 'fused'
    only), so every attention site runs the fake-quant fallback."""
    plan = plan.with_backend("simulate")
    return dataclasses.replace(plan, default_layer=dataclasses.replace(
        plan.default_layer, impl=None))


MODEL_CASES = {"viditq_w8a8": (W8A8, None), "viditq_w6a6": (W6A6, None),
               "attn8-fake-quant": (ATTN8, _attn8_simulate)}


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_case(request):
    plan, fn = MODEL_CASES[request.param]
    jmodel, jv = build_jax(plan, plan_fn=fn)
    return request.param, jmodel, jv, build_port(plan, jv, plan_fn=fn)


def test_model_forward_and_denoise_match_jax(model_case, monkeypatch):
    name, jmodel, jv, port = model_case
    if name == "attn8-fake-quant":
        # the sites take the fallback: the kernel has no such mode
        spec = port.blocks[0].attn.specs[0]
        assert not L.attn_quant_exec_flags(spec, QuantCtx())[2]
        calls = []
        fq = L.fake_quant_attention
        monkeypatch.setattr(L, "fake_quant_attention",
                            lambda *a, **k: calls.append(1) or fq(*a, **k))
    args = inputs()
    want, = jax_forwards(jmodel, jv, args)
    with torch.no_grad():
        got = port(*(_t(a) for a in args), qctx=QuantCtx()).numpy()
        fp = port(*(_t(a) for a in args)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    # the port reproduces the quantization, not just the fp model
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)
    if name == "attn8-fake-quant":
        assert len(calls) == 3 * len(port.blocks)
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    kw = dict(num_sampling_steps=2, cfg_scale=4.0)
    with jax_kernel_path():
        want = j_quant_sample(jmodel, jv, JIDDPM(**kw), jnp.asarray(x),
                              jnp.asarray(y2), jnp.asarray(mask))
    got = quant_sample(port, IDDPM(**kw), _t(x), _t(y2), _t(mask))
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01
