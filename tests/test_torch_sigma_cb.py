"""PixArt-Σ under its W4A8 plan (`configs/pixart_sigma/w4a8.yaml`: W6
per-channel asym weights in int8 slabs, asym dynamic A8, momentum channel
balancing (CB) with alpha 0.3 over one timerange, no fp list, so the patch
embed (K = 16) and the final linear (N = 32) are quantized too) on the
fused kernels with `qkv_share_cs`, as the JAX package's `sigma1024` bench
arm runs it (benchmarks/bench_configs.py:359-425), in the PyTorch port
against the JAX package: the port's own sq_stat -> calibrate -> pack,
one forward, a 2-step DPM-Solver++ CFG denoise, the KV-compress `sr` conv
(fake quant at W6, no CB, under every backend), a plain-call audit, and
the bridge's scanned multi-run Σ layout with the CB tables. The tiny Σ
(tests/torch_parity.py) streams block 0's self-attention through K6 (its
CB emission through K4) and compresses block 1's k/v with the `sr` conv;
the JAX side runs its kernel path in interpret mode.

Tolerances, each with its reason (those of tests/test_torch_cb.py):
  * calibration: act_scale, cb_scale and the weight scales within 1e-5 of
    each entry and of the table's largest (C13: the maxima are reduced in
    another order and cs goes through each library's pow), zero points
    within one, codes equal or off by one at no more than 0.1% of entries;
  * model: forward 1e-2 and 2-step CFG DPM-Solver++ 2e-2 relative, the
    limits of every int8 plan: each int8 layer turns ulps into code flips;
  * the `sr` conv: 1e-6 relative (the same f32 fake quant and patch sums
    in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sigma import _stack_runs
from torch_parity import (TINY_SIGMA, build_jax, build_port, cb_plan, inputs,
                          jax_kernel_path, rel_err)
from viditq_tpu.models.pixart import PixArt as JPixArt
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import DPMSolverSampler as JDPMSolverSampler
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.models.layers import DepthwiseQuantConv
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant import qlinear
from viditq_tpu_torch.quant.calibrate import (calibrate_weight_tables,
                                              smooth_quant_stats)
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
from viditq_tpu_torch.utils.bridge import state_dict_from_flax
from viditq_tpu_torch.utils.config import load_quant_config

SIGMA_W4A8 = "configs/pixart_sigma/w4a8.yaml"
# the statistic forward of the JAX bench arm (bench_configs.py:408-425)
STAT_T = (500,)
FWD_TOL = 1e-2
DENOISE_TOL = 2e-2
CODE_FRAC = 1e-3
TABLE_TOL = 1e-5
SR_TOL = 1e-6
PLAN = cb_plan(True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def models():
    jmodel, jv = build_jax(SIGMA_W4A8, kind="sigma", plan_fn=PLAN,
                           sq_stat_t=STAT_T)
    return jmodel, jv, build_port(SIGMA_W4A8, jv, kind="sigma", plan_fn=PLAN)


def _forward(port, x, t, y, mask):
    with torch.no_grad():
        return port(_t(x), _t(t), _t(y), _t(mask),
                    qctx=QuantCtx(t_id=500)).numpy()


def test_plan_resolves_like_jax(models):
    plan = PLAN(load_quant_config(SIGMA_W4A8))
    jres = PLAN(j_load(SIGMA_W4A8)).resolver()
    port = models[2]
    names = [n for n, m in port.named_modules()
             if isinstance(m, (QuantLinear, DepthwiseQuantConv))]
    assert "blocks.1.attn.sr" in names
    for name in names:
        assert (dataclasses.asdict(plan.resolver()(name))
                == dataclasses.asdict(jres(name))), name
    d = plan.default_layer
    assert (d.weight.n_bits, d.weight.sym, d.act.n_bits, d.act.sym) == (
        6, False, 8, False)
    assert (d.smooth_quant.timerange, d.smooth_quant.alpha) == (
        ((0, 1000),), (0.3,)) and d.smooth_quant.qkv_share_cs
    # no fp list: the patch embed and the final linear run int8 (K5)
    for mod in (port.x_embedder.proj, port.final_layer.linear):
        assert mod.fused and mod.smooth is not None
    assert (port.x_embedder.proj.in_features,
            port.final_layer.linear.features) == (16, 32)


def test_port_calibration_matches_jax(models):
    # the port's own sq_stat -> calibrate -> pack on the JAX model's
    # weights and inputs against the JAX package's
    _, jv, _ = models
    port = build_port(SIGMA_W4A8, jv, fp_only=True, kind="sigma",
                      plan_fn=PLAN)
    x, _, y, mask = inputs(kind="sigma")
    smooth_quant_stats(port, _t(x), _t(y), _t(mask), STAT_T)
    pack_native_weights(calibrate_weight_tables(port))
    got = port.state_dict()
    want = state_dict_from_flax(jv["params"], jv["quant"])
    assert got.keys() == want.keys()
    n = 0
    for k, w in want.items():
        leaf = k.rpartition(".")[2]
        g, w = got[k].numpy(), w.numpy()
        if leaf in ("act_scale", "cb_scale", "w_delta"):
            np.testing.assert_allclose(g, w, rtol=TABLE_TOL,
                                       atol=TABLE_TOL * np.abs(w).max(),
                                       err_msg=k)
        elif leaf == "w_zp":
            assert np.abs(g - w).max() <= 1, k
        elif leaf == "w_int":
            n += 1
            diff = np.abs(g.astype(np.int32) - w)
            assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FRAC, k
            assert g.min() >= -32 and g.max() <= 31  # W6 codes
    # every linear of both blocks, the patch embed and the final linear
    assert n == 2 * 9 + 2
    assert (got["x_embedder.proj.act_scale"] > 0).all()


def test_forward_matches_jax(models):
    jmodel, jv, port = models
    x, t, y, mask = inputs(kind="sigma")
    fn = jax.jit(lambda *a: jmodel.apply(jv, *a, qctx=JQuantCtx(
        mode="quant", t_id=jnp.asarray(500, jnp.int32))))
    with jax_kernel_path():
        want = np.asarray(fn(x, t, y, mask))
    got = _forward(port, x, t, y, mask)
    assert got.shape == want.shape == (2, 8, 96, 96)
    assert np.isfinite(got).all() and rel_err(got, want) < FWD_TOL
    # the balancing is in the output: uncalibrated scales (cs = 1) move it
    plain = build_port(SIGMA_W4A8, jv, kind="sigma", plan_fn=PLAN)
    for m in plain.modules():
        if isinstance(m, QuantLinear) and m.smooth is not None:
            m.cb_scale.zero_()
    pack_native_weights(plain)
    assert rel_err(_forward(plain, x, t, y, mask), want) > 2 * rel_err(
        got, want)


def test_dpm_denoise_matches_jax(models):
    jmodel, jv, port = models
    x, _, y, mask = inputs(batch=1, seed=3, kind="sigma")
    y2 = np.concatenate([y, inputs(batch=1, seed=4, kind="sigma")[2]])
    kw = dict(num_sampling_steps=2, cfg_scale=4.5)
    with jax_kernel_path():
        want = j_quant_sample(jmodel, jv, JDPMSolverSampler(**kw),
                              jnp.asarray(x), jnp.asarray(y2),
                              jnp.asarray(mask))
    got = quant_sample(port, DPMSolverSampler(**kw), _t(x), _t(y2),
                       _t(mask))
    assert got.shape == (1, 4, 96, 96)
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01


def test_sr_conv_under_the_cb_plan_matches_jax(models):
    # JAX runs the sr conv as simulate fake quant under every backend and
    # applies no CB there (viditq_tpu/models/layers.py:239-277)
    from viditq_tpu.models.layers import DepthwiseQuantConv as JConv
    _, jv, port = models
    sr = port.blocks[1].attn.sr
    spec = sr.lspec
    assert spec.smooth_quant.enable and spec.weight.n_bits == 6
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 8, 8, 64)) + 0.3).astype(np.float32)
    params = jv["params"]["blocks_1"]["attn"]["sr"]
    jconv = JConv(64, 2, lspec=PLAN(j_load(SIGMA_W4A8)).resolver()(
        "blocks.1.attn.sr"), dtype=jnp.float32)
    port_sr = DepthwiseQuantConv(64, 2, spec, dtype=torch.float32)
    port_sr.load_state_dict({k: _t(v) for k, v in params.items()})
    outs = {}
    for mode in ("fp", "quant"):
        want = np.asarray(jconv.apply({"params": params}, jnp.asarray(x),
                                      JQuantCtx(mode=mode)))
        with torch.no_grad():
            outs[mode] = port_sr(_t(x), QuantCtx(mode=mode)).numpy()
        assert rel_err(outs[mode], want) < SR_TOL, mode
    assert rel_err(outs["quant"], outs["fp"]) > 1e-4  # W6 and A8 ran
    # and the same conv without channel balancing computes the same
    plain = DepthwiseQuantConv(64, 2, dataclasses.replace(
        spec, smooth_quant=type(spec.smooth_quant)()), dtype=torch.float32)
    plain.load_state_dict(port_sr.state_dict())
    with torch.no_grad():
        assert torch.equal(plain(_t(x), QuantCtx()), _t(outs["quant"]))


def test_plain_call_audit(models, monkeypatch):
    # per CFG forward, each kernel's plain calls: block 0 (self-attention
    # over 2304 tokens: K1 for q/k/v and fc1, K6 with its emission through
    # K4, K2 at q/k/v, proj, fc1 and fc2, K4 at the GELU handoff, K5 at the
    # cross q and kv linears, K3 at the cross attention), block 1 (KV
    # compression: K5 at q, k, v and proj), the patch embed and the final
    # linear (K5); the plain K5 calls K4's and K2's plain versions
    from test_torch_fused import PLAIN
    calls = {name: 0 for _, name in PLAIN}

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name in PLAIN:
        spy(mod, name)
    divides = []
    real = qlinear.divide_cols
    monkeypatch.setattr(qlinear, "divide_cols",
                        lambda *a: divides.append(1) or real(*a))
    x, t, y, mask = inputs(kind="sigma")
    _forward(models[2], x, t, y, mask)
    k5 = 2 + 2 + 4 + 2  # block 0 cross, block 1 cross, block 1 attn, ends
    assert calls == {
        "ln_modulate_quantize_plain": 3,  # block 0: q/k/v, fc1; block 1: fc1
        "quantize_rows_plain": 1 + 2 + k5,  # K6's emission, 2 GELUs, in K5
        # block 0: q/k/v and the self and cross projs; block 1: the cross
        # proj; fc1 and fc2 in both; and in K5
        "int8_consumer_matmul_plain": 5 + 1 + 2 * 2 + k5,
        "fused_dynq_int8_matmul_plain": k5,
        "attention_bnhd_plain": 2,  # the cross attentions
        "attention_bnhd_stream_plain": 1,
        "dynamic_quant_rows_plain": 0, "int8_matmul_plain": 0}, calls
    # no layer divides its input by cs itself: every 1/cs folds into a
    # producer or into K5's quantize
    assert not divides


def test_bridge_carries_cb_tables_in_the_scanned_multi_run_layout(models):
    _, jv, port = models
    # the JAX package's scanned Σ: one run of uniform blocks each
    jscan = JPixArt(resolver=PLAN(j_load(SIGMA_W4A8)).resolver(),
                    dtype=jnp.float32, scan_blocks=True, **TINY_SIGMA)
    x, t, y, mask = inputs(kind="sigma")
    shapes = jax.eval_shape(lambda: jscan.init(
        jax.random.PRNGKey(0), x, t, y, mask, qctx=JQuantCtx(mode="fp")))
    runs = [(0, 1), (1, 1)]
    stacked = {c: _stack_runs(jv[c], runs) for c in ("params", "quant")}
    assert (jax.tree.map(np.shape, stacked)
            == jax.tree.map(lambda s: tuple(s.shape),
                            {c: dict(shapes[c]) for c in stacked}))
    assert "cbshare__attn__q" in stacked["quant"]["blocks_0"]
    sd = state_dict_from_flax(stacked["params"], stacked["quant"])
    own = port.state_dict()
    assert sd.keys() == own.keys()
    for k in sd:
        assert torch.equal(sd[k], own[k]), k
