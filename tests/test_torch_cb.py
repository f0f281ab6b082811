"""Channel balancing (ViDiT-Q's timestep-aware CB, smooth quant) in the
PyTorch port against the JAX package on the same weights and inputs: the
port's own CB calibration (the sq_stat pass, the balancing scale,
per-timerange tables and slabs), and a tiny STDiT under the W4A8 CB recipe
on the fused kernels (`w4a8_timestep_aware_cb.yaml`), with and without
`qkv_share_cs`, against the JAX kernel path in interpret mode; the bridge's
`cbshare__*` check and one CB layer with each table rule. The kernels'
column-scale modes are in `tests/test_torch_cb_kernels.py`.

Tolerances, each with its reason:
  * calibration: the act maxima are taken of LayerNorm, attention and
    GELU outputs whose float reductions (and tanh) run in another order
    or library, then averaged in another order, and cs = a^alpha /
    w^(1-alpha) goes through each library's pow: act_scale, cb_scale and
    the weight tables (min-max of kernel * cs) agree to 1e-5 of each
    entry and of the table's largest (a few ulps: a small channel's
    maximum moves by ulps of the larger terms of its sums), zero points to
    one, and the slabs' codes are equal or off by one at no more than 0.1%
    of entries (a code whose w * cs / d lies within an ulp of a half);
  * model: forward 1e-2 and 3-step CFG DDIM 2e-2 relative, the limits of
    the other int8 plans (`tests/test_torch_fused.py`): every int8 layer
    turns float differences of an ulp into whole code flips;
  * one layer: 1e-4 relative (the K5 route's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import rel_err, t
from torch_parity import (CB, CB_STAT_T, build_jax, build_port, cb_plan,
                          inputs, jax_kernel_path)
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import core as jcore
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant import qlinear
from viditq_tpu_torch.quant.calibrate import (calibrate_weight_tables,
                                              smooth_quant_stats)
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

FWD_TOL = 1e-2
DENOISE_TOL = 2e-2
CODE_FRAC = 1e-3


@pytest.fixture(scope="module")
def built():
    """(JAX model, variables after sq_stat at CB_STAT_T, calibrate and pack,
    port model on the bridged tables, jitted JAX forward of (inputs,
    t_id)) per qkv_share_cs setting, built on first use."""
    cache = {}

    def get(share):
        if share not in cache:
            # the statistic pass does not depend on qkv_share_cs: the
            # per-layer model takes the pooled model's act_scale
            stat = (dict(sq_stat_t=CB_STAT_T) if share else
                    dict(act_scales=get(True)[1]["quant"]))
            jmodel, jv = build_jax(CB, plan_fn=cb_plan(share), **stat)
            fn = jax.jit(lambda x, t_, y, m, tid: jmodel.apply(
                jv, x, t_, y, m, qctx=JQuantCtx(mode="quant", t_id=tid)))
            port = build_port(CB, jv, plan_fn=cb_plan(share))
            cache[share] = (jmodel, jv, port, fn)
        return cache[share]
    return get


def _forward(port, x, tt, y, mask, t_id):
    with torch.no_grad():
        return port(t(x), t(tt), t(y), t(mask),
                    qctx=QuantCtx(t_id=t_id)).numpy()


@pytest.mark.parametrize("share", [True, False], ids=["share", "per-layer"])
@pytest.mark.parametrize("t_id", [300, 700], ids=["tr0", "tr1"])
def test_cb_forward_matches_jax(built, share, t_id):
    _, _, port, fn = built(share)
    x, _, y, mask = inputs()
    tt = np.full((2,), t_id, np.int32)
    with jax_kernel_path():
        want = np.asarray(fn(x, tt, y, mask, jnp.asarray(t_id, jnp.int32)))
    got = _forward(port, x, tt, y, mask, t_id)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    # the other timerange's slabs and scales give another output
    other = _forward(port, x, tt, y, mask, 1000 - t_id)
    assert rel_err(got, want) < 0.5 * rel_err(other, want)


def test_cb_denoise_matches_jax(built, monkeypatch):
    # 3 respaced steps: t = 999 (timerange 1), 500 and 0 (timerange 0)
    from viditq_tpu_torch.samplers import iddpm
    jmodel, jv, port, _ = built(True)
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    kw = dict(num_sampling_steps=3, cfg_scale=4.0)
    with jax_kernel_path():
        want = j_quant_sample(jmodel, jv, JIDDPM(**kw), jnp.asarray(x),
                              jnp.asarray(y2), jnp.asarray(mask))
    seen = []

    def spy(**ctx):
        seen.append(ctx["t_id"])
        return QuantCtx(**ctx)
    monkeypatch.setattr(iddpm, "QuantCtx", spy)
    got = quant_sample(port, IDDPM(**kw), t(x), t(y2), t(mask))
    smooth = port.blocks[0].attn.q.smooth
    assert sorted({qlinear.timerange_of(smooth, s) for s in seen}) == [0, 1]
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01


def test_port_cb_calibration_matches_jax(built):
    # the port's own sq_stat -> calibrate -> pack on the JAX model's
    # weights and inputs against the JAX package's
    _, jv, _, _ = built(True)
    port = build_port(CB, jv, fp_only=True, plan_fn=cb_plan(True))
    x, _, y, mask = inputs()
    smooth_quant_stats(port, t(x), t(y), t(mask), CB_STAT_T)
    calibrate_weight_tables(port)
    pack_native_weights(port)
    sd = port.state_dict()
    for i in range(2):
        jq = jv["quant"][f"blocks_{i}"]
        # pooled q/k/v scale: one table for the three
        for n in ("k", "v"):
            np.testing.assert_array_equal(jq["attn"][n]["cb_scale"],
                                          jq["attn"]["q"]["cb_scale"])
            assert torch.equal(sd[f"blocks.{i}.attn.{n}.cb_scale"],
                               sd[f"blocks.{i}.attn.q.cb_scale"])
        for path in ("attn.q", "attn.proj", "attn_temp.v", "attn_temp.proj",
                     "cross_attn.q_linear", "cross_attn.kv_linear",
                     "cross_attn.proj", "mlp.fc1", "mlp.fc2"):
            j = jq
            for seg in path.split("."):
                j = j[seg]
            name = f"blocks.{i}.{path}"
            for key, rtol in (("act_scale", 1e-5), ("cb_scale", 1e-5),
                              ("w_delta", 1e-5), ("w_zp", 0)):
                got = sd[f"{name}.{key}"].numpy()
                assert got.shape == j[key].shape, (name, key)
                if rtol:
                    np.testing.assert_allclose(
                        got, j[key], rtol=rtol,
                        atol=rtol * np.abs(j[key]).max(), err_msg=name + key)
                else:
                    assert np.abs(got - j[key]).max() <= 1, name + key
            codes = sd[f"{name}.w_int"].numpy().astype(np.int32)
            assert codes.shape[0] == 2 and codes.min() >= -8 and \
                codes.max() <= 7
            diff = np.abs(codes - j["w_int"].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FRAC, name
    # both timeranges were calibrated, and differ
    a = sd["blocks.0.mlp.fc1.act_scale"]
    assert (a > 0).all() and not torch.equal(a[0], a[1])
    # the fp-listed layers are balanced too (quant_layer.py:188-189)
    assert (sd["x_embedder.proj.cb_scale"] > 0).all()
    assert "x_embedder.proj.w_int" not in sd


def test_cb_plain_call_audit(built, monkeypatch):
    # per block, the fused plan's counts (tests/test_torch_fused.py): CB
    # adds no pass, and no layer divides its input by cs itself
    from test_torch_fused import PLAIN
    calls = {name: 0 for _, name in PLAIN}
    divides = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapped)
    for mod, name in PLAIN:
        spy(mod, name)
    real = qlinear.divide_cols
    monkeypatch.setattr(qlinear, "divide_cols",
                        lambda *a: divides.append(1) or real(*a))
    port = built(True)[2]
    x, _, y, mask = inputs()
    _forward(port, x, np.full((2,), 700, np.int32), y, mask, 700)
    depth = len(port.blocks)
    assert calls.pop("fused_dynq_int8_matmul_plain") == 2 * depth
    assert calls.pop("ln_modulate_quantize_plain") == 2 * depth
    assert calls.pop("int8_consumer_matmul_plain") == 13 * depth
    assert calls.pop("quantize_rows_plain") == 4 * depth
    assert calls.pop("attention_bnhd_plain") == 3 * depth
    assert not any(calls.values()), calls
    # the only true divisions: the two fp-listed layers (x_embedder,
    # final_layer), which have no producer to fold into
    assert len(divides) == 2


def test_bridge_drops_cbshare_only_when_equal(built):
    _, jv, _, _ = built(True)
    quant = jax.tree.map(np.array, jv["quant"])
    blk = quant["blocks_0"]
    shares = sorted(k for k in blk if k.startswith("cbshare__"))
    assert shares == ["cbshare__attn__q", "cbshare__mlp__fc1"]
    assert "cbshare__proj" in blk["attn"] and "cbshare__q" in blk["attn"]
    sd = state_dict_from_flax(jv["params"], quant)
    assert not any("cbshare" in k for k in sd)
    assert torch.equal(sd["blocks.0.attn.q.cb_scale"],
                       torch.from_numpy(blk["cbshare__attn__q"]))
    blk["attn"]["cbshare__proj"][1, 3] *= 2.0
    with pytest.raises(ValueError, match="cbshare__proj"):
        state_dict_from_flax(jv["params"], quant)


def _one_layer(frozen, seed=58):
    """One CB QuantLinear in both packages on equal weights and act maxima:
    (JAX module, its variables, port layer, x)."""
    from viditq_tpu.quant.qlinear import QuantLinear as JQuantLinear
    from viditq_tpu.utils.config import load_quant_config as j_load
    from viditq_tpu_torch.utils.config import load_quant_config
    specs = []
    for load in (j_load, load_quant_config):
        d = cb_plan()(load(CB)).default_layer
        specs.append(dataclasses.replace(d, smooth_quant=dataclasses.replace(
            d.smooth_quant, frozen_tr0_weights=frozen)))
    rng = np.random.default_rng(seed)
    K, N = 128, 64
    x = (rng.standard_normal((2, 40, K)) + 0.2).astype(np.float32)
    jlin = JQuantLinear(N, lspec=specs[0], dtype=jnp.float32)
    v = jlin.init(jax.random.PRNGKey(0), jnp.asarray(x),
                  JQuantCtx(mode="fp"))
    params = {"kernel": (rng.standard_normal((K, N)) * 0.1).astype(
        np.float32), "bias": rng.standard_normal(N).astype(np.float32)}
    act = rng.uniform(0.1, 4.0, (2, K)).astype(np.float32)
    from viditq_tpu.quant.calibrate import weight_qparams_for_layer
    from viditq_tpu.quant.native_pack import _pack_layer
    cb = np.stack([np.asarray(jcore.smooth_quant_scale(
        jnp.asarray(act[tr]), jnp.abs(jnp.asarray(params["kernel"])).max(-1),
        0.11)) for tr in range(2)])
    tabs = weight_qparams_for_layer(jnp.asarray(params["kernel"]), specs[0],
                                    cb=jnp.asarray(cb))
    w_int, w_colsum = _pack_layer(jnp.asarray(params["kernel"]),
                                  tabs["w_delta"], tabs["w_zp"],
                                  specs[0].weight, specs[0].smooth_quant,
                                  None, cb=jnp.asarray(cb))
    quant = {**v["quant"], "act_scale": act, "cb_scale": cb,
             "w_delta": tabs["w_delta"], "w_zp": tabs["w_zp"],
             "w_int": w_int, "w_colsum": w_colsum}
    jv = {"params": params, "quant": quant, "qstats": v["qstats"]}
    lin = QuantLinear(K, N, specs[1], dtype=torch.float32)
    lin.load_state_dict(state_dict_from_flax(params, quant))
    return jlin, jv, lin, x


@pytest.mark.parametrize("frozen", [True, False],
                         ids=["frozen_tr0", "corrected_tr_weight_tables"])
def test_one_cb_layer_matches_jax(frozen):
    # `corrected_tr_weight_tables`: each timerange dequantizes its slab
    # with its own tables; frozen (the reference's runtime): timerange 0's
    jlin, jv, lin, x = _one_layer(frozen)
    outs = {}
    for t_id in (250, 750):
        with jax_kernel_path():
            want = np.asarray(jlin.apply(
                jv, jnp.asarray(x),
                JQuantCtx(mode="quant", t_id=jnp.asarray(t_id))))
        with torch.no_grad():
            got = lin(t(x), QuantCtx(t_id=t_id)).numpy()
        assert rel_err(got, want) < 1e-4, t_id
        outs[t_id] = got
    assert not np.array_equal(outs[250], outs[750])
    # the tables of timerange 1 differ from timerange 0's
    assert not torch.equal(lin.w_delta[0, 0], lin.w_delta[0, 1])


def test_native_dynamic_cb_type_raises():
    from viditq_tpu_torch.utils.config import load_quant_config
    d = cb_plan()(load_quant_config(CB)).default_layer
    dyn = dataclasses.replace(d, smooth_quant=dataclasses.replace(
        d.smooth_quant, channel_wise_scale_type="dynamic"))
    with pytest.raises(ValueError, match="momentum"):
        QuantLinear(64, 64, dyn)


def test_chip_smoke_carries_the_cb_cases_and_arms():
    import inspect
    import chip_smoke as cs
    # the CB arms run the fused kernels, each on its own model calibrated
    # in the PTQ phase order, held to the fused (cb) and sym (cb_sym)
    # arms' per-block launches: CB adds no launch
    for arm in ("cb", "cb_sym"):
        assert cs.SLICE_KERNELS["stdit"][arm] == cs.FUSED_KERNELS
        assert cs.ARM_PLANS[("stdit", arm)].name == CB.split("/")[-1]
        assert cs.PLAN_RECIPES[("stdit", arm)] == arm
    assert cs.BLOCK_LAUNCHES[("stdit", "cb")] == cs.BLOCK_LAUNCHES[
        ("stdit", "fused")]
    assert cs.BLOCK_LAUNCHES[("stdit", "cb_sym")] == {
        **cs.BLOCK_LAUNCHES[("stdit", "fused")], "quantize_rows": 1}
    assert len(cs.CB_STAT_T) == 2 and all(
        qlinear.timerange_of(cs.quant_plan(cs.CB_PLAN, "cb").default_layer
                             .smooth_quant, t) == i
        for i, t in enumerate(cs.CB_STAT_T))
    smooth = cs.quant_plan(cs.CB_PLAN, "cb_sym").default_layer.smooth_quant
    assert smooth.qkv_share_cs and smooth.alpha_for_range(1) == cs.CB_ALPHA
    assert "smooth_quant_stats" in inspect.getsource(cs.build_model)
    run = inspect.getsource(cs.run_slice)
    assert "tr_steps" in run and "register_forward_pre_hook" in run
    src = inspect.getsource(cs.cb_cases)
    for part in ("FM.quantize_rows(x2, sym, col_scale=cs)", "gelu=True",
                 "check_k5(records, case", "col_scale=ics, **kw",
                 '"col_scale": ics4', "edge=True", "with_and_without(",
                 'ASYM_TOL["attn"]'):
        assert part in src, part
    assert "cb_cases(records)" in inspect.getsource(cs.phase_kernels)
    for arm in ("cb", "cb_sym"):
        assert f'"{arm}")' in inspect.getsource(cs.phase_reference)
