"""Timestep-wise mixed precision (t20 MP, the rest of ViDiT-Q's W4A8
recipe) in the PyTorch port against the JAX package: the range parsing and
the union partition of the MP step ranges and the CB timeranges, the gather
sampler's per-layer bits, its prepared union model (per-span slabs at each
span's bits and their dequant tables) and its 2-step CFG DDIM, the
segmented fallback on a native plan without CB, the rules that send a plan
to one path or refuse it, and the `mp_bits` packing of one layer.

The JAX models run their kernel path in interpret mode (tests/
torch_parity.py); its gather sampler runs without `static_segments`
(one program, the same union variables).

Tolerances, each with its reason:
  * the union tables: the prepared union models start from one base (the
    JAX package's calibrated CB model, bridged), so the act statistics are
    the same; cb_scale = a^alpha / w^(1-alpha) goes through each library's
    pow: 1e-5 of each entry and of the table's largest (C13, the CB
    tables' tolerance); w_mp_scale is the min-max scale of kernel * cs and
    w_mp_zp its zero point shifted: each within 1e-5 of JAX's (the ulps of
    cs) and exactly the port's own w_delta / w_zp - 2^(bits-1) at the
    span's bits; the codes w_int and their column sums w_colsum: a code
    may flip where w * cs / d lies within an ulp of a half, at no more
    than 0.1% of entries, as the CB slabs (tests/test_torch_cb.py);
  * sampling: a 2-step CFG DDIM within 2e-2 relative of JAX's, the
    denoise limit of every int8 plan (PERF.md §2); the port's gather path
    against its own segmented path within 1e-2 (tests/test_analysis.py's
    limit for the JAX pair: the two paths run the same codes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (CB, CB_STAT_T, TINY, build_jax, build_port,
                          cb_plan, inputs, jax_kernel_path, native_plan,
                          rel_err)
from viditq_tpu.models.stdit import STDiT as JSTDiT
from viditq_tpu.pipelines import analysis as j_analysis
from viditq_tpu.pipelines import mixed_precision as jmp
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.models.stdit import STDiT
from viditq_tpu_torch.pipelines import analysis
from viditq_tpu_torch.pipelines import mixed_precision as mp
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.bridge import state_dict_from_flax
from viditq_tpu_torch.utils.config import (load_bitwidth_config,
                                           load_quant_config)

T20_W = "configs/opensora/mixed_precision/t20_weight_4_mp.yaml"
T20_A = "configs/opensora/mixed_precision/t20_act_8_mp.yaml"
TABLE_TOL = 1e-5
CODE_FRAC = 1e-3
DENOISE_TOL = 2e-2
PATHS_TOL = 1e-2
# per-range bits that differ (tests/test_analysis.py:217-220, retiled onto
# 2 steps), with a module-prefix entry: blocks.1.attn covers its q/k/v/proj
MP_W = {"1-1": {"model.blocks.0.attn.q": 8, "model.blocks.1.mlp.fc1": 8,
                "model.blocks.1.attn": 6},
        "0-0": {"model.blocks.0.attn.q": 4},
        "fp_layers": ["model.blocks.1.cross_attn.kv_linear"]}


def _t20():
    return load_bitwidth_config(T20_W), load_bitwidth_config(T20_A)


def _retile(mp_w):
    """The 20-step ranges onto 2 steps, as the JAX bench's tiny mode
    (benchmarks/bench_configs.py:231-234)."""
    vals = [v for k, v in mp_w.items() if k != "fp_layers"]
    return {"1-1": vals[0], "0-0": vals[1], "fp_layers": []}


def _plans(transform):
    return (transform(j_load(CB)), transform(load_quant_config(CB)))


def _jctor(r):
    return JSTDiT(resolver=r, dtype=jnp.float32, **TINY)


def _ctor(r):
    return STDiT(resolver=r, dtype=torch.float32, **TINY).eval()


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("steps", [20, 2])
def test_ranges_spans_and_union_match_jax(steps):
    mp_w, mp_a = _t20()
    if steps == 2:
        mp_w, mp_a = _retile(mp_w), None
    assert (analysis.parse_mp_ranges(mp_w)
            == j_analysis.parse_mp_ranges(mp_w))
    w_ranges = analysis.parse_mp_ranges(mp_w)
    spans, bits = mp._mp_tspans(IDDPM(num_sampling_steps=steps), w_ranges)
    j_spans, j_bits = jmp._mp_tspans(JIDDPM(num_sampling_steps=steps),
                                     w_ranges)
    assert spans == j_spans and bits == j_bits
    cb = list(load_quant_config(CB).default_layer.smooth_quant.timerange)
    union = mp._union_partition(spans, cb)
    assert union == jmp._union_partition(j_spans, cb)
    if steps == 20:
        assert union[0] == [(0, 236), (237, 499), (500, 500), (501, 762),
                            (763, 1000)]
    if mp_a is not None:
        assert [r for r, _ in analysis.parse_mp_ranges(mp_a)] == \
            [r for r, _ in w_ranges]


def _names(model, depth=None):
    """Every QuantLinear name of the tiny port model; with depth, its block
    names repeated over `depth` blocks (STDiT-XL/2's 28)."""
    names = [n for n, m in model.named_modules()
             if isinstance(m, QuantLinear)]
    if depth is None:
        return names
    out = [n for n in names if not n.startswith("blocks.")]
    for i in range(depth):
        out += [f"blocks.{i}." + n.split(".", 2)[2] for n in names
                if n.startswith("blocks.0.")]
    return out


@pytest.mark.parametrize("cfg", ["t20", "t20-xl", "prefix", "mixed"])
def test_gather_resolver_bits_match_jax(cfg):
    jplan, plan = _plans(cb_plan(True))
    steps = 20
    mp_w, mp_a = _t20()
    if cfg == "prefix":
        # module-prefix entries cover their leaf linears
        mp_w, mp_a, steps = {"1-1": {"model.blocks.0.attn": 8},
                             "0-0": {"model.blocks.0.attn": 4,
                                     "model.blocks.1": 6}}, None, 2
    elif cfg == "mixed":
        mp_w, mp_a, steps = MP_W, None, 2
    run = mp.build_mp_sampler(_ctor, IDDPM(num_sampling_steps=steps), plan,
                              mp_w, mp_a)
    jrun = jmp.build_mp_sampler(_jctor, JIDDPM(num_sampling_steps=steps),
                                jplan, mp_w, mp_a)
    assert isinstance(run, mp.GatherMPSampler)
    assert run.n_ranges == jrun.n_ranges
    names = _names(_ctor(plan.resolver()), 28 if cfg == "t20-xl" else None)
    seen = set()
    for name in names:
        got, want = run.resolver(name), jrun.resolver(name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        if got.weight_quant:
            seen.add(got.weight.mp_bits)
    if cfg.startswith("t20"):
        # attention linears W4, fc1/fc2 W8 in every span
        assert seen == {(4,) * 5, (8,) * 5}
        assert run.resolver("blocks.27.mlp.fc2").weight.mp_bits == (8,) * 5
    else:
        assert len(seen) > 1


@pytest.fixture(scope="module")
def cb_base():
    """(JAX model, variables after sq_stat, calibrate and pack) of the tiny
    STDiT under the CB recipe, asym and sym (the sym model takes the asym
    model's act statistics: the sq_stat forwards are the fp model's)."""
    cache = {}

    def get(sym):
        if sym not in cache:
            stat = (dict(act_scales=get(False)[1]["quant"]) if sym
                    else dict(sq_stat_t=CB_STAT_T))
            cache[sym] = build_jax(CB, plan_fn=cb_plan(True, sym), **stat)
        return cache[sym]
    return get


def _prepared(cb_base, sym, mp_w=MP_W, steps=2):
    """(JAX gather sampler and its union variables, port gather sampler and
    its union model), both prepared from the JAX base model."""
    jmodel, jv = cb_base(sym)
    jplan, plan = _plans(cb_plan(True, sym))
    jrun = jmp.build_mp_sampler_gather(
        _jctor, JIDDPM(num_sampling_steps=steps), jplan, mp_w, None,
        static_segments=False)
    z, y, mask = _mp_inputs()
    jprep = jrun.prepare(jv, jnp.asarray(z), jnp.asarray(y),
                         jnp.asarray(mask))
    run = mp.build_mp_sampler(_ctor, IDDPM(num_sampling_steps=steps), plan,
                              mp_w, None)
    base = build_port(CB, jv, plan_fn=cb_plan(True, sym))
    return jrun, jprep, run, run.prepare(base), base


def _mp_inputs():
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    return x, y2, mask


def _check_union(jprep, run, union, base, sym) -> int:
    """The port's union model against JAX's prepared variables, layer by
    layer at the stated tolerances; returns how many layers carry
    mp_bits."""
    want = state_dict_from_flax(jprep["params"], jprep["quant"])
    got = union.state_dict()
    assert set(got) == set(want)
    # the union model shares the base's parameters (one fp weight set)
    assert union.blocks[0].attn.q.kernel is base.blocks[0].attn.q.kernel
    n_mp = 0
    for name, mod in union.named_modules():
        if not isinstance(mod, QuantLinear) or mod.smooth is None:
            continue
        assert mod.smooth.timerange == run.spans
        np.testing.assert_array_equal(
            mod.act_scale.numpy(), base.get_submodule(name).act_scale[
                list(run.cb_idx)].numpy())
        w = want[f"{name}.cb_scale"].numpy()
        np.testing.assert_allclose(mod.cb_scale.numpy(), w, rtol=TABLE_TOL,
                                   atol=TABLE_TOL * np.abs(w).max())
        if not mod.native:
            continue
        wspec = mod.lspec.weight
        assert mod.mp == (run.resolver(name).weight.mp_bits is not None)
        n_mp += mod.mp
        bits = wspec.mp_bits or (wspec.n_bits,) * run.n_ranges
        codes = mod.w_int.numpy().astype(np.int32)
        diff = np.abs(codes - want[f"{name}.w_int"].numpy())
        assert diff.max() <= 1 and (diff > 0).mean() <= CODE_FRAC, name
        cs = mod.w_colsum.numpy()
        np.testing.assert_array_equal(cs, codes.sum(axis=1, keepdims=True))
        np.testing.assert_array_equal(
            diff.sum(axis=1, keepdims=True) == 0,
            cs == want[f"{name}.w_colsum"].numpy())
        for tr, b in enumerate(bits):
            lo, hi = -2 ** (b - 1), 2 ** (b - 1) - 1
            assert lo <= codes[tr].min() and codes[tr].max() <= hi
            if not mod.mp:
                continue
            bi = wspec.bits_tuple.index(b)
            # frozen_tr0_weights: timerange 0's tables at the span's bits
            d = mod.w_delta[bi, 0].reshape(1, -1)
            assert torch.equal(mod.w_mp_scale[tr], d)
            zp = (torch.zeros_like(d) if sym else
                  mod.w_zp[bi, 0].reshape(1, -1) - 2 ** (b - 1))
            assert torch.equal(mod.w_mp_zp[tr], zp)
        for key in ("w_mp_scale", "w_mp_zp") if mod.mp else ():
            w = want[f"{name}.{key}"].numpy()
            np.testing.assert_allclose(
                getattr(mod, key).numpy(), w, rtol=TABLE_TOL,
                atol=TABLE_TOL * np.abs(w).max(), err_msg=name + key)
    return n_mp


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_prepare_matches_jax(cb_base, sym):
    _, jprep, run, union, base = _prepared(cb_base, sym)
    n_mp = _check_union(jprep, run, union, base, sym)
    # the kinds MP_W overrides carry mp_bits in every block: attn's q, k, v,
    # proj (the module prefix) and mlp.fc1, in both blocks
    assert n_mp == 10
    # the prepared model passes through, and the base's is kept
    assert run.prepare(union) is union and run.prepare(base) is union


def test_prepare_adapts_a_base_on_the_cb_partition(cb_base):
    """One MP range over the whole schedule: the union partition is the CB
    partition, so only the bits tell the base model from the union model;
    the base must still be adapted (fc1 at W8 in every span), as JAX's
    prepare does."""
    one = {"1-0": {"model.blocks.0.mlp.fc1": 8}}
    _, jprep, run, union, base = _prepared(cb_base, False, mp_w=one)
    assert run.spans == tuple(load_quant_config(CB).default_layer
                              .smooth_quant.timerange)
    assert union is not base and not run.is_prepared(base)
    # fc1 carries mp_bits in both blocks (its kind is overridden): W8 in
    # block 0, the plan's W4 in block 1
    assert _check_union(jprep, run, union, base, False) == 2
    assert union.blocks[0].mlp.fc1.lspec.weight.mp_bits == (8, 8)
    assert union.blocks[1].mlp.fc1.lspec.weight.mp_bits == (4, 4)


def test_gather_denoise_matches_jax(cb_base):
    jrun, jprep, run, union, base = _prepared(cb_base, False)
    z, y, mask = _mp_inputs()
    with jax_kernel_path():
        want = np.asarray(jrun(jprep, jnp.asarray(z), jnp.asarray(y),
                               jnp.asarray(mask)))
    got = run(base, _t(z), _t(y), _t(mask)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < DENOISE_TOL
    assert rel_err(got, z) > 0.01
    # the same sampler through the segmented path: the same codes
    sampler = IDDPM(num_sampling_steps=2)
    seg = mp.SegmentedMPSampler(_ctor, sampler, mp._build_segments(
        sampler, _plans(cb_plan(True))[1], MP_W, None))
    assert rel_err(seg(base, _t(z), _t(y), _t(mask)).numpy(),
                   got) < PATHS_TOL


def _no_cb_native(plan):
    """The W4A8 plan without channel balancing, on the native backend's
    Pallas impl (the port runs it as its one native dataflow, K7a -> K7b):
    the segmented path's case."""
    plan = native_plan("pallas")(plan)
    d = plan.default_layer
    return dataclasses.replace(plan, default_layer=dataclasses.replace(
        d, smooth_quant=type(d.smooth_quant)()))


def test_segmented_native_matches_jax():
    jplan, plan = _plans(_no_cb_native)
    jmodel, jv = build_jax(CB, plan_fn=_no_cb_native)
    z, y, mask = _mp_inputs()
    jrun = jmp.build_mp_sampler(_jctor, JIDDPM(num_sampling_steps=2), jplan,
                                MP_W, None, force_segmented=True)
    with jax_kernel_path():
        want = np.asarray(jrun(jv, jnp.asarray(z), jnp.asarray(y),
                               jnp.asarray(mask)))
    run = mp.build_mp_sampler(_ctor, IDDPM(num_sampling_steps=2), plan,
                              MP_W, None)
    assert isinstance(run, mp.SegmentedMPSampler)
    base = build_port(CB, jv, plan_fn=_no_cb_native)
    got = run(base, _t(z), _t(y), _t(mask)).numpy()
    assert np.isfinite(got).all()
    assert rel_err(got, want) < DENOISE_TOL
    # the ranges' own bits ran: all-W4 is another trajectory
    w4 = mp.build_mp_sampler(_ctor, IDDPM(num_sampling_steps=2), plan,
                             {"1-0": {}}, None)
    assert rel_err(w4(base, _t(z), _t(y), _t(mask)).numpy(), got) > 1e-4
    # and the base model's own slabs are untouched
    assert base.blocks[0].attn.q.w_int.abs().max() <= 8


def _rule_case(case):
    """(plan transform, weight config, act config) of one rule case."""
    t20 = {"1-1": {"model.blocks.0.attn.q": 8}, "0-0": {}}
    fused = cb_plan(True)

    def with_default(**kw):
        def transform(plan):
            plan = fused(plan)
            d = plan.default_layer
            return dataclasses.replace(plan, default_layer=dataclasses.replace(
                d, **{k: v(d) for k, v in kw.items()}))
        return transform
    act = lambda **kw: (lambda d: dataclasses.replace(d.act, **kw))  # noqa
    sq = lambda **kw: (  # noqa: E731
        lambda d: dataclasses.replace(d.smooth_quant, **kw))
    return {
        "static-acts": (with_default(act=act(dynamic=False)), t20, None),
        "acts-6-bit": (with_default(act=act(n_bits=6)), t20, None),
        "varying-act-bits": (fused, t20, {"1-1": {"model.blocks.0.attn.q":
                                                  6}}),
        "cb-off": (with_default(smooth_quant=sq(enable=False)), t20, None),
        "cb-dynamic": (with_default(smooth_quant=sq(
            channel_wise_scale_type="dynamic")), t20, None),
        "bits-outside": (fused, {"1-1": {"model.blocks.0.attn.q": 5},
                                 "0-0": {}}, None),
        "no-ranges": (fused, {"fp_layers": []}, None),
        "gap": (fused, {"1-1": {}}, None),
        "overlap": (fused, {"1-0": {}, "0-0": {}}, None),
        "stray-act": (fused, t20, {"5-3": {}}),
    }[case]


@pytest.mark.parametrize("case", [
    "static-acts", "acts-6-bit", "varying-act-bits", "cb-off", "cb-dynamic",
    "bits-outside", "no-ranges", "gap", "overlap", "stray-act"])
def test_gather_rules_match_jax(case):
    transform, mp_w, mp_a = _rule_case(case)
    jplan, plan = _plans(transform)
    args = (IDDPM(num_sampling_steps=2), plan, mp_w, mp_a)
    jargs = (JIDDPM(num_sampling_steps=2), jplan, mp_w, mp_a)
    if case in ("gap", "overlap"):
        for fn, ctor, a in ((mp.build_mp_sampler_gather, _ctor, args),
                            (jmp.build_mp_sampler_gather, _jctor, jargs),
                            (mp._build_segments, None, args),
                            (jmp._build_segments, _jctor, jargs)):
            with pytest.raises(ValueError, match="do not tile"):
                fn(*a) if ctor is None else fn(ctor, *a)
        return
    got = mp.build_mp_sampler_gather(_ctor, *args)
    want = jmp.build_mp_sampler_gather(_jctor, *jargs)
    if case == "stray-act":
        # the gather path reads act bits only for their value; the
        # segmented path refuses an act range without a weight range
        assert got is not None and want is not None
        for fn in (lambda: mp._build_segments(*args),
                   lambda: jmp._build_segments(_jctor, *jargs)):
            with pytest.raises(ValueError, match="no matching"):
                fn()
        return
    assert got is None and want is None


def test_simulate_plan_raises():
    plan = cb_plan(True)(load_quant_config(CB))
    sim = dataclasses.replace(plan, default_layer=dataclasses.replace(
        plan.default_layer, backend="simulate"))
    assert not sim.uses_native() and plan.uses_native()
    assert mp.build_mp_sampler_gather(_ctor, IDDPM(num_sampling_steps=2),
                                      sim, MP_W, None) is None
    with pytest.raises(NotImplementedError, match="simulate"):
        mp.build_mp_sampler(_ctor, IDDPM(num_sampling_steps=2), sim, MP_W,
                            None)


def test_plan_surface_matches_jax():
    jplan, plan = _plans(cb_plan(True))
    # with_bits: calibrated bitwidths only for static quantizers
    for w, a in ((6, None), (8, 6), (None, 4)):
        assert (dataclasses.asdict(plan.with_bits(w, a).default_layer)
                == dataclasses.asdict(jplan.with_bits(w, a).default_layer))
    for p in (plan, jplan):
        with pytest.raises(ValueError, match="calibrated bitwidths"):
            p.with_bits(5)
    # resolver overrides win over the fp list and the default, by pattern
    ov = analysis.mp_overrides_for_range(
        {"model.blocks.0.attn": 8, "model.x_embedder": 6}, None,
        plan.default_layer)
    jov = j_analysis.mp_overrides_for_range(
        {"model.blocks.0.attn": 8, "model.x_embedder": 6}, None,
        jplan.default_layer)
    res, jres = plan.resolver(ov), jplan.resolver(jov)
    for name in _names(_ctor(plan.resolver())):
        assert (dataclasses.asdict(res(name))
                == dataclasses.asdict(jres(name))), name
    assert res("blocks.0.attn.q").weight.n_bits == 8
    assert res("x_embedder.proj").weight_quant  # fp-listed, overridden


def _mp_layer(bits, sym=False, seed=7):
    """One CB QuantLinear of two timeranges with mp_bits `bits` in both
    packages, on equal weights and act maxima, the JAX tables made and
    packed by the JAX package, the port's packed by the port: (JAX module,
    its variables, port layer, x)."""
    from viditq_tpu.quant import QuantCtx as JQuantCtx
    from viditq_tpu.quant import core as jcore
    from viditq_tpu.quant.calibrate import weight_qparams_for_layer
    from viditq_tpu.quant.native_pack import _pack_layer
    from viditq_tpu.quant.qlinear import QuantLinear as JQuantLinear
    specs = []
    for plan in _plans(cb_plan(True, sym)):
        d = plan.default_layer
        specs.append(dataclasses.replace(d, weight=dataclasses.replace(
            d.weight, mp_bits=bits)))
    rng = np.random.default_rng(seed)
    K, N = 64, 32
    x = (rng.standard_normal((2, 40, K)) + 0.2).astype(np.float32)
    params = {"kernel": (rng.standard_normal((K, N)) * 0.1).astype(
        np.float32), "bias": rng.standard_normal(N).astype(np.float32)}
    act = rng.uniform(0.1, 4.0, (2, K)).astype(np.float32)
    cb = np.stack([np.asarray(jcore.smooth_quant_scale(
        jnp.asarray(act[tr]), jnp.abs(jnp.asarray(params["kernel"])).max(-1),
        0.11)) for tr in range(2)])
    kernel = jnp.asarray(params["kernel"])
    tabs = weight_qparams_for_layer(kernel, specs[0], cb=jnp.asarray(cb))
    packed = _pack_layer(kernel, tabs["w_delta"], tabs["w_zp"],
                         specs[0].weight, specs[0].smooth_quant, None,
                         cb=jnp.asarray(cb))
    jlin = JQuantLinear(N, lspec=specs[0], dtype=jnp.float32)
    v = jlin.init(jax.random.PRNGKey(0), jnp.asarray(x),
                  JQuantCtx(mode="fp"))
    quant = {**v["quant"], "act_scale": act, "cb_scale": cb,
             "w_delta": tabs["w_delta"], "w_zp": tabs["w_zp"],
             **dict(zip(("w_int", "w_colsum", "w_mp_scale", "w_mp_zp"),
                        packed))}
    jv = {"params": params, "quant": jax.tree.map(np.asarray, quant),
          "qstats": v["qstats"]}
    lin = QuantLinear(K, N, specs[1], dtype=torch.float32)
    sd = state_dict_from_flax(params, {k: jv["quant"][k] for k in (
        "act_scale", "cb_scale", "w_delta", "w_zp")})
    lin.load_state_dict(sd, strict=False)
    pack_native_weights(lin)
    return jlin, jv, lin, x


@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_mp_bits_pack_per_range_like_jax(sym):
    # fails on a tree where mp_bits is declared but not read: the layer
    # then has no per-range tables and packs every range at n_bits
    from viditq_tpu.quant import QuantCtx as JQuantCtx
    jlin, jv, lin, x = _mp_layer((4, 8), sym)
    want = jv["quant"]
    assert lin.mp and lin.w_mp_scale.shape == (2, 1, 32)
    codes = lin.w_int.numpy().astype(np.int32)
    assert codes[0].min() >= -8 and codes[0].max() <= 7
    assert codes[1].max() - codes[1].min() > 15  # 8-bit codes
    # the same f32 products and divisions: the port's packing is exact
    np.testing.assert_array_equal(codes, want["w_int"].astype(np.int32))
    for key in ("w_colsum", "w_mp_scale", "w_mp_zp"):
        np.testing.assert_array_equal(getattr(lin, key).numpy(), want[key])
    # each timerange dequantizes with its own bits' tables: the layer's
    # output within 1e-4 of JAX's, the one-layer tolerance of the CB
    # layer (tests/test_torch_cb.py)
    outs = []
    for t_id in (250, 750):
        with jax_kernel_path():
            ref = np.asarray(jlin.apply(
                jv, jnp.asarray(x),
                JQuantCtx(mode="quant", t_id=jnp.asarray(t_id))))
        with torch.no_grad():
            outs.append(lin(_t(x), QuantCtx(t_id=t_id)).numpy())
        assert rel_err(outs[-1], ref) < 1e-4, t_id
    fp = np.asarray(x) @ jv["params"]["kernel"] + jv["params"]["bias"]
    assert rel_err(outs[1], fp) < rel_err(outs[0], fp)  # W8 beside W4


def test_mp_bits_of_the_wrong_length_raise():
    plan = cb_plan(True)(load_quant_config(CB))
    d = plan.default_layer
    bad = dataclasses.replace(d, weight=dataclasses.replace(
        d.weight, mp_bits=(4, 8, 8)))
    with pytest.raises(ValueError, match="mp_bits length"):
        QuantLinear(64, 32, bad)
