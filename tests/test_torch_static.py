"""The port's static-act paths and their calibration pass against the JAX
package on equal weights and inputs (numpy draws from a seed).

Layer level: 'a_calib' forwards into timestep slots (the blended ranges
with and without `running_stat`, and the act handed to the dense product,
to one float32 ulp as in `tests/test_torch_simulate.py`), the finished
tables to 1e-6 relative, and the static quant forward, on the simulate
backend and as native int8 codes: the codes the port hands K7b's and
K2's plain versions differ from those JAX hands its int8 matmul oracle /
consumer kernel by at most one at no more than 0.1% of entries
(`CODE_MISMATCH_FRAC`, the kernel rule of `chip_smoke.py`: the
reciprocal of the scale is rounded by each library's division).

Model level, the tiny STDiT under `w8a8_naive` (static per-tensor acts):
`run_ptq` (sq_stat -> weight tables -> a_calib -> `finalize_act_tables`)
on the calibration data of a 2-step fp trajectory (`get_calib_data`,
itself held to the JAX package's trajectory at the fp limit 1e-4),
against the JAX package's `run_ptq` on the same data: every a_delta /
a_zp within 1e-6 relative, the act slot map equal. Then the quantized
forward (1e-2) and a 2-step CFG DDIM with the slot map (2e-2), as the
int8 model tests hold them; and the same tables on the native backend
under impl 'fused' (K2 on static codes, 13 a block, no other int8
kernel) within 1e-2 of the simulate forward. The PixArt static plans:
`tests/test_torch_plans.py`.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simulate import (DenseSpy, _t, _x, jax_forwards,
                                 layer_pair, run_pair, spec_pair)
from torch_parity import (build_jax, build_port, inputs, jax_kernel_path,
                          rel_err)
from viditq_tpu.pipelines import inference as j_inf
from viditq_tpu.pipelines.ptq import run_ptq as j_run_ptq
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant.calibrate import finalize_act_tables as j_finalize
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.pipelines import inference as p_inf
from viditq_tpu_torch.pipelines.ptq import run_ptq
from viditq_tpu_torch.quant import qlinear as QL
from viditq_tpu_torch.quant.calibrate import finalize_act_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.config import load_quant_config

NAIVE = "configs/opensora/w8a8_naive.yaml"
SQ_STATIC = "configs/pixart/w8a8_sq_static.yaml"
Q_DIFFUSION = "configs/pixart/w8a8_q_diffusion.yaml"
TABLE_REL = 1e-6
FP_TOL = 1e-4
FWD_TOL = 1e-2
DENOISE_TOL = 2e-2
CODE_MISMATCH_FRAC = 1e-3


def _static(gran="tensor", running=False, n_ts=1):
    def change(s):
        return dataclasses.replace(s, act=dataclasses.replace(
            s.act, granularity=gran, running_stat=running,
            timestep_wise=n_ts > 1, n_timestep=n_ts))
    return change


def _close(got, want, rel=TABLE_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


# (granularity, running_stat, layout fields, input shape)
STATIC_CASES = {
    "tensor": ("tensor", False, {}, (2, 16, 64)),
    "tensor-running": ("tensor", True, {}, (2, 16, 64)),
    "token-running": ("token", True, {}, (2, 16, 64)),
    "cross_kv-token": ("token", False,
                       dict(token_layout="cross_kv", n_prompt=6), (2, 6, 64)),
}


@pytest.mark.parametrize("case", list(STATIC_CASES))
def test_static_act_calibration_matches_jax(case, monkeypatch):
    gran, running, fields, shape = STATIC_CASES[case]
    specs = spec_pair(NAIVE, change=_static(gran, running, n_ts=2))
    jl, jv, pl = layer_pair(specs, _x(shape), **fields)
    assert pl.path == "simulate" and pl.static_act
    spy = DenseSpy(monkeypatch)
    qstats = jv["qstats"]
    # two forwards into slot 1 (blended under running_stat), one into 0
    for seed, slot in ((2, 1), (3, 1), (4, 0)):
        x = _x(shape, seed=seed, scale=1.0 + slot)
        want, upd = jl.apply({**jv, "qstats": qstats}, jnp.asarray(x),
                             qctx=JQuantCtx(mode="a_calib", act_slot=slot),
                             mutable=["qstats"])
        qstats = upd["qstats"]
        with torch.no_grad():
            got = pl(_t(x), QuantCtx(mode="a_calib", act_slot=slot))
        spy.check()
        assert rel_err(got.numpy(), np.asarray(want)) < 1e-2
        for k in ("a_min", "a_max"):
            _close(getattr(pl, k), qstats[k])
        assert torch.equal(pl.a_init, _t(qstats["a_init"]))
    quant = j_finalize(jv["quant"], qstats, lambda n: specs[0])
    finalize_act_tables(pl)
    for k in ("a_delta", "a_zp"):
        assert tuple(getattr(pl, k).shape) == quant[k].shape
        _close(getattr(pl, k), quant[k])
    jv = {**jv, "quant": quant, "qstats": qstats}
    for slot in (0, 1, 5):  # a slot past the table clamps to its last
        run_pair(jl, jv, pl, _x(shape, seed=6), spy, act_slot=slot)


def _code_spy(monkeypatch, module, name, jax_mod, jax_name):
    """Record the (codes, scale, zp, rowsum) each package's static path
    hands its int8 product: the port's K7b / K2 wrapper, JAX's int8 matmul
    oracle / consumer kernel."""
    seen = {"port": [], "jax": []}
    p_fn, j_fn = getattr(module, name), getattr(jax_mod, jax_name)

    def p_spy(*a, **k):
        seen["port"].append((a, k))
        return p_fn(*a, **k)

    def j_spy(*a, **k):
        seen["jax"].append((a, k))
        return j_fn(*a, **k)
    monkeypatch.setattr(module, name, p_spy)
    monkeypatch.setattr(jax_mod, jax_name, j_spy)
    return seen


def _codes_agree(got, want):
    got, want = np.asarray(got, np.int32), np.asarray(want, np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= CODE_MISMATCH_FRAC


@pytest.mark.parametrize("impl", [None, "fused"], ids=["k7b", "k2"])
@pytest.mark.parametrize("w_sym", [False, True], ids=["asym-w", "sym-w"])
def test_static_native_codes_match_jax(impl, w_sym, monkeypatch):
    import viditq_tpu.kernels.fused_matmul as JFM
    import viditq_tpu.kernels.int_matmul as JIM

    def change(s):
        s = _static("token", True)(s)
        return dataclasses.replace(
            s, backend="native", impl=impl,
            weight=dataclasses.replace(s.weight, sym=w_sym))
    specs = spec_pair(NAIVE, change=change)
    shape = (2, 16, 64)
    jl, jv, pl = layer_pair(specs, _x(shape))
    assert pl.path == "native_static" and pl.native
    # tables from one a_calib forward in each package's own layer
    x = _x(shape, seed=2, scale=3.0)
    _, upd = jl.apply(jv, jnp.asarray(x), qctx=JQuantCtx(mode="a_calib"),
                      mutable=["qstats"])
    jv = {**jv, "qstats": upd["qstats"],
          "quant": j_finalize(jv["quant"], upd["qstats"],
                              lambda n: specs[0])}
    with torch.no_grad():
        pl(_t(x), QuantCtx(mode="a_calib"))
    finalize_act_tables(pl)
    if impl == "fused":
        seen = _code_spy(monkeypatch, QL, "int8_consumer_matmul", JFM,
                         "int8_consumer_matmul")
    else:
        seen = _code_spy(monkeypatch, QL, "int8_matmul", JIM,
                         "int8_matmul_ref")
    x = _x(shape, seed=7, scale=2.0)
    with jax_kernel_path():
        want = np.asarray(jl.apply(jv, jnp.asarray(x), qctx=JQuantCtx()))
    with torch.no_grad():
        got = pl(_t(x), QuantCtx()).numpy()
    (pa, pk), = seen["port"]
    (ja, jk), = seen["jax"]
    _codes_agree(pa[0], ja[0])
    if impl == "fused":  # (x_q, x_scale, ...), zero points by keyword
        _close(pa[1], ja[1])
        for key in ("x_zp", "x_rowsum"):
            assert (pk[key] is None) == (jk[key] is None), key
        assert pk["x_zp"] is not None  # asym acts
        assert (pk["x_rowsum"] is None) is False
    else:  # (x_q, w_q, x_scale, x_zp, x_rowsum, ...)
        _close(pa[2], ja[2])
        np.testing.assert_array_equal(np.asarray(pa[3]), np.asarray(ja[3]))
    assert rel_err(got, want) < FWD_TOL


# ---- model level: run_ptq ----

def _calib(jmodel, jv, sampler_pair, x, y2, mask):
    """JAX's fp calibration trajectory, and the port's on the same model,
    held to the fp limit."""
    js, ps, port = sampler_pair
    with jax_kernel_path():
        jcal = j_inf.get_calib_data(jmodel, jv, js, jnp.asarray(x),
                                    jnp.asarray(y2), jnp.asarray(mask))
    pcal = p_inf.get_calib_data(port, ps, _t(x), _t(y2), _t(mask))
    assert tuple(pcal["xs"].shape) == jcal["xs"].shape
    assert rel_err(pcal["xs"].numpy(), jcal["xs"]) < FP_TOL
    np.testing.assert_allclose(pcal["ts"].numpy(), np.asarray(jcal["ts"]),
                               rtol=1e-6)
    return jcal


def _ptq_pair(plan_path, jmodel, jv, jcal, plan_fn=None,
              table_rel=TABLE_REL, **build_kw):
    """JAX run_ptq on its calibration data, and the port's on the same
    data, on a port model with the same fp weights; the tables held to
    table_rel, the slot map equal. Returns (JAX result, port model)."""
    jplan = j_load(plan_path)
    jplan = plan_fn(jplan) if plan_fn else jplan
    with jax_kernel_path():
        jres = j_run_ptq(jmodel, {k: jv[k] for k in jv}, jcal, jplan,
                         jplan.resolver())
    port = build_port(plan_path, jv, fp_only=True, plan_fn=plan_fn,
                      **build_kw)
    pplan = load_quant_config(plan_path)
    pplan = plan_fn(pplan) if plan_fn else pplan
    cal = {k: (None if v is None else _t(v)) for k, v in jcal.items()}
    pres = run_ptq(port, cal, pplan)
    np.testing.assert_array_equal(pres.act_slot_map, jres.act_slot_map)
    np.testing.assert_array_equal(pres.calib_ts, jres.calib_ts)
    n = 0
    for name, mod in port.named_modules():
        if not (isinstance(mod, QuantLinear) and mod.static_act):
            continue
        jq = jres.variables["quant"]
        for seg in re.sub(r"\.(\d+)", r"_\1", name).split("."):
            jq = jq[seg]
        for k in ("a_delta", "a_zp", "w_delta", "w_zp"):
            _close(getattr(mod, k), jq[k], table_rel)
        n += 1
    assert n >= 8
    return jres, port


@pytest.fixture(scope="module")
def stdit_naive():
    jmodel, jv = build_jax(NAIVE)
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    port_fp = build_port(NAIVE, jv, fp_only=True)
    kw = dict(num_sampling_steps=2, cfg_scale=4.0)
    jcal = _calib(jmodel, jv, (JIDDPM(**kw), IDDPM(**kw), port_fp), x, y2,
                  mask)
    jres, port = _ptq_pair(NAIVE, jmodel, jv, jcal)
    return jmodel, jres, port, (x, y2, mask), kw


def test_stdit_naive_run_ptq_forward_and_denoise_match_jax(stdit_naive):
    jmodel, jres, port, (x, y2, mask), kw = stdit_naive
    jv = jres.variables
    slot = int(jres.act_slot_map[500])
    args = inputs()
    want, = jax_forwards(jmodel, jv, args, ((500, slot),))
    with torch.no_grad():
        got = port(*(_t(a) for a in args),
                   qctx=QuantCtx(t_id=500, act_slot=slot)).numpy()
        fp = port(*(_t(a) for a in args)).numpy()
    assert rel_err(got, want) < FWD_TOL
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)
    with jax_kernel_path():
        want = j_inf.quant_sample(jmodel, jv, JIDDPM(**kw), jnp.asarray(x),
                                  jnp.asarray(y2), jnp.asarray(mask),
                                  act_slot_map=jres.act_slot_map)
    got = p_inf.quant_sample(port, IDDPM(**kw), _t(x), _t(y2), _t(mask),
                             act_slot_map=jres.act_slot_map)
    assert rel_err(got.numpy(), want) < DENOISE_TOL


def test_stdit_naive_fused_runs_k2_on_static_codes(stdit_naive,
                                                   monkeypatch):
    # the naive arm's tables on the native backend under impl 'fused':
    # every quantized linear runs K2 on codes made outside any kernel
    _, jres, port, _, _ = stdit_naive
    fused = build_port(NAIVE, jres.variables, fp_only=True,
                       plan_fn=lambda p: p.with_backend("fused"))
    fused.load_state_dict(port.state_dict(), strict=False)
    for name, mod in fused.named_modules():
        if isinstance(mod, QuantLinear) and mod.path is not None:
            assert mod.path == "native_static", name
    pack_native_weights(fused)
    calls = {n: 0 for n in ("int8_consumer_matmul_plain",
                            "quantize_rows_plain",
                            "fused_dynq_int8_matmul_plain")}
    for n in calls:
        fn = getattr(FM, n)
        monkeypatch.setattr(FM, n, lambda *a, _n=n, _f=fn, **k: (
            calls.__setitem__(_n, calls[_n] + 1), _f(*a, **k))[1])
    ims = {"dynamic_quant_rows_plain": 0, "int8_matmul_plain": 0}
    for n in ims:
        fn = getattr(IM, n)
        monkeypatch.setattr(IM, n, lambda *a, _n=n, _f=fn, **k: (
            ims.__setitem__(_n, ims[_n] + 1), _f(*a, **k))[1])
    args = [_t(a) for a in inputs()]
    with torch.no_grad():
        got = fused(*args, qctx=QuantCtx(t_id=500)).numpy()
        want = port(*args, qctx=QuantCtx(t_id=500)).numpy()
    assert calls == {"int8_consumer_matmul_plain": 13 * len(fused.blocks),
                     "quantize_rows_plain": 0,
                     "fused_dynq_int8_matmul_plain": 0}, calls
    assert ims == {"dynamic_quant_rows_plain": 0, "int8_matmul_plain": 0}
    assert rel_err(got, want) < FWD_TOL
