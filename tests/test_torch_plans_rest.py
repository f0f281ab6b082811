"""The shipped plans no earlier test ran, against the JAX package on the
tiny configs (equal weights, numpy inputs):

  * the PTQD pair (`opensora/w6a6_ptqd.yaml`, `w8a8_ptqd.yaml`): static
    per-tensor asym acts with `mixed_precision: [4, 6, 8]` and no
    bitwidth file (JAX keeps the MP key on static plans,
    `viditq_tpu/utils/config.py:49-64`), then the flow they exist for:
    the fp and quantized model outputs along one DDIM run, [n_steps, ...]
    under `outs`, handed to `calibrate-ptqd-k` through `cli.main`;
  * STDiT `w4a8_tpu_fused.yaml`: the fused kernels' plain versions on
    4-bit sym codes in the int8 range (K1, K2 with fc1's GELU emission,
    K3's int8 PV at temporal and cross, K5), `cfg_split`;
  * PixArt-alpha `pixart/w4a8.yaml` (W6 as written, dynamic asym token A8,
    smooth quant alpha 0.3, the embedders quantized too: C16) and
    `pixart/w8a8_naive.yaml` (static tensor acts); PixArt-Sigma
    `pixart_sigma/w8a8.yaml` (dynamic + smooth quant) and
    `w4a8_naive.yaml` (static tensor acts under `running_stat`, 4-bit
    weights), on the tiny Sigma at a 32x32 latent.

Each: `run_ptq` on the calibration data of a 2-step fp trajectory (one a
kind, shared) against JAX's `run_ptq` on the same data, every table the
plan makes held as the earlier plan tests hold them (1e-6; the PixArt
plans that quantize the patch embed 1e-3, C16; smooth quant's
statistics and balancing scales 1e-5); one forward within 1e-2; a 2-step
CFG denoise within 2e-2 (DDIM for STDiT, DPM-Solver++ for PixArt).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simulate import DENOISE_TOL, FWD_TOL, _t, jax_forwards
from test_torch_static import TABLE_REL, _calib
from torch_parity import (build_jax, build_port, inputs, jax_kernel_path,
                          rel_err)
from viditq_tpu.pipelines import analysis as j_analysis
from viditq_tpu.pipelines import inference as j_inf
from viditq_tpu.pipelines.ptq import run_ptq as j_run_ptq
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant.native_pack import pack_native_weights as j_pack
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.samplers import DPMSolverSampler as JDPMSolverSampler
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines import analysis
from viditq_tpu_torch.pipelines import inference as p_inf
from viditq_tpu_torch.pipelines.ptq import run_ptq
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.config import load_quant_config

__all__ = ["plan_pair", "trajectories", "forward_case", "denoise_case",
           "ptqd_case"]

PIXART = dict(kind="sigma", input_size=32)
# the tiny STDiT at one block (every layer kind of the model is in a block:
# spatial, temporal and cross attention, the MLP)
STDIT = dict(depth=1)
# C16: a quantized patch embed moves later codes at their rounding ties
# (tests/test_torch_plans.py PIXART_TABLE_REL)
PIXART_TABLE_REL = 1e-3
# the balancing statistics and scales (tests/test_torch_cb.py; C16's 1e-3
# where the patch embed is quantized: the statistic of a layer after it
# moves with the codes, 4.1e-5 at PixArt-alpha W4A8's block 0 proj)
CB_TABLE_REL = 1e-5
# the PTQD correction factors 1 + k_t of the port's trajectories against
# JAX's, relative: k_t is a ratio of projections on the fp output over the
# whole output, which averages the two runs' int8 rounding differences
# (readings on the tiny STDiT: 7.3e-7 for w6a6, 2.4e-7 for w8a8 at one
# block; 1.1e-5 and 2.6e-6 at two)
PTQD_K_REL = 1e-4

# plan, model kind and build arguments, sampler, tables tolerance
PLANS = {
    "w6a6_ptqd": ("configs/opensora/w6a6_ptqd.yaml", STDIT, TABLE_REL),
    "w8a8_ptqd": ("configs/opensora/w8a8_ptqd.yaml", STDIT, TABLE_REL),
    "w4a8_tpu_fused": ("configs/opensora/w4a8_tpu_fused.yaml", STDIT,
                       TABLE_REL),
    "pixart_w4a8": ("configs/pixart/w4a8.yaml", PIXART, PIXART_TABLE_REL),
    "pixart_w8a8_naive": ("configs/pixart/w8a8_naive.yaml", PIXART,
                          PIXART_TABLE_REL),
    "sigma_w8a8": ("configs/pixart_sigma/w8a8.yaml", PIXART,
                   PIXART_TABLE_REL),
    "sigma_w4a8_naive": ("configs/pixart_sigma/w4a8_naive.yaml", PIXART,
                         PIXART_TABLE_REL),
}
TABLES = ("a_delta", "a_zp", "w_delta", "w_zp", "act_scale", "cb_scale")


def _samplers(kind):
    if kind == "sigma":
        kw = dict(num_sampling_steps=2, cfg_scale=4.5)
        return JDPMSolverSampler(**kw), DPMSolverSampler(**kw)
    kw = dict(num_sampling_steps=2, cfg_scale=4.0)
    return JIDDPM(**kw), IDDPM(**kw)


def _sample_inputs(kind):
    x, _, y, mask = inputs(batch=1, seed=3, kind=kind)
    if kind == "sigma":
        x = x[..., :32, :32]
    y2 = np.concatenate([y, inputs(batch=1, seed=4, kind=kind)[2]])
    return x, y2, mask


def _forward_args(kind):
    args = list(inputs(kind=kind))
    if kind == "sigma":
        args[0] = args[0][..., :32, :32]
    return args


@pytest.fixture(scope="module")
def trajectories():
    """The fp trajectory of each tiny model (the same fp weights under every
    plan), captured in both packages and held to the fp limit: one a kind,
    computed on first use."""
    cache = {}

    def get(kind, plan):
        if kind not in cache:
            build = PIXART if kind == "sigma" else STDIT
            jmodel, jv = build_jax(plan, **build)
            port_fp = build_port(plan, jv, fp_only=True, **build)
            js, ps = _samplers(kind)
            x, y2, mask = _sample_inputs(kind)
            cache[kind] = _calib(jmodel, jv, (js, ps, port_fp), x, y2, mask)
        return cache[kind]
    return get


def _quant_tree(jres, name):
    jq = jres.variables["quant"]
    for seg in re.sub(r"\.(\d+)", r"_\1", name).split("."):
        jq = jq[seg]
    return jq


@pytest.fixture(scope="module")
def plan_pair(trajectories):
    """(JAX result, port model, kind, native) of a plan after both
    packages' run_ptq on the same calibration data (packed where the plan
    is native), the tables held to the plan's tolerance."""
    cache = {}

    def get(key):
        if key in cache:
            return cache[key]
        path, build, table_rel = PLANS[key]
        kind = build.get("kind", "stdit")
        jcal = trajectories(kind, path)
        jmodel, jv = build_jax(path, **build)
        jplan = j_load(path)
        with jax_kernel_path():
            jres = j_run_ptq(jmodel, {k: jv[k] for k in jv}, jcal, jplan,
                             jplan.resolver())
        pplan = load_quant_config(path)
        port = build_port(path, jv, fp_only=True, **build)
        cal = {k: (None if v is None else _t(v)) for k, v in jcal.items()}
        pres = run_ptq(port, cal, pplan)
        if pres.act_slot_map is None or jres.act_slot_map is None:
            assert pres.act_slot_map is None and jres.act_slot_map is None
        else:
            np.testing.assert_array_equal(pres.act_slot_map,
                                          jres.act_slot_map)
        n = 0
        for name, mod in port.named_modules():
            if not (isinstance(mod, QuantLinear) and mod.lspec is not None
                    and (mod.lspec.weight_quant or mod.lspec.act_quant)):
                continue
            jq = _quant_tree(jres, name)
            for k in TABLES:
                if k not in jq or getattr(mod, k, None) is None:
                    continue
                want = np.asarray(jq[k], np.float64)
                got = getattr(mod, k).detach().double().numpy()
                rel = (max(CB_TABLE_REL, table_rel)
                       if k in ("act_scale", "cb_scale") else table_rel)
                assert got.shape == want.shape, (name, k)
                np.testing.assert_allclose(got, want, rtol=rel,
                                           atol=rel * np.abs(want).max(),
                                           err_msg=f"{key} {name}.{k}")
                n += 1
        assert n >= 8, key  # every quantized layer of the model
        native = pplan.uses_native()
        if native:
            jres.variables["quant"] = j_pack(
                jres.variables["params"], jres.variables["quant"],
                jplan.resolver())
            pack_native_weights(port)
        cache[key] = (jmodel, jres, port, kind)
        return cache[key]
    return get


def forward_case(key, plan_pair):
    """One quantized forward at t = 500 (its act slot) within FWD_TOL of
    JAX's, and nearer JAX's than the fp forward is."""
    jmodel, jres, port, kind = plan_pair(key)
    args = _forward_args(kind)
    t = 500
    slot = (0 if jres.act_slot_map is None
            else int(jres.act_slot_map[t]))
    want, = jax_forwards(jmodel, jres.variables, args, ((t, slot),))
    with torch.no_grad():
        got = port(*(_t(a) for a in args),
                   qctx=QuantCtx(t_id=t, act_slot=slot)).numpy()
        fp = port(*(_t(a) for a in args)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    # the port reproduces the quantization, not just the fp model
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


def denoise_case(key, plan_pair):
    """A 2-step CFG denoise (with the act slot map) within DENOISE_TOL."""
    jmodel, jres, port, kind = plan_pair(key)
    x, y2, mask = _sample_inputs(kind)
    js, ps = _samplers(kind)
    slots = jres.act_slot_map
    with jax_kernel_path():
        want = j_inf.quant_sample(jmodel, jres.variables, js, jnp.asarray(x),
                                  jnp.asarray(y2), jnp.asarray(mask),
                                  act_slot_map=slots)
    got = p_inf.quant_sample(port, ps, _t(x), _t(y2), _t(mask),
                             act_slot_map=slots)
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01


# PixArt-alpha and PixArt-Sigma's plans here; the PTQD pair in
# tests/test_torch_plans_ptqd.py, STDiT's W4A8 on the fused kernels in
# tests/test_torch_plans_w4a8_fused.py (one file a worker)
PIXART_KEYS = ["pixart_w4a8", "pixart_w8a8_naive", "sigma_w8a8",
               "sigma_w4a8_naive"]


@pytest.mark.parametrize("key", PIXART_KEYS)
def test_plan_forward_matches_jax(key, plan_pair):
    forward_case(key, plan_pair)


@pytest.mark.parametrize("key", PIXART_KEYS)
def test_plan_denoise_matches_jax(key, plan_pair):
    denoise_case(key, plan_pair)


def _jax_outs(jmodel, jv, cal, slots):
    """JAX's fp and quantized model outputs at each step of the fp
    trajectory cal (one compiled program)."""
    fn = jax.jit(lambda v, q, *a: jmodel.apply(v, *a, qctx=q))
    fp, qt = [], []
    with jax_kernel_path():
        for x, t in zip(cal["xs"], cal["ts"]):
            a = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(cal["y"]),
                 jnp.asarray(cal["mask"]))
            t_id = int(t[0])
            fp.append(np.asarray(fn(jv, JQuantCtx(
                mode="fp", t_id=jnp.int32(t_id), act_slot=jnp.int32(0)), *a)))
            qt.append(np.asarray(fn(jv, JQuantCtx(
                mode="quant", t_id=jnp.int32(t_id),
                act_slot=jnp.int32(int(slots[t_id]))), *a)))
    return np.stack(fp), np.stack(qt)


def _port_outs(port, cal, slots):
    """The port's fp and quantized model outputs along its own fp
    trajectory (`get_calib_data`'s xs and ts), recorded by a forward
    hook as the card's run records them."""
    outs = []
    hook = port.register_forward_hook(
        lambda mod, args, out: outs.append(out.detach().float().numpy()))
    try:
        with torch.no_grad():
            for x, t in zip(cal["xs"], cal["ts"]):
                t_id = int(t[0])
                port(x, t.float(), cal["y"], cal["mask"])
                port(x, t.float(), cal["y"], cal["mask"],
                     qctx=QuantCtx(t_id=t_id, act_slot=int(slots[t_id])))
    finally:
        hook.remove()
    return np.stack(outs[0::2]), np.stack(outs[1::2])


def ptqd_case(key, plan_pair, trajectories, tmp_path):
    """calibrate-ptqd-k through the port's `cli.main` on the port's own
    fp/quantized outputs along the fp DDIM run, against JAX's
    `calibrate_ptqd_k` on JAX's: one k_t a step, finite, each correction
    factor 1 + k_t within PTQD_K_REL of JAX's; the file equals the port's
    function on the same arrays. Returns the largest relative distance."""
    jmodel, jres, port, kind = plan_pair(key)
    path = PLANS[key][0]
    jcal = trajectories(kind, path)
    slots = jres.act_slot_map
    jfp, jq = _jax_outs(jmodel, jres.variables, jcal, slots)
    want = np.asarray(j_analysis.calibrate_ptqd_k(jnp.asarray(jfp),
                                                  jnp.asarray(jq)))
    build = PLANS[key][1]
    port_fp = build_port(path, jres.variables, fp_only=True, **build)
    js, ps = _samplers(kind)
    x, y2, mask = _sample_inputs(kind)
    pcal = p_inf.get_calib_data(port_fp, ps, _t(x), _t(y2), _t(mask))
    pfp, pq = _port_outs(port, pcal, slots)
    assert pfp.shape == pq.shape == (len(pcal["xs"]), *jfp.shape[1:])
    np.savez(tmp_path / "fp.npz", outs=pfp)
    np.savez(tmp_path / "q.npz", outs=pq)
    out = cli.main(["calibrate-ptqd-k", "--fp_trajectory",
                    str(tmp_path / "fp.npz"), "--quant_trajectory",
                    str(tmp_path / "q.npz"), "--save_dir",
                    str(tmp_path / "k")])
    got = np.load(out["out"])
    assert got.shape == want.shape == (len(pcal["xs"]),)
    assert np.isfinite(got).all()
    assert np.array_equal(got, analysis.calibrate_ptqd_k(pfp, pq))
    assert np.abs(got).max() > 0  # the quantized outputs moved
    rel = np.abs((1 + got) - (1 + want)) / np.abs(1 + want)
    assert rel.max() < PTQD_K_REL, (got, want)
    return float(rel.max())
