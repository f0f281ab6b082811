"""Reference plans as written, against the JAX package: every listed
plan resolves to the same layer specs and plan keys (the hybrid plans'
per-group backend overrides included); the hybrid plan
(`w8a8_tpu_hybrid.yaml`: the MLPs native K7a -> K7b, the attention
linears weight-only int8) on the tiny STDiT, one forward within 1e-2 and
a 2-step CFG DDIM within 2e-2 (the limits of the int8 model tests); and
the PixArt static plans through `run_ptq` on the tiny Σ at a 32x32
latent: `pixart/w8a8_sq_static.yaml` with timestep-wise tables (a slot a
calibration step) and `pixart/w8a8_q_diffusion.yaml` with the q-diffusion
split on every block's fc2 and cross proj, the slot map equal to JAX's,
the tables as `PIXART_TABLE_REL` says (and within 1e-6 with the patch
embed fp-listed), the forward at two timesteps within 1e-2.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_simulate import (DENOISE_TOL, FWD_TOL, HYBRID, _t,
                                 jax_forwards)
from test_torch_static import (Q_DIFFUSION, SQ_STATIC, TABLE_REL, _calib,
                               _ptq_pair)
from torch_parity import (build_jax, build_port, inputs, jax_kernel_path,
                          rel_err)
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.samplers import DPMSolverSampler as JDPMSolverSampler
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.config import load_quant_config


def test_plans_resolve_as_jax_including_hybrid_overrides():
    from test_torch_quant import LAYERS
    for plan in ("configs/opensora/viditq_w8a8.yaml",
                 "configs/opensora/viditq_w6a6.yaml",
                 "configs/opensora/viditq_w4a8.yaml",
                 "configs/opensora/w4a8_smooth_quant.yaml",
                 "configs/opensora/w6a6_smooth_quant.yaml",
                 "configs/opensora/w8a8_smooth_quant.yaml",
                 "configs/opensora/w4a8_naive_cb.yaml",
                 "configs/opensora/w6a6_naive_cb.yaml",
                 "configs/opensora/w8a8_naive.yaml",
                 "configs/opensora/w8a8_tpu_hybrid.yaml",
                 "configs/opensora/w8a8_tpu_hybrid_sym.yaml",
                 "configs/pixart_sigma/w8a8_naive.yaml",
                 "configs/pixart/w8a8_sq_static.yaml",
                 "configs/pixart/w8a8_q_diffusion.yaml"):
        for tw in (False, True):
            jp, pp = j_load(plan, timestep_wise=tw), load_quant_config(
                plan, timestep_wise=tw)
            for key in ("backend_overrides", "cfg_split", "mixed_precision",
                        "timestep_wise", "calib_n_steps", "calib_batch_size"):
                assert getattr(pp, key) == getattr(jp, key), (plan, key)
            assert pp.uses_native() == jp.uses_native(), plan
            jres, pres = jp.resolver(), pp.resolver()
            for name in LAYERS:
                assert (dataclasses.asdict(pres(name))
                        == dataclasses.asdict(jres(name))), (plan, name)
    hy = load_quant_config(HYBRID).resolver()
    assert QuantLinear(64, 64, hy("blocks.0.mlp.fc1")).path == "native"
    for site in ("attn.q", "attn_temp.proj", "cross_attn.kv_linear"):
        assert QuantLinear(64, 64, hy(f"blocks.3.{site}")).path == \
            "weight_only"


def test_hybrid_forward_and_denoise_match_jax():
    jmodel, jv = build_jax(HYBRID)
    port = build_port(HYBRID, jv)
    paths = {n: m.path for n, m in port.named_modules()
             if isinstance(m, QuantLinear) and m.path is not None}
    assert {p for n, p in paths.items() if ".mlp." in n} == {"native"}
    assert {p for n, p in paths.items() if ".mlp." not in n} == {
        "weight_only"}
    args = inputs()
    want, = jax_forwards(jmodel, jv, args)
    with torch.no_grad():
        got = port(*(_t(a) for a in args), qctx=QuantCtx()).numpy()
        fp = port(*(_t(a) for a in args)).numpy()
    assert rel_err(got, want) < FWD_TOL
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    kw = dict(num_sampling_steps=2, cfg_scale=4.0)
    with jax_kernel_path():
        want = j_quant_sample(jmodel, jv, JIDDPM(**kw), jnp.asarray(x),
                              jnp.asarray(y2), jnp.asarray(mask))
    got = quant_sample(port, IDDPM(**kw), _t(x), _t(y2), _t(mask))
    assert rel_err(got.numpy(), want) < DENOISE_TOL


class _SplitPlan:
    """A plan whose resolver splits every block's fc2 and cross proj (the
    q-diffusion plan's channel split; its reference applies it through
    CLI flags)."""

    def __init__(self, plan):
        self.plan = plan

    def resolver(self):
        d = self.plan.default_layer
        split = {p: dataclasses.replace(d, split=s)
                 for p, s in (("mlp.fc2", 96), ("cross_attn.proj", 24))}
        return self.plan.resolver(overrides=split)

    def __getattr__(self, name):
        return getattr(self.plan, name)


def _timestep_wise(plan):
    d = plan.default_layer
    return dataclasses.replace(plan, timestep_wise=True,
                               default_layer=dataclasses.replace(
                                   d, act=dataclasses.replace(
                                       d.act, timestep_wise=True,
                                       n_timestep=2)))


def _embed_fp(plan):
    """The timestep-wise plan with the patch embed fp-listed."""
    plan = _timestep_wise(plan)
    return dataclasses.replace(
        plan, fp_patterns=plan.fp_patterns + ("x_embedder",))


PIXART = dict(kind="sigma", input_size=32)
# PixArt quantizes its patch embed too: its output differs from JAX's by
# an ulp (the jitted XLA rounds its fake quant and product differently,
# C8), an ulp moves a later fake-quant code at its rounding tie, and a
# moved code moves the next layer's range by up to one step (range / 255):
# max 3.4e-4 relative at the final linear, 2.3e-4 at block 1's q/k/v.
# With the patch embed in fp (`_embed_fp`) every table is held to 1e-6.
PIXART_TABLE_REL = 1e-3


@pytest.fixture(scope="module")
def pixart_calib():
    """The fp DPM-Solver++ trajectory of the tiny Σ (the same fp weights
    under both plans), captured in both packages."""
    jmodel, jv = build_jax(SQ_STATIC, **PIXART)
    x, _, y, mask = inputs(batch=1, seed=3, kind="sigma")
    x = x[..., :32, :32]
    y2 = np.concatenate([y, inputs(batch=1, seed=4, kind="sigma")[2]])
    skw = dict(num_sampling_steps=2, cfg_scale=4.5)
    port_fp = build_port(SQ_STATIC, jv, fp_only=True, **PIXART)
    return _calib(jmodel, jv, (JDPMSolverSampler(**skw),
                               DPMSolverSampler(**skw), port_fp),
                  x, y2, mask)


@pytest.mark.parametrize(
    "plan,plan_fn,table_rel",
    [(SQ_STATIC, _timestep_wise, PIXART_TABLE_REL),
     (SQ_STATIC, _embed_fp, TABLE_REL),
     (Q_DIFFUSION, _SplitPlan, PIXART_TABLE_REL)],
    ids=["sq_static-timestep_wise", "sq_static-timestep_wise-fp_embed",
         "q_diffusion-split"])
def test_pixart_run_ptq_and_forward_match_jax(plan, plan_fn, table_rel,
                                              pixart_calib):
    jmodel, jv = build_jax(plan, plan_fn=plan_fn, **PIXART)
    jres, port = _ptq_pair(plan, jmodel, jv, pixart_calib, plan_fn=plan_fn,
                           table_rel=table_rel, **PIXART)
    if plan == Q_DIFFUSION:
        assert port.blocks[0].mlp.fc2.lspec.split == 96
    else:
        assert port.blocks[0].attn.q.a_delta.shape[1] == 2  # two slots
    if plan_fn is _embed_fp:
        spec = port.x_embedder.proj.lspec
        assert not (spec.weight_quant or spec.act_quant)
    args = list(inputs(kind="sigma"))
    args[0] = args[0][..., :32, :32]
    ctxs = [(t, int(jres.act_slot_map[t])) for t in (100, 900)]
    wants = jax_forwards(jmodel, jres.variables, args, ctxs)
    for (t, slot), want in zip(ctxs, wants):
        with torch.no_grad():
            got = port(*(_t(a) for a in args),
                       qctx=QuantCtx(t_id=t, act_slot=slot)).numpy()
        assert rel_err(got, want) < FWD_TOL
