"""The port's DiT (text and label conditions) and Latte against the JAX
package on equal weights (tests/torch_parity.py's tiny models: 2x16x16
and 2x32x32 latents, C = 64, 4 heads, 2 blocks), the JAX side on its kernel path
(Pallas interpret mode): the fp forward, the sm8 forward, Latte's W4A8
channel-balancing (CB) forward in bf16, Latte's CB model through the
gather MP sampler (a 2-step CFG DDIM with per-range bits by module
prefix), its quant checkpoint in both directions, and `ClassEncoder`.

Tolerances, each with its reason:
  * fp forward 1e-4 relative, in float32. Latte's temporal blocks attend
    over T = 2 frames: the JAX package runs its XLA f32 attention there
    (the kernel takes n % 128 == 0, `attention.py:839`), the port its K3
    at every N (ROADMAP C19), whose q.k rounds q and k to bf16 first; on
    these draws that moves Latte's output by 4.1e-5 (DiT's, all on
    kernels, by 1e-6);
  * quantized forward 1e-2 (the int8 limit, PERF.md §2): the int8 layers
    turn ulp differences of the two libraries into code flips; Latte's CB
    forward runs in bf16, where the bf16 activations of both packages
    round at 2^-8;
  * MP denoise 2e-2, the denoise limit of every int8 plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (CB, CB_STAT_T, KINDS, N_CLASSES, SM8,
                          build_jax, build_port, cb_plan, inputs,
                          jax_kernel_path, quant_ckpt_crosses, rel_err)
from viditq_tpu.models.dit import Latte as JLatte
from viditq_tpu.models.text_encoder import ClassEncoder as JClassEncoder
from viditq_tpu.pipelines import mixed_precision as jmp
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.models.dit import Latte
from viditq_tpu_torch.models.text_encoder import ClassEncoder
from viditq_tpu_torch.pipelines import mixed_precision as mp
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.samplers.iddpm import IDDPM
from viditq_tpu_torch.utils.config import load_quant_config

FP_TOL = 1e-4
QUANT_TOL = 1e-2
DENOISE_TOL = 2e-2
# Latte's MP ranges on a 2-step schedule (the JAX bench's Latte arm,
# bench_configs.py:529-535, one range a step): each block's attention at 8
# then 4 bits, its MLP at 8, by module prefix (`_bits_for`'s glob)
LATTE_MP = {"1-1": {"model.blocks.0.attn": 8, "model.blocks.1.attn": 8,
                    "model.blocks.0.mlp": 8, "model.blocks.1.mlp": 8},
            "0-0": {"model.blocks.0.attn": 4, "model.blocks.1.attn": 4,
                    "model.blocks.0.mlp": 8, "model.blocks.1.mlp": 8}}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _forward_pair(jmodel, jv, port, kind, quant, t_id=500):
    x, t, y, mask = inputs(kind=kind)
    with jax_kernel_path():
        want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
            v, *a, qctx=JQuantCtx(mode="quant" if quant else "fp",
                                  t_id=t_id)))(jv, x, t, y, mask))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(y), _t(mask), qctx=QuantCtx(
            mode="quant" if quant else "fp", t_id=t_id)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    return rel_err(got, want)


@pytest.fixture(scope="module")
def sm8_models():
    cache = {}

    def get(kind):
        if kind not in cache:
            jmodel, jv = build_jax(SM8, kind=kind)
            cache[kind] = (jmodel, jv, build_port(SM8, jv, kind=kind))
        return cache[kind]
    return get


@pytest.mark.parametrize("kind", ["dit", "dit_label", "latte"])
def test_fp_and_sm8_forward_match_jax(sm8_models, kind):
    jmodel, jv, port = sm8_models(kind)
    assert _forward_pair(jmodel, jv, port, kind, quant=False) < FP_TOL
    if kind != "dit_label":  # the condition only moves the embedding
        assert _forward_pair(jmodel, jv, port, kind, quant=True) < QUANT_TOL


def test_latte_layout_and_plan_names(sm8_models):
    """Latte's blocks alternate the spatial and temporal token views; every
    block has its own adaLN head (fp), and the plan's names resolve per
    block as in JAX."""
    _, _, port = sm8_models("latte")
    T, S = port.num_temporal, port.num_spatial
    assert (T, S) == (2, 256)
    for i, block in enumerate(port.blocks):
        for lin in (block.attn.q, block.mlp.fc2):
            assert lin.token_layout == ("spatial", "temporal")[i % 2]
            assert (lin.d_t, lin.d_s) == (T, S)
        assert block.adaLN_linear.lspec is None
        assert block.attn.q.lspec == load_quant_config(SM8).resolver()(
            f"blocks.{i}.attn.q")


@pytest.fixture(scope="module")
def latte_cb():
    """(JAX Latte, variables after sq_stat, calibrate and pack) under the
    CB recipe on the fused kernels (`qkv_share_cs`), float32."""
    return build_jax(CB, kind="latte", plan_fn=cb_plan(True),
                     sq_stat_t=CB_STAT_T)


def test_latte_cb_forward_bf16_matches_jax(latte_cb):
    _, jv32 = latte_cb
    jmodel, jv = build_jax(CB, kind="latte", plan_fn=cb_plan(True),
                           act_scales=jv32["quant"], dtype=jnp.bfloat16)
    port = build_port(CB, jv, kind="latte", plan_fn=cb_plan(True),
                      dtype=torch.bfloat16)
    cb = [m for m in port.modules()
          if isinstance(m, QuantLinear) and m.smooth is not None]
    assert cb and all(float(m.act_scale.abs().max()) > 0 for m in cb)
    # t = 700: CB's second timerange
    assert _forward_pair(jmodel, jv, port, "latte", quant=True,
                         t_id=700) < QUANT_TOL


def _jctor(r):
    return JLatte(resolver=r, dtype=jnp.float32, **KINDS["latte"][2])


def _ctor(r):
    return Latte(resolver=r, dtype=torch.float32,
                 **KINDS["latte"][2]).eval()


def test_latte_cb_gather_mp_denoise_matches_jax(latte_cb):
    _, jv = latte_cb
    jplan = cb_plan(True)(j_load(CB))
    plan = cb_plan(True)(load_quant_config(CB))
    x, _, y, mask = inputs(batch=1, seed=3, kind="latte")
    y2 = np.concatenate([y, inputs(batch=1, seed=4, kind="latte")[2]])
    jrun = jmp.build_mp_sampler_gather(_jctor, JIDDPM(num_sampling_steps=2),
                                       jplan, LATTE_MP, None,
                                       static_segments=False)
    jargs = (jnp.asarray(x), jnp.asarray(y2), jnp.asarray(mask))
    with jax_kernel_path():
        want = np.asarray(jrun(jrun.prepare(jv, *jargs), *jargs))
    run = mp.build_mp_sampler(_ctor, IDDPM(num_sampling_steps=2), plan,
                              LATTE_MP, None)
    assert isinstance(run, mp.GatherMPSampler)
    base = build_port(CB, jv, kind="latte", plan_fn=cb_plan(True))
    union = run.prepare(base)
    # the module prefixes cover their leaf linears: attention W8 then W4,
    # the MLP W8, in every union span of each range
    bits = {n: m.lspec.weight.mp_bits for n, m in union.named_modules()
            if isinstance(m, QuantLinear) and m.native}
    assert bits["blocks.1.attn.proj"] == tuple(
        4 if mi == 0 else 8 for mi in run.mp_idx)
    assert bits["blocks.0.mlp.fc1"] == (8,) * run.n_ranges
    got = run(base, _t(x), _t(y2), _t(mask)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < DENOISE_TOL
    assert rel_err(got, x) > 0.01


def test_latte_cb_quant_ckpt_crosses(latte_cb, tmp_path):
    """Latte's CB checkpoint between the packages: the JAX file's
    `cbshare__*` copies (the shared q/k/v quantize, the emission into
    proj, the GELU handoff to fc2) checked and dropped on load, written
    back by the port's."""
    _, jv = latte_cb
    port = build_port(CB, {"params": jv["params"]}, fp_only=True,
                      kind="latte", plan_fn=cb_plan(True))
    keys = quant_ckpt_crosses(jv, port, str(tmp_path / "j.npz"),
                              str(tmp_path / "p.npz"))
    assert {k.split("::")[1] for k in keys if "cbshare" in k} == {
        "cbshare__q", "cbshare__proj", "cbshare__fc2"}


def test_class_encoder_matches_jax():
    labels = [3, 0, N_CLASSES - 1]
    enc, jenc = ClassEncoder(N_CLASSES), JClassEncoder(N_CLASSES)
    got, want = enc.encode(labels), jenc.encode(labels)
    assert got["mask"] is None and want["mask"] is None
    np.testing.assert_array_equal(got["y"].numpy(), np.asarray(want["y"]))
    np.testing.assert_array_equal(enc.null(2).numpy(),
                                  np.asarray(jenc.null(2)))
    assert enc.null(1).item() == N_CLASSES
