"""The port's PixArt-Σ slice against the JAX package on equal weights: the
weight bridge (unrolled, single-scan and multi-run scanned layouts), the
fp forward, the sm8 forward and a 2-step DPM-Solver++ CFG denoise. The
tiny Σ (tests/torch_parity.py) streams block 0's self-attention through
K6 (2304 tokens, 9 kv blocks of 256) and compresses block 1's k/v with the
2x2 `sr` conv; the JAX side runs its kernel path (Pallas interpret mode).

Tolerances as in tests/test_torch_stdit.py, for the same reasons: fp
1e-4 relative; sm8 1e-2 for the forward and 2e-2 for the denoise (the
int8 layers turn ulp differences of the two libraries into code flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SM8, build_jax, build_port, inputs, jax_kernel_path,
                          rel_err)
from viditq_tpu.pipelines.inference import fp_sample as j_fp_sample
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import DPMSolverSampler as JDPMSolverSampler
from viditq_tpu_torch.models.layers import DepthwiseQuantConv
from viditq_tpu_torch.pipelines.inference import fp_sample, quant_sample
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
from viditq_tpu_torch.utils.bridge import state_dict_from_flax

FP_TOL = 1e-4
SM8_TOL = 1e-2
SM8_DENOISE_TOL = 2e-2


@pytest.fixture(scope="module")
def models():
    jmodel, jv = build_jax(SM8, kind="sigma")
    return jmodel, jv, build_port(SM8, jv, kind="sigma")


@pytest.fixture(scope="module")
def jax_forward(models):
    jmodel, jv, _ = models
    fns = {quant: jax.jit(lambda x, t, y, m, _q=quant: jmodel.apply(
        jv, x, t, y, m, qctx=JQuantCtx(mode="quant") if _q else None))
        for quant in (False, True)}

    def run(quant, x, t, y, mask):
        with jax_kernel_path():
            return np.asarray(fns[quant](x, t, y, mask))
    return run


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _port_forward(port, quant, x, t, y, mask):
    with torch.no_grad():
        return port(_t(x), _t(t), _t(y), _t(mask),
                    qctx=QuantCtx(mode="quant") if quant else None).numpy()


def _stack_runs(tree, runs):
    """The JAX multi-run scanned layout from an unrolled tree: blocks
    s..s+n-1 stacked on a leading axis under `blocks_{s}` (or `blocks`
    for one run)."""
    out = {k: v for k, v in tree.items() if not k.startswith("blocks_")}
    for start, n in runs:
        name = "blocks" if len(runs) == 1 else f"blocks_{start}"
        out[name] = jax.tree.map(
            lambda *a: np.stack(a),
            *[tree[f"blocks_{i}"] for i in range(start, start + n)])
    return out


@pytest.mark.parametrize("compress,runs", [
    ((), [(0, 2)]), ((2, 3), [(0, 2), (2, 2)])],
    ids=["single-scan", "multi-run"])
def test_bridge_sigma_layouts(compress, runs):
    depth = sum(n for _, n in runs)
    kw = dict(kind="sigma", input_size=32, depth=depth,
              kv_compress_layers=compress)
    _, jv = build_jax(SM8, **kw)
    _, jv_sc = build_jax(SM8, scan_blocks=True, **kw)
    stacked = {c: _stack_runs(jv[c], runs) for c in ("params", "quant")}
    # the stacking reproduces the JAX package's own scanned layout
    assert (jax.tree.map(np.shape, stacked)
            == jax.tree.map(np.shape, {c: jv_sc[c] for c in stacked}))
    sd_un = state_dict_from_flax(jv["params"], jv["quant"])
    sd_sc = state_dict_from_flax(stacked["params"], stacked["quant"])
    port = build_port(SM8, jv, **kw)  # loads with strict=True
    sd_sc_port = build_port(SM8, stacked, **kw).state_dict()
    assert sd_un.keys() == sd_sc.keys() == port.state_dict().keys()
    for k in sd_un:
        assert torch.equal(sd_un[k], sd_sc[k]), k
        assert torch.equal(sd_un[k], sd_sc_port[k]), k
    if compress:
        # the depthwise sr kernel keeps its [r, r, 1, C] conv layout
        assert tuple(sd_un["blocks.2.attn.sr.kernel"].shape) == (2, 2, 1, 64)
        assert "blocks.3.attn.norm.scale" in sd_un
    # the 2D patchify kernel [p, p, C_in, D] as patch rows
    np.testing.assert_array_equal(
        sd_un["x_embedder.proj.kernel"].numpy(),
        jv["params"]["x_embedder"]["proj"]["kernel"].reshape(16, 64))


def test_bridge_unrolled_tiny_sigma(models):
    _, jv, port = models
    sd = state_dict_from_flax(jv["params"], jv["quant"])
    assert sd.keys() == port.state_dict().keys()
    assert tuple(sd["blocks.1.attn.sr.kernel"].shape) == (2, 2, 1, 64)


def test_port_calibrate_and_pack_walk_sigma(models):
    # the port's own tables equal the JAX package's, and the sr conv
    # (simulate semantics, no tables) is skipped
    _, jv, _ = models
    port = build_port(SM8, jv, fp_only=True, kind="sigma")
    pack_native_weights(calibrate_weight_tables(port))
    sd = state_dict_from_flax(jv["params"], jv["quant"])
    got = port.state_dict()
    for k in sd:
        if k.endswith(("w_int", "w_colsum")):
            assert torch.equal(got[k], sd[k]), k
        elif k.endswith(("w_delta", "w_zp")):
            torch.testing.assert_close(got[k], sd[k], rtol=2.5e-7, atol=0)
    sr = port.blocks[1].attn.sr
    assert isinstance(sr, DepthwiseQuantConv)
    assert not any(n.startswith("blocks.1.attn.sr.w_") for n in got)


def test_fp_forward_matches_jax(models, jax_forward):
    args = inputs(kind="sigma")
    want = jax_forward(False, *args)
    got = _port_forward(models[2], False, *args)
    assert got.shape == want.shape == (2, 8, 96, 96)
    assert rel_err(got, want) < FP_TOL


def test_sm8_forward_matches_jax_kernel_path(models, jax_forward):
    args = inputs(kind="sigma")
    want = jax_forward(True, *args)
    got = _port_forward(models[2], True, *args)
    assert np.isfinite(got).all()
    assert rel_err(got, want) < SM8_TOL
    # nearer the JAX sm8 output than the port's own fp output is
    fp = _port_forward(models[2], False, *args)
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


# cfg_split both ways in fp, and sm8 with the batch-2 CFG forward that the
# chip slice runs: each JAX sm8 forward of this model takes ~12 s in
# interpret mode on the CPU, so sm8 with cfg_split (4 forwards) is left out
@pytest.mark.parametrize("quant,cfg_split", [(False, False), (False, True),
                                             (True, False)],
                         ids=["fp", "fp-cfg_split", "sm8"])
def test_dpm_cfg_denoise_matches_jax(models, quant, cfg_split):
    jmodel, jv, port = models
    x, _, y, mask = inputs(batch=1, seed=3, kind="sigma")
    y2 = np.concatenate([y, inputs(batch=1, seed=4, kind="sigma")[2]])
    kw = dict(num_sampling_steps=2, cfg_scale=4.5, cfg_split=cfg_split)
    with jax_kernel_path():
        run = j_quant_sample if quant else j_fp_sample
        want = run(jmodel, jv, JDPMSolverSampler(**kw), jnp.asarray(x),
                   jnp.asarray(y2), jnp.asarray(mask))
    run = quant_sample if quant else fp_sample
    got = run(port, DPMSolverSampler(**kw), _t(x), _t(y2), _t(mask))
    assert got.shape == (1, 4, 96, 96)
    assert rel_err(got.numpy(), want) < (SM8_DENOISE_TOL if quant
                                         else FP_TOL)
    assert rel_err(got.numpy(), x) > 0.01
