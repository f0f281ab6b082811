"""AdaRound reconstruction on PixArt-Σ with KV compression, in the port
against the JAX package: the tiny Σ (tests/torch_parity.py: 2304 tokens,
so block 0's self-attention streams its kv, K6; block 1 compresses k/v
with the 2x2 `sr` conv) under `w4a8_adaround.yaml` with `sr` added to its
fp list (a copy).

`sr` quantizes its weight on the fly with no rounding parameter, so an
AdaRound plan that reaches it has no alpha to round by: both packages
raise ValueError there (JAX layers.py:262-268), and a user must fp-list
it, as `chip_smoke.py`'s phase `recon_sigma` does.

The stream block's parity is held where the minibatch draw cannot matter
(tests/test_torch_recon.py's header): the float32 block (`standalone_block
(0)`) of both packages on the same rows, its forward in quant mode with
soft rounding and the gradient of the reconstruction loss with respect
to every alpha of the block. Tolerance 1e-4 relative for the output, the
loss and each layer's gradient: the block's float32 arithmetic summed in
another order, its dynamic 8-bit acts fake-quantized per token in both
(a code at a rounding tie may flip with an ulp of the act) and q.k on
bf16-rounded operands (an operand at a bf16 tie may round the other
way); readings 3e-7 for the output and the loss, 3e-7 to 2.9e-5 for the
gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util

from torch_parity import (TINY_SIGMA, build_jax, build_port, inputs,
                          jax_kernel_path, rel_err)
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import reconstruction as JR
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.quant import reconstruction as R
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.utils import workload
from viditq_tpu_torch.utils.config import load_quant_config

ADAROUND = "configs/opensora/w4a8_adaround.yaml"
REMAIN_FP = "configs/opensora/remain_fp.txt"
TOL = 1e-4
WEIGHT_SCALE = 0.02


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def fp_listed_plan(tmp, with_sr: bool = True) -> str:
    """A copy of the AdaRound plan whose fp list is remain_fp.txt's lines
    plus `sr` (with_sr), or those lines alone."""
    with open(REMAIN_FP) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    fp = tmp / f"fp{'_sr' if with_sr else ''}.txt"
    fp.write_text("\n".join(lines + (["sr"] if with_sr else [])) + "\n")
    with open(ADAROUND) as f:
        y = yaml.safe_load(f)
    y["part_fp_list"] = str(fp)
    path = tmp / f"adaround{'_sr' if with_sr else ''}.yaml"
    path.write_text(yaml.safe_dump(y, sort_keys=False))
    return str(path)


@pytest.mark.parametrize("with_sr", [True, False], ids=["sr_listed",
                                                         "as_written"])
def test_both_packages_resolve_sr_as_fp_only_when_listed(tmp_path,
                                                         with_sr):
    path = fp_listed_plan(tmp_path, with_sr)
    for load in (j_load, load_quant_config):
        resolve = load(path).resolver()
        s = resolve("blocks.1.attn.sr")
        assert (not s.weight_quant and not s.act_quant) == with_sr, load
        # the block's linears stay quantized, by AdaRound
        q = resolve("blocks.1.attn.q")
        assert q.weight_quant and q.weight.round_mode == \
            "learned_hard_sigmoid"


def test_adaround_reaching_sr_raises_in_both_packages(tmp_path):
    path = fp_listed_plan(tmp_path, with_sr=False)
    kw = dict(kind="sigma", input_size=32, weight_scale=WEIGHT_SCALE)
    jmodel, jv = build_jax(path, **kw)
    port = build_port(path, jv, kind="sigma", input_size=32)
    x, t, y, mask = inputs(kind="sigma")
    x = x[..., :32, :32]
    with pytest.raises(ValueError, match="alpha"):
        jmodel.apply(jv, x, t, y, mask, qctx=JQuantCtx(mode="quant"))
    with pytest.raises(ValueError, match="alpha"):
        with torch.no_grad():
            port(_t(x), _t(t), _t(y), _t(mask), qctx=QuantCtx(mode="quant"))
    # with sr listed both run
    path = fp_listed_plan(tmp_path, with_sr=True)
    jmodel, jv = build_jax(path, **kw)
    port = build_port(path, jv, kind="sigma", input_size=32)
    want = np.asarray(jmodel.apply(jv, x, t, y, mask,
                                   qctx=JQuantCtx(mode="quant")))
    with torch.no_grad():
        got = port(_t(x), _t(t), _t(y), _t(mask),
                   qctx=QuantCtx(mode="quant")).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape


def test_sigma_block_reconstruction_with_kv_compression(tmp_path):
    """The port's block reconstruction over the tiny Σ with its KV
    compression (block 0 streams its kv in float32, block 1 compresses
    it): every alpha moves from its init, every other table stays."""
    plan = load_quant_config(fp_listed_plan(tmp_path))
    from viditq_tpu_torch.models.pixart import PixArt
    model = PixArt(resolver=plan.resolver(), dtype=torch.float32,
                   **TINY_SIGMA)
    workload.random_init_(model, 0, 0.1)
    calibrate_weight_tables(model)
    assert model.blocks[1].attn.sr.lspec.weight_quant is False
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x, t, y, mask = inputs(batch=1, kind="sigma")
    cfg = dataclasses.replace(R.recon_config(plan), iters=2, warmup=0.0)
    timings = {}
    R.model_block_reconstruction(
        model, (_t(x), _t(t.astype(np.float32)), _t(y), _t(mask)), cfg,
        mask=_t(mask), timings=timings)
    assert len(timings["block_s"]) == len(timings["capture_s"]) == 2
    after = model.state_dict()
    alphas = [k for k in before if k.endswith("w_alpha")]
    assert any(k.startswith("blocks.1.attn.") for k in alphas)
    assert all(not torch.equal(before[k], after[k]) for k in alphas)
    assert all(torch.equal(before[k], after[k]) for k in before
               if not k.endswith("w_alpha"))


def test_sigma_stream_block_forward_and_backward_match_jax(tmp_path):
    path = fp_listed_plan(tmp_path)
    jmodel, jv = build_jax(path, kind="sigma", weight_scale=WEIGHT_SCALE)
    port = build_port(path, jv, kind="sigma")
    jmod, jextra = JR._standalone_block(jmodel, 0)
    block, extra = port.standalone_block(0)
    assert tuple(jextra) == tuple(extra) == (48, 48)
    rng = np.random.default_rng(31)
    B, N, C = 2, 48 * 48, TINY_SIGMA["hidden_size"]
    x = rng.standard_normal((B, N, C)).astype(np.float32)
    yc = (rng.standard_normal((B, 8, C)) * 0.5).astype(np.float32)
    t0 = (rng.standard_normal((B, 6 * C)) * 0.1).astype(np.float32)
    mask = np.ones((B, 8), np.int32)
    mask[1, 5:] = 0
    target = (x + rng.standard_normal((B, N, C)) * 0.01).astype(np.float32)

    flat = traverse_util.flatten_dict(jv["quant"]["blocks_0"])
    paths = sorted(p for p in flat if p[-1] == "w_alpha")
    # q, k, v and proj; q_linear, kv_linear and proj; fc1 and fc2
    assert len(paths) == 9

    def jloss(alphas):
        fq = dict(flat)
        fq.update(zip(paths, alphas))
        out = jmod.apply({"params": jv["params"]["blocks_0"],
                          "quant": traverse_util.unflatten_dict(fq)},
                         jnp.asarray(x), jnp.asarray(yc), jnp.asarray(t0),
                         jnp.asarray(mask), jextra,
                         JQuantCtx(mode="quant", soft_targets=True))
        return jnp.mean((out - jnp.asarray(target)) ** 2), out
    with jax_kernel_path():
        (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
            [flat[p] for p in paths])

    mods = dict(block.named_modules())
    alphas = []
    for p in paths:
        m = mods[".".join(p[:-1])]
        assert isinstance(m, QuantLinear) and m.adaround
        m.w_alpha = m.w_alpha.detach().clone().requires_grad_()
        alphas.append(m.w_alpha)
    with torch.enable_grad():
        out = block(_t(x), _t(yc), _t(t0), _t(mask), extra,
                    QuantCtx(mode="quant", soft_targets=True))
        loss = torch.mean((out - _t(target)) ** 2)
        grads = torch.autograd.grad(loss, alphas)
    assert rel_err(out.detach(), jout) < TOL
    assert abs(loss.item() - float(jl)) <= TOL * abs(float(jl))
    for p, g, jg in zip(paths, grads, jgrads):
        assert np.linalg.norm(jg) > 0, p
        assert rel_err(g, jg) < TOL, (p, rel_err(g, jg))
