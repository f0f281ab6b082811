"""The port's quantizer modes (`viditq_tpu_torch/quant/core.py`), K3's
float32 mode and its gradient, and a QuantLinear's AdaRound gradient
against the JAX package's, on the same inputs made with numpy from a
seed.

Tolerances, each with its reason:
  * round_ste, AdaRound's hard codes (floor + (alpha >= 0)) and the
    weight tables are the same float32 elementwise sequence in both
    packages: equal; the alpha init takes a log and the soft targets a
    sigmoid, whose XLA and PyTorch CPU versions are an ulp apart at a few
    percent of entries: the alphas within 4 ulp, the soft targets (in
    [0, 1]) and the soft codes within 1e-6;
  * the grid search: the same candidate in both packages, so its codes are
    equal and its scales equal to 1 ulp (the candidate's loss sums in
    another order; the winning index is compared too);
  * stochastic rounding draws from another generator than JAX's threefry
    key, so it is held in distribution: every code is the floor or the
    floor + 1, a rest of 0 rounds to the floor exactly, and over 4000
    draws the mean code is the scaled value within 5 standard errors, as
    JAX's is;
  * K3's float32 plain version against the JAX Pallas kernel in interpret
    mode: 1e-5 relative (summation order of the softmax and the PV);
  * K3's gradient (the recompute through the plain f32 attention in both
    packages, JAX's `custom_vjp`) and a QuantLinear's gradient with
    respect to w_alpha through the soft rounding: 1e-5 relative (float32
    summation order), the clips passing half the gradient at a bound in
    both (`core.clip`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from viditq_tpu.kernels import attention as jattn
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.quant import core as jcore
from viditq_tpu.quant.qlinear import QuantLinear as JQuantLinear
from viditq_tpu.quant.spec import QuantSpec as JQuantSpec
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.quant import core
from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
from viditq_tpu_torch.quant.spec import QuantSpec
from viditq_tpu_torch.utils.config import load_quant_config

ADAROUND = "configs/opensora/w4a8_adaround.yaml"
GRAD_REL = 1e-5
ATTN_REL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def specs(**kw):
    """The same quantizer spec in both packages."""
    return JQuantSpec(**kw), QuantSpec(**kw)


def test_round_ste_forward_and_gradient():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 8).astype(np.float32)
    x[:4] = [0.5, 1.5, -2.5, 3.0]  # ties round to even
    want = np.asarray(jcore.round_ste(jnp.asarray(x)))
    xt = t(x).requires_grad_()
    got = core.round_ste(xt)
    assert np.array_equal(got.detach().numpy(), want)
    assert np.array_equal(want, np.round(x))
    got.sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


def test_adaround_codes_and_init_alpha():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jspec, spec = specs(n_bits=4, granularity="channel",
                        round_mode="learned_hard_sigmoid")
    d, z = jcore.compute_qparams(jnp.asarray(w), jspec)
    pd, pz = core.compute_qparams(t(w), spec)
    assert np.array_equal(pd.numpy(), np.asarray(d))
    assert np.array_equal(pz.numpy(), np.asarray(z))
    alpha = np.asarray(jcore.adaround_init_alpha(jnp.asarray(w), d))
    np.testing.assert_array_max_ulp(
        core.adaround_init_alpha(t(w), pd).numpy(), alpha, maxulp=4)
    # the init's soft target is the rounding rest (clipped)
    rest = np.clip(w / np.asarray(d) - np.floor(w / np.asarray(d)), 1e-4,
                   1 - 1e-4)
    np.testing.assert_allclose(core.adaround_soft_targets(t(alpha)).numpy(),
                               rest, atol=1e-5)
    alpha = alpha + rng.standard_normal(alpha.shape).astype(np.float32)
    alpha[0, :4] = [0.0, -0.0, 20.0, -20.0]  # the hard edge, saturation
    np.testing.assert_allclose(
        core.adaround_soft_targets(t(alpha)).numpy(),
        np.asarray(jcore.adaround_soft_targets(jnp.asarray(alpha))),
        rtol=0, atol=1e-6)
    for soft in (True, False):
        want = np.asarray(jcore.fake_quant(jnp.asarray(w), d, z, jspec,
                                           alpha=jnp.asarray(alpha),
                                           soft_targets=soft))
        got = core.fake_quant(t(w), pd, pz, spec, alpha=t(alpha),
                              soft_targets=soft)
        codes = core._int_code(t(w), pd, spec, alpha=t(alpha),
                               soft_targets=soft)
        jcodes = jcore._int_code(jnp.asarray(w), d, jspec,
                                 alpha=jnp.asarray(alpha), soft_targets=soft)
        if soft:  # the sigmoid's ulp, times the scale
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(codes.numpy(), np.asarray(jcodes),
                                       rtol=0, atol=1e-6)
        else:
            assert np.array_equal(got.numpy(), want)
            assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    # hard rounding is floor + (alpha >= 0), -0.0 included
    hard = core._int_code(t(w), pd, spec, alpha=t(alpha), soft_targets=False)
    assert np.array_equal(hard.numpy(), np.floor(w / np.asarray(d))
                          + (alpha >= 0))
    with pytest.raises(ValueError, match="alpha"):
        core.fake_quant(t(w), pd, pz, spec)


@pytest.mark.parametrize("case", [
    dict(n_bits=4, granularity="channel"),
    dict(n_bits=8, granularity="channel", sym=True),
    dict(n_bits=8, granularity="token"),
    dict(n_bits=8, granularity="tensor", always_zero=True),
], ids=["w4-channel", "w8-sym", "a8-token", "a8-always-zero"])
def test_grid_search_matches_jax(case):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 40)).astype(np.float32)
    x[0, 3] *= 9.0  # an outlier row, so the search shrinks the range
    if case.get("always_zero"):
        x = np.abs(x)
    jspec, spec = specs(scale_method="grid_search_lp", **case)
    d, z = jcore.compute_qparams(jnp.asarray(x), jspec)
    pd, pz = core.compute_qparams(t(x), spec)
    np.testing.assert_allclose(pd.numpy(), np.asarray(d), rtol=1.2e-7,
                               atol=0)
    assert np.array_equal(pz.numpy(), np.asarray(z))
    jq = np.asarray(jcore.fake_quant(jnp.asarray(x), d, z, jspec))
    pq = core.fake_quant(t(x), t(np.asarray(d)), t(np.asarray(z)), spec)
    assert np.array_equal(pq.numpy(), jq)
    # the winner is not the full range (the search did shrink it)
    mn, mx = core.minmax(t(x), spec)
    assert not torch.equal(pd, core.qparams_minmax(mn, mx, spec)[0])


def test_stochastic_rounding_in_distribution():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(512) * 3).astype(np.float32)
    x[:8] = [-3.0, -1.0, 0.0, 2.0, 5.0, 0.25, 0.5, 0.75]
    d = np.float32(0.5)
    jspec, spec = specs(n_bits=8, granularity="tensor",
                        round_mode="stochastic", sym=True)
    scaled = x / d
    draws = 4000
    g = torch.Generator().manual_seed(0)
    xs = t(np.broadcast_to(x, (draws, x.size)))
    codes = core._int_code(xs, torch.tensor(d), spec, generator=g).numpy()
    jcodes = np.asarray(jcore._int_code(
        jnp.asarray(np.broadcast_to(x, (draws, x.size))), jnp.asarray(d),
        jspec, rng=jax.random.PRNGKey(0)))
    floor = np.floor(scaled)
    for c in (codes, jcodes):
        assert np.all((c == floor) | (c == floor + 1))
        # a rest of 0 (x / d an integer) rounds to the floor every time
        exact = scaled == floor
        assert exact[:5].all() and np.all(c[:, exact] == floor[exact])
        rest = scaled - floor
        se = np.sqrt(rest * (1 - rest) / draws) + 1e-12
        assert np.all(np.abs(c.mean(axis=0) - scaled) <= 5 * se + 1e-6)
    # fake quant with the generator: dequantized codes, clipped as nearest
    fq = core.fake_quant(t(x), torch.tensor(d), torch.tensor(0.0), spec,
                         generator=torch.Generator().manual_seed(1))
    assert np.all(np.abs(fq.numpy() - x) < d)
    with pytest.raises(ValueError, match="generator"):
        core.fake_quant(t(x), torch.tensor(d), torch.tensor(0.0), spec)


def _attn_case(mode, seed=4):
    """q, k, v, seg_len, kv mask of the recon block's three sites at a
    small size: spatial full attention, temporal seg 4 and cross
    attention to padded prompts."""
    rng = np.random.default_rng(seed)
    B, H, D = 2, 2, 16
    N = 256 if mode == "seg" else 128
    M = {"full": 128, "seg": 256, "mask": 24}[mode]
    q, k, v = (rng.standard_normal((B, n, H, D)).astype(np.float32)
               for n in (N, M, M))
    mask = None
    if mode == "mask":
        mask = np.ones((B, M), np.int32)
        mask[1, 19:] = 0
    return q, k, v, (4 if mode == "seg" else 0), mask


@pytest.mark.parametrize("mode", ["full", "seg", "mask"])
def test_k3_float32_matches_jax_kernel(mode):
    q, k, v, seg, mask = _attn_case(mode)
    scale = 16 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.attention_bnhd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
            seg_len=seg, kv_mask=None if mask is None else jnp.asarray(mask)))
    got = A.attention_bnhd(t(q), t(k), t(v), scale, seg_len=seg,
                           kv_mask=None if mask is None else t(mask))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) \
        < ATTN_REL
    # the kernel's q.k is bf16's: not the f32 oracle's
    xla = A.attention_bnhd_xla(t(q), t(k), t(v), scale, seg,
                               None if mask is None else t(mask))
    assert not torch.allclose(got, xla, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["full", "seg", "mask"])
def test_k3_gradient_matches_jax_custom_vjp(mode):
    q, k, v, seg, mask = _attn_case(mode, seed=5)
    scale = 16 ** -0.5
    gout = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        return jnp.sum(jattn.attention_bnhd(q_, k_, v_, scale, seg_len=seg,
                                            kv_mask=jm) * gout)
    with pltpu.force_tpu_interpret_mode():
        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [t(a).requires_grad_() for a in (q, k, v)]
    out = A.attention_bnhd(*ts, scale, seg_len=seg,
                           kv_mask=None if mask is None else t(mask))
    (out * t(gout)).sum().backward()
    for name, pt, jt in zip("qkv", ts, jg):
        jt = np.asarray(jt)
        rel = np.linalg.norm(pt.grad.numpy() - jt) / np.linalg.norm(jt)
        assert rel < GRAD_REL, (name, rel)
    # the emitting form carries no gradient (JAX attention_bnhd_int8out)
    codes = A.attention_bnhd(*ts, scale, seg_len=seg, emit=True,
                             kv_mask=None if mask is None else t(mask))[0]
    assert codes.dtype == torch.int8 and not codes.requires_grad


def _layer_pair(spec_fn=None, seed=7):
    """A JAX QuantLinear and a port QuantLinear of the AdaRound plan's
    layer spec (simulate backend) on the same kernel, bias, tables and
    w_alpha; returns (jax module, variables, port layer, x)."""
    rng = np.random.default_rng(seed)
    K, F = 48, 40
    jspec = j_load(ADAROUND).default_layer
    pspec = load_quant_config(ADAROUND).default_layer
    if spec_fn is not None:
        jspec, pspec = spec_fn(jspec), spec_fn(pspec)
    kernel = (rng.standard_normal((K, F)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(F) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 16, K)).astype(np.float32)
    d, z = jcore.compute_qparams(jnp.asarray(kernel), jspec.weight)
    alpha = np.asarray(jcore.adaround_init_alpha(jnp.asarray(kernel), d))
    alpha = alpha + (rng.standard_normal(alpha.shape) * 0.5).astype(
        np.float32)
    jmod = JQuantLinear(F, lspec=jspec, dtype=jnp.float32)
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                  JQuantCtx(mode="fp"))
    quant = dict(v["quant"])
    quant.update(w_delta=jnp.asarray(d)[None, None],
                 w_zp=jnp.asarray(z)[None, None],
                 w_alpha=jnp.asarray(alpha))
    variables = {"params": {"kernel": jnp.asarray(kernel),
                            "bias": jnp.asarray(bias)}, "quant": quant}
    lin = QuantLinear(K, F, pspec, dtype=torch.float32)
    assert lin.adaround and lin.w_alpha.shape == (K, F)
    with torch.no_grad():
        lin.kernel.copy_(t(kernel))
        lin.bias.copy_(t(bias))
        lin.w_delta.copy_(t(np.asarray(d))[None, None])
        lin.w_zp.copy_(t(np.asarray(z))[None, None])
        lin.w_alpha.copy_(t(alpha))
    return jmod, variables, lin, x


@pytest.mark.parametrize("soft", [True, False])
def test_quantlinear_w_alpha_gradient_matches_jax(soft):
    jmod, variables, lin, x = _layer_pair()
    gout = np.random.default_rng(8).standard_normal((2, 16, 40)).astype(
        np.float32)

    def jloss(alpha):
        vs = {**variables, "quant": {**variables["quant"], "w_alpha": alpha}}
        out = jmod.apply(vs, jnp.asarray(x),
                         JQuantCtx(mode="quant", soft_targets=soft))
        return jnp.sum(out * gout), out
    (_, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        variables["quant"]["w_alpha"])
    alpha = lin.w_alpha.clone().requires_grad_()
    lin.w_alpha = alpha
    xt = t(x).requires_grad_()
    out = lin(xt, QuantCtx(mode="quant", soft_targets=soft))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    (out * t(gout)).sum().backward()
    jg = np.asarray(jg)
    if not soft:  # hard rounding: alpha >= 0 is flat
        assert not np.any(jg) and (alpha.grad is None
                                   or not torch.any(alpha.grad))
        return
    assert np.count_nonzero(jg) > jg.size // 2
    rel = np.linalg.norm(alpha.grad.numpy() - jg) / np.linalg.norm(jg)
    assert rel < GRAD_REL, rel
    # the input's gradient flows through the act quantizer's STE
    jgx = jax.grad(lambda xx: jnp.sum(jmod.apply(
        variables, xx, JQuantCtx(mode="quant", soft_targets=True)) * gout))(
            jnp.asarray(x))
    jgx = np.asarray(jgx)
    rel = np.linalg.norm(xt.grad.numpy() - jgx) / np.linalg.norm(jgx)
    assert rel < GRAD_REL, rel


def test_clip_passes_half_the_gradient_at_a_bound():
    x = torch.tensor([-1.0, 0.0, 0.5, 1.0, 2.0], requires_grad=True)
    core.clip(x, 0.0, 1.0).sum().backward()
    jg = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0)))(
        jnp.asarray(x.detach().numpy())))
    assert np.array_equal(x.grad.numpy(), jg)
    with torch.no_grad():  # no gradient: the forward is clamp's
        assert torch.equal(core.clip(x, 0.0, 1.0), torch.clamp(x, 0.0, 1.0))


@pytest.mark.parametrize("round_mode,scale_method", [
    ("stochastic", "min_max"), ("learned_hard_sigmoid", "min_max"),
    ("nearest", "grid_search_lp")])
def test_every_shipped_mode_builds_and_runs(round_mode, scale_method):
    """The quantizer modes the port once refused build a QuantLinear and
    run its simulate path (calibrated by `calibrate_weight_tables`)."""
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    spec = load_quant_config(ADAROUND).default_layer
    spec = dataclasses.replace(spec, weight=dataclasses.replace(
        spec.weight, round_mode=round_mode, scale_method=scale_method))
    lin = QuantLinear(64, 32, spec, dtype=torch.float32)
    with torch.no_grad():
        lin.kernel.normal_(generator=torch.Generator().manual_seed(0))
    calibrate_weight_tables(lin)
    assert torch.all(lin.w_delta > 0)
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(1))
    out = lin(x, QuantCtx(generator=torch.Generator().manual_seed(2)))
    assert out.shape == (2, 8, 32) and torch.isfinite(out).all()
