"""The residual (+ gate) epilogue, `o = res + gate * out` (JAX K2
`_consumer_kernel`, fused_matmul.py:383-390; K5 `_dynq_mm_kernel`,
:192-205; `QuantLinear._quant_forward`, qlinear.py:273-331), in the port
as it runs on CPU tensors, against the JAX package: K2 in every mode it
composes with and K5 in its act x weight modes against the Pallas kernels
in interpret mode, `QuantLinear` with the epilogue applied outside the
kernel against JAX with `VIDITQ_FUSE_EPILOGUE` off, and a tiny STDiT with
`fuse_epilogue=True` against the JAX model under `VIDITQ_FUSE_EPILOGUE=1`;
then the CUDA wrappers' argument rules.

Tolerances, each with its reason:
  * K2: the int32 product is exact in both and the f32 epilogue is the
    same sequence of operations: 1e-6 relative on f32 outputs (K2's
    tolerance, `tests/test_torch_kernels.py`), rtol 1e-5 / atol 1e-3 with
    zero points (`tests/test_torch_asym.py`);
  * K5: sym acts 1e-6 (`tests/test_torch_kernels.py`); asym acts 1e-4,
    where XLA's reciprocal-multiply `/ 255` may move a zero point
    (`tests/test_torch_asym.py`);
  * `QuantLinear` outside the kernel: the same bf16 (here f32) elementwise
    operations after the layer's own output: 1e-4, the CB layer's
    tolerance (`tests/test_torch_cb.py`);
  * the tiny STDiT: forward 1e-2 and 2-step CFG DDIM denoise 2e-2, the sm8
    limits. Its float32 activations make the fused and the outside
    epilogue the same f32 operations, so the JAX output does not move with
    the switch there (measured: bit-identical); the float32 test shows the
    switch took effect by the residual and gate that reach the JAX
    kernels, and a bfloat16 forward shows the JAX output moving with it
    (the fused epilogue rounds once in f32, the outside one twice in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_asym import _asym_tables
from test_torch_kernels import LAYOUTS, _i8, interp, rel_err, t
from test_torch_rules import _OnCard
from torch_parity import (SM8, build_jax, build_port, inputs,
                          jax_kernel_path)
from viditq_tpu.kernels import fused_matmul as jfm
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.kernels._common import k_major
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant.qlinear import QuantCtx, apply_epilogue
from viditq_tpu_torch.samplers.iddpm import IDDPM

FWD_TOL = 1e-2
DENOISE_TOL = 2e-2
EPI = {"res": False, "res+gate": True}


def _epilogue(rng, M, N, with_gate, G=2):
    res = rng.standard_normal((M, N)).astype(np.float32)
    gate = (rng.standard_normal((G, N)).astype(np.float32)
            if with_gate else None)
    return res, gate


def _j(a):
    return None if a is None else jnp.asarray(a)


def _p(a):
    return None if a is None else t(a)


@pytest.mark.parametrize("epi", list(EPI))
@pytest.mark.parametrize("mode", ["sym", "gw_x", "asym", "sym-asym_w"])
def test_k2_residual_gate_matches_jax(mode, epi):
    rng = np.random.default_rng(50)
    M, N = 512, 256
    res, gate = _epilogue(rng, M, N, EPI[epi])
    if mode in ("sym", "gw_x"):
        G = 3 if mode == "gw_x" else 1
        K = 768 if mode == "gw_x" else 256
        xq, w = _i8(rng, (M, K)), _i8(rng, (K, N))
        xs = rng.uniform(1e-3, 2e-2, (M, G)).astype(np.float32)
        ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
        b = rng.standard_normal(N).astype(np.float32)
        jxs = np.repeat(xs, 128, axis=1) if G > 1 else xs
        jkw, pkw = {}, dict(group_scales=G > 1)
        tol = None
    else:
        (xq, xs, xzp, xrs), w, ws, wzp, wcs, b = _asym_tables(
            rng, M, 256, N, act_sym=mode == "sym-asym_w")
        jxs = xs
        jkw = dict(x_zp=_j(xzp), x_rowsum=_j(xrs), w_zp=_j(wzp),
                   w_colsum=_j(wcs))
        pkw = dict(x_zp=_p(xzp), x_rowsum=_p(xrs), w_zp=_p(wzp),
                   w_colsum=_p(wcs))
        tol = dict(rtol=1e-5, atol=1e-3)
    want = interp(jfm.int8_consumer_matmul, jnp.asarray(xq), jnp.asarray(jxs),
                  jnp.asarray(w), jnp.asarray(ws), bias=jnp.asarray(b),
                  out_dtype=jnp.float32, residual=jnp.asarray(res),
                  gate=_j(gate), **jkw)
    for layout in LAYOUTS.values():
        got = FM.int8_consumer_matmul(
            t(xq), t(xs), layout(t(w)), t(ws), t(b), out_dtype=torch.float32,
            residual=t(res), gate=_p(gate), **pkw)
        if tol is None:
            assert rel_err(got, want) < 1e-6
        else:
            np.testing.assert_allclose(got.numpy(), want, **tol)
    # the epilogue is the kernel's: the output minus the residual, over the
    # gate, is the plain output
    base = FM.int8_consumer_matmul(t(xq), t(xs), t(w), t(ws), t(b),
                                   out_dtype=torch.float32, **pkw)
    assert torch.equal(got, FM.residual_gate(base, t(res), _p(gate)))


def test_k2_residual_rounds_once_to_bf16():
    # bf16 out: res + gate * out in f32, one cast (not the outside add's
    # two bf16 roundings)
    rng = np.random.default_rng(51)
    M, K, N = 64, 128, 64
    xq, w = _i8(rng, (M, K)), _i8(rng, (K, N))
    xs = rng.uniform(1e-3, 2e-2, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    res, gate = _epilogue(rng, M, N, True)
    args = [t(a) for a in (xq, xs, w, ws)]
    f32 = FM.int8_consumer_matmul(*args, None, torch.float32)
    got = FM.int8_consumer_matmul(*args, residual=t(res).bfloat16(),
                                  gate=t(gate).bfloat16())
    want = FM.residual_gate(f32, t(res).bfloat16(), t(gate).bfloat16())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("epi", list(EPI))
@pytest.mark.parametrize("sym,sym_w", [(True, True), (True, False),
                                       (False, False)],
                         ids=["sym", "sym-asym_w", "asym"])
def test_k5_residual_gate_matches_jax(sym, sym_w, epi):
    rng = np.random.default_rng(52)
    M, K, N = 512, 128, 256
    x = (rng.standard_normal((M, K)) + 0.3).astype(np.float32)
    w = _i8(rng, (K, N))
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    wzp = rng.integers(-20, 20, (1, N)).astype(np.float32)
    wcs = w.astype(np.float32).sum(0, keepdims=True)
    b = rng.standard_normal(N).astype(np.float32)
    res, gate = _epilogue(rng, M, N, EPI[epi])
    want = interp(jfm.fused_dynq_int8_matmul, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(ws), jnp.asarray(wzp), jnp.asarray(wcs),
                  sym=sym, sym_w=sym_w, bias=jnp.asarray(b),
                  out_dtype=jnp.float32, residual=jnp.asarray(res),
                  gate=_j(gate))
    got = FM.fused_dynq_int8_matmul(t(x), k_major(t(w)), t(ws), t(b),
                                    torch.float32, sym=sym, sym_w=sym_w,
                                    w_zp=t(wzp), w_colsum=t(wcs),
                                    residual=t(res), gate=_p(gate))
    assert rel_err(got, want) < (1e-6 if sym else 1e-4)
    # as quantized_linear_native's fused impl serves it
    packed = {"w_q": t(w), "w_scale": t(ws), "w_zp": t(wzp),
              "w_colsum": t(wcs)}
    assert torch.equal(got, IM.quantized_linear_native(
        t(x), packed, t(b), act_sym=sym, w_sym=sym_w,
        out_dtype=torch.float32, impl="fused", residual=t(res),
        gate=_p(gate)))


# ---- QuantLinear with the epilogue outside the kernel ----

def _cb_layer():
    from test_torch_cb import _one_layer
    return _one_layer(frozen=True)


@pytest.mark.parametrize("epi", list(EPI))
def test_quantlinear_epilogue_outside_the_kernel_matches_jax(epi,
                                                             monkeypatch):
    # a channel-balanced layer is not fusable in either package, so both
    # add the residual after the layer; the switch is off
    monkeypatch.setenv("VIDITQ_FUSE_EPILOGUE", "0")
    jlin, jv, lin, x = _cb_layer()
    rng = np.random.default_rng(53)
    B, L, N = x.shape[0], x.shape[1], lin.features
    res = rng.standard_normal((B, L, N)).astype(np.float32)
    gate = rng.standard_normal((B, N)).astype(np.float32) if EPI[epi] \
        else None
    assert not lin._epilogue_fusable(QuantCtx(t_id=250))
    for t_id in (250, 750):
        with jax_kernel_path():
            want = np.asarray(jlin.apply(
                jv, jnp.asarray(x),
                JQuantCtx(mode="quant", t_id=jnp.asarray(t_id)),
                epilogue=(jnp.asarray(res), _j(gate))))
        with torch.no_grad():
            got = lin(t(x), QuantCtx(t_id=t_id),
                      epilogue=(t(res), _p(gate)))
            out = lin(t(x), QuantCtx(t_id=t_id))
        assert got.shape == want.shape
        assert rel_err(got, want) < 1e-4
        assert torch.equal(got, apply_epilogue(out, t(res), _p(gate)))


def test_quantlinear_fp_epilogue_is_the_blocks_add():
    # fp mode: `res + gate * out` in the layer's dtype, per batch row
    from viditq_tpu_torch.quant.qlinear import QuantLinear
    lin = QuantLinear(16, 8, dtype=torch.bfloat16)
    torch.nn.init.normal_(lin.kernel)
    x = torch.randn(2, 5, 16).bfloat16()
    res, gate = torch.randn(2, 5, 8).bfloat16(), torch.randn(2, 8).bfloat16()
    out = lin(x)
    got = lin(x, epilogue=(res, gate))
    assert torch.equal(got, res + gate[:, None] * out)
    assert torch.equal(lin(x, epilogue=(res, None)), res + out)
    with pytest.raises(ValueError, match="emit"):
        lin(x, emit={"gelu": True}, epilogue=(res, None))


# ---- the tiny STDiT with fuse_epilogue ----

@pytest.fixture(scope="module")
def built():
    jmodel, jv = build_jax(SM8)
    return jmodel, jv, build_port(SM8, jv, fuse_epilogue=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _spy_jax_k2_k5(monkeypatch):
    """Record, at trace time, the residual and gate the JAX package hands
    its K2 and K5."""
    seen = []
    for name in ("int8_consumer_matmul", "fused_dynq_int8_matmul"):
        fn = getattr(jfm, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            if kw.get("residual") is not None:
                seen.append((_name, kw.get("gate") is not None))
            return _fn(*a, **kw)
        monkeypatch.setattr(jfm, name, wrapped)
    return seen


def _jax_forward(jmodel, jv, args):
    # a fresh trace: the switch is read while tracing
    fn = jax.jit(lambda x, tt, y, m: jmodel.apply(
        jv, x, tt, y, m, qctx=JQuantCtx(mode="quant")))
    with jax_kernel_path():
        return np.asarray(fn(*args)).astype(np.float32)


def test_fuse_epilogue_forward_matches_jax(built, monkeypatch):
    jmodel, jv, port = built
    seen = _spy_jax_k2_k5(monkeypatch)
    monkeypatch.setenv("VIDITQ_FUSE_EPILOGUE", "1")
    args = inputs()
    want = _jax_forward(jmodel, jv, args)
    # the switch took effect: the spatial proj (gate), the cross proj (no
    # gate) and fc2 (gate) of every block took the epilogue in K2
    depth = len(port.blocks)
    assert sorted(seen) == sorted(
        [("int8_consumer_matmul", True)] * 2 * depth
        + [("int8_consumer_matmul", False)] * depth)
    calls = []
    orig = FM.int8_consumer_matmul_plain

    def spy(*a, **kw):
        if kw.get("residual") is not None:
            calls.append(kw.get("gate") is not None)
        return orig(*a, **kw)
    monkeypatch.setattr(FM, "int8_consumer_matmul_plain", spy)
    with torch.no_grad():
        got = port(*map(_t, args), qctx=QuantCtx(mode="quant")).numpy()
    assert sorted(calls) == sorted([True] * 2 * depth + [False] * depth)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    with torch.no_grad():
        fp = port(*map(_t, args)).numpy()
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


def test_fuse_epilogue_denoise_matches_jax(built, monkeypatch):
    jmodel, jv, port = built
    monkeypatch.setenv("VIDITQ_FUSE_EPILOGUE", "1")
    x, _, y, mask = inputs(batch=1, seed=3)
    y2 = np.concatenate([y, inputs(batch=1, seed=4)[2]])  # [cond; null]
    kw = dict(num_sampling_steps=2, cfg_scale=4.0)
    with jax_kernel_path():
        want = j_quant_sample(jmodel, jv, JIDDPM(**kw), jnp.asarray(x),
                              jnp.asarray(y2), jnp.asarray(mask))
    got = quant_sample(port, IDDPM(**kw), _t(x), _t(y2), _t(mask))
    assert got.shape == (1, 4, *x.shape[2:])
    assert rel_err(got.numpy(), want) < DENOISE_TOL
    assert rel_err(got.numpy(), x) > 0.01


def test_jax_output_moves_with_the_switch_in_bf16(monkeypatch):
    jmodel, jv = build_jax(SM8, dtype=jnp.bfloat16)
    args = inputs()
    outs = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("VIDITQ_FUSE_EPILOGUE", switch)
        outs[switch] = _jax_forward(jmodel, jv, args)
    assert rel_err(outs["1"], outs["0"]) > 1e-3
    # and the port's with its flag, on the same weights
    got = {}
    for flag in (False, True):
        port = build_port(SM8, jv, dtype=torch.bfloat16, fuse_epilogue=flag)
        with torch.no_grad():
            got[flag] = port(*map(_t, args),
                             qctx=QuantCtx(mode="quant")).float().numpy()
    assert rel_err(got[True], got[False]) > 1e-3


def test_fuse_epilogue_is_a_model_argument():
    # set in a workload config's `model` dict; off by default, as in JAX
    from viditq_tpu_torch.utils.workload import build_model
    tiny = dict(type="STDiT", hidden_size=64, depth=2, num_heads=4,
                caption_channels=32, model_max_length=8)
    cfg = {"num_frames": 2, "image_size": (128, 256), "dtype": "fp32"}
    on = build_model({**cfg, "model": {**tiny, "fuse_epilogue": True}},
                     device="cpu")
    off = build_model({**cfg, "model": tiny}, device="cpu")
    assert all(b.fuse_epilogue for b in on.blocks)
    assert not any(b.fuse_epilogue for b in off.blocks)


# ---- the CUDA wrappers' argument rules (no card: the launch is
# intercepted) ----

class _Launched(Exception):
    pass


@pytest.fixture
def card_args(monkeypatch):
    def lib():
        raise _Launched()
    monkeypatch.setattr(_build, "lib", lib)
    rng = np.random.default_rng(54)
    M, K, N = 32, 128, 64
    card = lambda a: t(a).as_subclass(_OnCard)  # noqa: E731
    xq, w = card(_i8(rng, (M, K))), card(k_major(t(_i8(rng, (K, N)))).numpy())
    xs = card(rng.uniform(1e-3, 1e-2, (M, 1)).astype(np.float32))
    ws = card(rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32))
    res = card(rng.standard_normal((M, N)).astype(np.float32)).bfloat16()
    gate = card(rng.standard_normal((2, N)).astype(np.float32)).bfloat16()
    x = card(rng.standard_normal((M, K)).astype(np.float32)).bfloat16()
    return xq, xs, w, ws, x, res, gate


def test_cuda_residual_modes_reach_the_launch(card_args):
    xq, xs, w, ws, x, res, gate = card_args
    for g in (None, gate):
        with pytest.raises(_Launched):
            FM.int8_consumer_matmul(xq, xs, w, ws, residual=res, gate=g)
        with pytest.raises(_Launched):
            FM.fused_dynq_int8_matmul(x, w, ws, residual=res, gate=g)


def test_cuda_residual_refusals(card_args):
    xq, xs, w, ws, x, res, gate = card_args
    with pytest.raises(ValueError, match="bf16"):
        FM.int8_consumer_matmul(xq, xs, w, ws, out_dtype=torch.float32,
                                residual=res)
    with pytest.raises(ValueError, match="bf16"):
        FM.int8_consumer_matmul(xq, xs, w, ws, residual=res.float())
    with pytest.raises(ValueError, match="emission"):
        FM.int8_consumer_matmul(xq, xs, w, ws, emit={"gelu": True},
                                residual=res)
    with pytest.raises(ValueError, match="residual"):
        FM.int8_consumer_matmul(xq, xs, w, ws, gate=gate)
    with pytest.raises(ValueError, match="multiple of G"):
        FM.int8_consumer_matmul(xq, xs, w, ws, residual=res, gate=gate[:1]
                                .repeat(3, 1))
    with pytest.raises(ValueError, match="bf16 x"):
        FM.fused_dynq_int8_matmul(x.float(), w, ws, residual=res)


def test_chip_smoke_carries_the_epilogue_cases_and_arm():
    import inspect
    import chip_smoke as cs
    assert cs.SLICE_KERNELS["stdit"]["sm8_epi"] == cs.FUSED_KERNELS
    assert cs.arm_build("stdit", "sm8_epi") == (
        cs.SM8_PLAN, None, (("fuse_epilogue", True),))
    # the epilogues add no launch: sm8_epi is held to sm8's counts
    assert cs.BLOCK_LAUNCHES[("stdit", "sm8_epi")] == cs.BLOCK_LAUNCHES[
        ("stdit", "sm8")]
    src = inspect.getsource(cs.epilogue_cases)
    for part in ("sym proj +res+gate", "gw_x fc2 +res+gate",
                 "asym zp +res+gate", "sym x asym-weight zp +res+gate",
                 "sym cross proj +res", "gate rows straddle tiles",
                 "rows past M",
                 "exact=True", "check_k5(", "sym=sym, sym_w=sym_w"):
        assert part in src, part
    assert "epilogue_cases(records)" in inspect.getsource(cs.phase_kernels)
    assert "TINY_STDIT_EPI_CFG" in inspect.getsource(cs.phase_reference)
    # K5 is held identical to the K4 -> K2 route with the residual
    assert "residual=residual" in inspect.getsource(cs.k5_route)
