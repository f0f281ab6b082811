"""The port's native int8 linear (K7a `dynamic_quant_rows`, K7b
`int8_matmul`, `quantized_linear_native`), as it runs on CPU tensors,
against the JAX package's Pallas kernels in interpret mode and its jnp
oracles — the same inputs, made with numpy from a seed.

Tolerances, each with its reason:
  * K7a: XLA on the CPU evaluates `(max - min) / 255` and `absmax / 127`
    as a multiply by the reciprocal, one ulp away from the true division
    the port (and the CUDA kernel) performs. So scales agree to 1e-6
    relative; codes are equal or off by one at no more than 0.1% of the
    entries; now and then a row's zero point moves by one together with
    its codes, and such a row is compared dequantized, (q - zp) * s, at
    1e-6 relative. Row sums are the sums of each package's own codes.
  * K7b: the int32 product is exact in both; the f32 epilogue is the same
    sequence of operations, so f32 outputs agree to rtol 1e-5 / atol 1e-3
    (`tests/test_int_kernels.py`'s tolerance) and bf16 outputs are equal.
  * `quantized_linear_native`: K7a's rare off-by-one codes move an output
    by one quantization step of one product term: 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import LAYOUTS, interp, rel_err, t
from torch_parity import jax_kernel_path
from viditq_tpu.kernels import int_matmul as jim
from viditq_tpu_torch.kernels import _counters
from viditq_tpu_torch.kernels import int_matmul as IM

SHAPES = [(64, 256), (19, 72)]


def check_dyn_quant(got, want):
    """K7a outputs (codes, scale, zp, rowsum) against JAX's, within the
    module's tolerances. Returns the number of rows whose zp moved."""
    q, s, z, rs = (np.asarray(a, np.float64) for a in got)
    jq, js, jz, jrs = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_allclose(s, js, rtol=1e-6)
    dz = np.abs(z - jz)[:, 0]
    assert dz.max() <= 1
    same = dz == 0
    diff = np.abs(q - jq)
    assert diff[same].max(initial=0) <= 1
    assert (diff[same] > 0).sum() <= 1e-3 * q.size
    np.testing.assert_allclose((q - z)[~same] * s[~same],
                               (jq - jz)[~same] * js[~same], rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(rs, q.sum(1, keepdims=True))
    np.testing.assert_array_equal(jrs, jq.sum(1, keepdims=True))
    return int((~same).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["64x256", "19x72"])
@pytest.mark.parametrize("sym", [False, True], ids=["asym", "sym"])
def test_k7a_dynamic_quant_rows(sym, shape, dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 2 + 0.4).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    px = t(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    got = IM.dynamic_quant_rows(px, sym=sym)
    assert got[0].dtype == torch.int8 and got[0].shape == shape
    assert all(a.dtype == torch.float32 and a.shape == (shape[0], 1)
               for a in got[1:])
    if sym:
        assert not got[2].any()
    moved = check_dyn_quant(got, interp(jim.dynamic_quant_rows, jx,
                                        sym=sym))
    # jitted, as the model runs it: there XLA divides by a reciprocal
    ref = jax.jit(functools.partial(jim.dynamic_quant_rows_ref, sym=sym))
    moved += check_dyn_quant(got, ref(jx))
    assert moved <= shape[0] // 4


@pytest.mark.parametrize("c,share", [(255.0, 0.5), (127.0, 0.01)])
def test_k7a_true_division_differs_from_a_reciprocal_multiply(c, share):
    # the reason for `divc`: the two roundings of x / c disagree on a large
    # share of float32 inputs (here 71.5% for 255 and 4.5% of |x| for 127),
    # so the quantizer must name one
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    x = x if c == 255.0 else x.abs()
    true = IM.divc(x, c)
    assert torch.equal(true, x / torch.tensor(c))
    assert (true != x * (1.0 / c)).float().mean() > share


def _tables(rng, M, K, N):
    x_q = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w_q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    xs = rng.uniform(0.01, 0.1, (M, 1)).astype(np.float32)
    xzp = rng.integers(-128, 128, (M, 1)).astype(np.float32)
    xrs = x_q.astype(np.float32).sum(1, keepdims=True)
    ws = rng.uniform(1e-3, 1e-2, (1, N)).astype(np.float32)
    wzp = rng.integers(-20, 20, (1, N)).astype(np.float32)
    wcs = w_q.astype(np.float32).sum(0, keepdims=True)
    return x_q, w_q, xs, xzp, xrs, ws, wzp, wcs


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mkn", [(96, 384, 256), (19, 72, 40)],
                         ids=["96x384x256", "19x72x40"])
def test_k7b_int8_matmul(mkn, out_dtype, layout):
    rng = np.random.default_rng(12)
    args = _tables(rng, *mkn)
    jd = jnp.dtype(out_dtype)
    want = interp(jim.int8_matmul, *(jnp.asarray(a) for a in args),
                  out_dtype=jd, block_m=32, block_n=128, block_k=128)
    pargs = [t(a) for a in args]
    got = IM.int8_matmul(pargs[0], LAYOUTS[layout](pargs[1]), *pargs[2:],
                         out_dtype=getattr(torch, out_dtype))
    assert got.shape == mkn[::2] and got.dtype == getattr(torch, out_dtype)
    assert torch.equal(got, IM.int8_matmul(
        *pargs, out_dtype=getattr(torch, out_dtype)))
    got = got.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_k7b_bias_is_added_in_the_output_dtype():
    rng = np.random.default_rng(13)
    args = [t(a) for a in _tables(rng, 40, 128, 64)]
    b = t(rng.standard_normal(64).astype(np.float32))
    out = IM.int8_matmul(*args, out_dtype=torch.bfloat16)
    got = IM.int8_matmul(*args, out_dtype=torch.bfloat16, bias=b)
    assert torch.equal(got, out + b.to(torch.bfloat16))


def _packed(rng, K, N, w_sym):
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    if w_sym:
        d = np.abs(w).max(0, keepdims=True) / 127.0
        zp = np.zeros_like(d)
    else:
        lo = np.minimum(w.min(0, keepdims=True), 0)
        hi = np.maximum(w.max(0, keepdims=True), 0)
        d = (hi - lo) / 255.0
        zp = np.round(-lo / d)
    return jim.pack_weight(jnp.asarray(w), jnp.asarray(d), jnp.asarray(zp),
                           sym=w_sym)


@pytest.mark.parametrize("impl", ["pallas", "xla", "fused"])
@pytest.mark.parametrize("act_sym,w_sym", [(False, False), (False, True),
                                           (True, False), (True, True)],
                         ids=["asym-asym", "asym-sym", "sym-asym",
                              "sym-sym"])
def test_quantized_linear_native_matches_jax(act_sym, w_sym, impl):
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((2, 24, 128)) + 0.3).astype(np.float32)
    packed = _packed(rng, 128, 96, w_sym)
    bias = rng.standard_normal(96).astype(np.float32)
    with jax_kernel_path():
        want = np.asarray(jim.quantized_linear_native(
            jnp.asarray(x), packed, bias=jnp.asarray(bias), act_sym=act_sym,
            w_sym=w_sym, out_dtype=jnp.float32, impl=impl))
    _counters.reset()
    got = IM.quantized_linear_native(
        t(x), {k: t(np.asarray(v)) for k, v in packed.items()},
        bias=t(bias), act_sym=act_sym, w_sym=w_sym,
        out_dtype=torch.float32, impl=impl)
    assert got.shape == (2, 24, 96)
    assert rel_err(got.numpy(), want) < 1e-4
    assert all(c["launches"] == 0 for c in _counters.snapshot().values())


def test_quantized_linear_native_impls_are_one_dataflow():
    rng = np.random.default_rng(15)
    x = t(rng.standard_normal((48, 64)).astype(np.float32))
    packed = {k: t(np.asarray(v)) for k, v in
              _packed(rng, 64, 32, False).items()}
    outs = [IM.quantized_linear_native(x, packed, impl=impl)
            for impl in (None, "xla", "mixed", "pallas")]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    q = IM.dynamic_quant_rows(x)
    assert torch.equal(outs[0], IM.int8_matmul(
        q[0], packed["w_q"], *q[1:], packed["w_scale"], packed["w_zp"],
        packed["w_colsum"]))


@pytest.mark.parametrize("kw,err", [
    (dict(residual=torch.zeros(48, 32)), AssertionError),
    # the fused impl takes the residual: K5's epilogue (no rejection)
    (dict(impl="fused", residual=torch.ones(48, 32)), None),
    (dict(impl="triton"), ValueError),
], ids=["residual", "fused-residual", "unknown-impl"])
def test_quantized_linear_native_rejects(kw, err):
    rng = np.random.default_rng(16)
    x = t(rng.standard_normal((48, 64)).astype(np.float32))
    packed = {k: t(np.asarray(v)) for k, v in
              _packed(rng, 64, 32, False).items()}
    if err is None:
        got = IM.quantized_linear_native(x, packed, out_dtype=torch.float32,
                                         **kw)
        out = IM.quantized_linear_native(x, packed, out_dtype=torch.float32,
                                         impl="fused")
        assert torch.equal(got, out + kw["residual"])
        return
    with pytest.raises(err):
        IM.quantized_linear_native(x, packed, **kw)
