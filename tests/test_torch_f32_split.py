"""The float32 attention core's PV as three TF32 products
(csrc/attn_f32_core.cuh), emulated on the CPU (`attention_f32_emulation`,
`pv_tf32`): held against the JAX package's float32 attention on its kernel
path (the one-shot and streaming Pallas kernels in interpret mode, as
tests/test_torch_stream_f32.py runs them), on the same numpy inputs, full
and kv-masked, at tiny sizes and at [2, 1024, 4, 72].

The tolerance is the card's for the float32 modes, `chip_smoke.F32_REL_ERR`
(1e-5 relative): the split drops about 2^-21 of each product. One TF32
product (2^-11 of each) misses it, which is why the kernel takes three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from viditq_tpu.kernels import attention as jattn
from viditq_tpu_torch.kernels import attention as A
from test_torch_kernels import interp, rel_err, t

# (B, N, M, H, D), and the masked kv rows (batch row 1) of the masked form:
# at [2, 1024] rows 256-511 are kv tiles 4-7 masked whole, and the rows past
# 1000 a part of the last tile
CASES = {
    "tiny-D16": ((2, 128, 120, 4, 16), slice(100, None)),
    "tiny-stream": ((1, 256, jattn.ONESHOT_MAX_M + 256, 2, 72),
                    slice(300, None)),
    "1024": ((2, 1024, 1024, 4, 72), (slice(256, 512), slice(1000, None))),
}


def _inputs(shape, rows, masked, seed=31):
    B, N, M, H, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, M, H, D)).astype(np.float32)
            for _ in range(2))
    mask = None
    if masked:
        mask = np.ones((B, M), np.int32)
        for r in rows if isinstance(rows, tuple) else (rows,):
            mask[B - 1, r] = 0
    return q, k, v, mask


def _jax(q, k, v, mask):
    D = q.shape[-1]
    return interp(lambda q_, k_, v_: jattn.attention_bnhd(
        q_, k_, v_, D ** -0.5,
        kv_mask=None if mask is None else jnp.asarray(mask)),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _port(q, k, v, mask, products):
    D = q.shape[-1]
    return A.attention_f32_emulation(
        t(q), t(k), t(v), D ** -0.5, None if mask is None else t(mask),
        products=products)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask"])
@pytest.mark.parametrize("case", list(CASES))
def test_three_tf32_products_match_jax_f32_attention(case, masked):
    q, k, v, mask = _inputs(*CASES[case], masked)
    want = _jax(q, k, v, mask)
    got = _port(q, k, v, mask, 3)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert rel_err(got, want) < chip_smoke.F32_REL_ERR


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask"])
def test_one_tf32_product_misses_the_tolerance(masked):
    q, k, v, mask = _inputs(*CASES["1024"], masked)
    want = _jax(q, k, v, mask)
    assert rel_err(_port(q, k, v, mask, 1), want) > 10 * chip_smoke.F32_REL_ERR
    assert rel_err(_port(q, k, v, mask, 3), want) < chip_smoke.F32_REL_ERR


def test_split_is_exact_in_tf32_and_rounds_ties_away():
    # hi and lo carry 10 stored mantissa bits each; hi + lo recovers x to
    # 2^-21 of it; ties round away from zero (cvt.rna)
    x = torch.tensor(np.random.default_rng(5).standard_normal(4096),
                     dtype=torch.float32)
    hi, lo = A.split_tf32(x)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= x.double().abs() * 2.0 ** -21).all())
    ties = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -11])
    assert A.tf32_round(ties).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10),
                                           1 + 2 * 2 ** -10]
