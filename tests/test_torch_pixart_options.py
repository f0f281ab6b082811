"""PixArt's model options (`micro_condition`, `qk_norm`, the KV-compress
samplings 'ave' and 'uniform_every') in the port against the JAX package,
on bridged weights (tests/torch_parity.py), fp and under the sm8 plan
(the kernel path: the JAX side in Pallas interpret mode, the port's plain
versions).

The model is the tiny Σ at a 32x32 latent: 256 tokens, so block 0's
self-attention runs K3 one-shot in both packages, and block 1 compresses
its k/v with the 'conv' sampling; the sampling cases run one block that
compresses with the sampling under test. Its width is 48 in 3 heads of 16:
the micro-condition embeds the image size and the aspect ratio in C // 3
channels each, three thirds in all, so C must divide by 3.

Tolerances as in tests/test_torch_sigma.py, for the same reasons: fp 1e-4
relative (both packages in float32, summed in another order); sm8 1e-2
(the int8 layers turn ulp differences of the two libraries into code
flips).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SM8, build_jax, build_port, data_info, inputs,
                          jax_kernel_path, rel_err)
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.models import layers
from viditq_tpu_torch.quant.qlinear import QuantCtx

FP_TOL = 1e-4
SM8_TOL = 1e-2
SIZE = dict(input_size=32, hidden_size=48, num_heads=3)
CASES = {
    "micro_condition": dict(micro_condition=True),
    "qk_norm": dict(qk_norm=True),
    "ave_r2": dict(kv_compress_sampling="ave", kv_compress_scale=2),
    # a 16x16 grid to 5x5: rows 1, 4, 8, 11, 14 (r does not divide it)
    "ave_r3": dict(kv_compress_sampling="ave", kv_compress_scale=3),
    "uniform_every": dict(kv_compress_sampling="uniform_every",
                          kv_compress_scale=2),
}
# the sampling cases need only the compressing block
ONE_BLOCK = dict(depth=1, kv_compress_layers=(0,))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("case", list(CASES))
def test_pixart_option_matches_jax(case):
    kw = {**SIZE, **CASES[case]}
    if "kv_compress_sampling" in kw:
        kw.update(ONE_BLOCK)
    jmodel, jv = build_jax(SM8, kind="sigma", **kw)
    port = build_port(SM8, jv, kind="sigma", **kw)
    x, t, y, mask = inputs(kind="sigma")
    x = x[..., :32, :32]
    info = data_info(2) if kw.get("micro_condition") else None
    if kw.get("qk_norm"):
        # the norms' scale and bias drawn like every parameter: not 1 and 0
        assert not np.allclose(
            jv["params"]["blocks_0"]["attn"]["q_norm"]["scale"], 1.0)
    for quant in (False, True):
        with jax_kernel_path():
            want = np.asarray(jax.jit(
                lambda x, t, y, m: jmodel.apply(
                    jv, x, t, y, m, data_info=info,
                    qctx=JQuantCtx(mode="quant") if quant else None))(
                        x, t, y, mask))
        with torch.no_grad():
            got = port(_t(x), _t(t), _t(y), _t(mask),
                       qctx=QuantCtx(mode="quant") if quant else None,
                       data_info=info).numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        err = rel_err(got, want)
        assert err < (SM8_TOL if quant else FP_TOL), (case, quant, err)


@pytest.mark.parametrize("size,r", [(8, 2), (6, 3), (16, 3), (12, 4),
                                    (48, 2)])
def test_ave_keeps_the_grid_points_of_jax_resize(size, r):
    # 'ave' is jax.image.resize(..., "nearest"): at r = 2 it keeps rows and
    # columns 1, 3, 5, 7 of 8, at r = 3 rows 1 and 4 of 6 (r * i + r // 2)
    grid = np.arange(size * size, dtype=np.float32).reshape(1, size, size, 1)
    n = size // r
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (1, n, n, 1),
                                       "nearest"))
    idx = layers.nearest_index(size, n)
    if size % r == 0:
        assert idx.tolist() == [r * i + r // 2 for i in range(n)]
    att = layers.KVCompressSelfAttention(1, 1, "ave", r, dtype=torch.float32)
    got = att._downsample(_t(grid).reshape(1, size * size, 1), size, size,
                          None)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # not what torch's own "nearest" interpolation keeps (rows 0, r, ...)
    naive = torch.nn.functional.interpolate(
        _t(grid).permute(0, 3, 1, 2), size=(n, n), mode="nearest")
    assert not np.array_equal(naive.permute(0, 2, 3, 1).numpy(), want)
