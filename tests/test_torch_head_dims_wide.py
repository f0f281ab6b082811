"""K3, K6, K8 and the float32 modes at the head dims above 128 that the
card's kernels instantiate (192 and 256: K3 full/masked and K6 split each
kv tile's scores and a head's output columns over the warpgroups of one
block of 64 q rows, K3 seg a head over two warps), against the JAX
package's kernels in interpret mode on the same numpy inputs, also at the
edges of that tiling (N = 200: a partial last q block; a kv range that
ends inside a tile; K6 over 17 kv blocks with one masked whole); the CUDA
wrappers' padding of the other dims in (128, 256] to them, and the raise
above 256, are held in tests/test_torch_head_dims.py; two tiny models
whose heads are that wide in tests/test_torch_wide_models.py.

Tolerances, each with its reason (tests/test_torch_head_dims.py's at the
narrower dims): K3 float outputs 1e-5 (float PV on float32 inputs: the
float32 mode's numerics, the same bf16-rounded q.k operands on both sides)
and 2e-3 (int8 PV: a softmax code may flip at a rounding tie); emitted
codes equal or off by one, their scales 2e-3 (int8 PV); the asym emission
within tests/test_torch_asym.py's row tolerances; K6 1e-3 (its online
softmax over 2304 kv rows, tests/test_torch_stream.py); K8 in float32 to
2.5e-7 (XLA's division).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_asym import check_rows
from test_torch_attn8 import _jax_headwise
from test_torch_kernels import assert_codes_close, interp, rel_err, t
from viditq_tpu.kernels import attention as jattn
from viditq_tpu_torch.kernels import attention as A

WIDE_DIMS = [192, 256]
H = 2


def _qkv(D, N, M, seed, heads=H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, n, heads, D)).astype(np.float32)
            for n in (N, M, M)]


def _j(a):
    return jnp.asarray(a)


def _mask(M):
    mask = np.ones((2, M), np.int32)
    mask[1, 17:] = 0
    return mask


# mode, q rows N, kv rows M: the _n200 modes put N = 200 (a partial last
# block of 64 q rows, and of 128), the masked one over kv 72 (a partial
# second kv tile)
K3_MODES = {"full": (128, 128), "seg": (128, 128), "mask": (128, 24),
            "full_n200": (200, 200), "mask_n200": (200, 72)}


@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("mode", list(K3_MODES))
def test_k3_at_wide_head_dim_matches_jax(D, mode):
    """Every K3 mode: the float PV and the int8 PV, the sym emission of the
    int8 PV and the asym emission with row sums."""
    N, M = K3_MODES[mode]
    q, k, v = _qkv(D, N, M, seed=D if N == 128 else D + N)
    seg = 16 if mode == "seg" else 0
    mask = _mask(M) if mode.startswith("mask") else None
    sc = D ** -0.5
    jm = None if mask is None else _j(mask)
    tm = None if mask is None else t(mask)
    for int8_pv in (False, True):
        want = interp(jattn.attention_bnhd, _j(q), _j(k), _j(v), scale=sc,
                      seg_len=seg, kv_mask=jm, int8_pv=int8_pv)
        got = A.attention_bnhd(t(q), t(k), t(v), sc, seg_len=seg,
                               kv_mask=tm, int8_pv=int8_pv)
        assert got.shape == want.shape
        assert rel_err(got, want) < (2e-3 if int8_pv else 1e-5)
    codes, scales, _, _ = interp(
        jattn.attention_bnhd_int8out, _j(q), _j(k), _j(v), scale=sc,
        seg_len=seg, kv_mask=jm, int8_pv=True)
    pc, ps, _, _ = A.attention_bnhd(t(q), t(k), t(v), sc, seg_len=seg,
                                    kv_mask=tm, int8_pv=True, emit=True)
    assert pc.shape == codes.shape == (2, N, H * D)
    assert_codes_close(pc, codes)
    np.testing.assert_allclose(ps.numpy(), scales, rtol=2e-3)
    v = v + 0.5  # outputs off zero: a real zero point
    want = interp(jattn.attention_bnhd_int8out, _j(q), _j(k), _j(v),
                  scale=sc, seg_len=seg, kv_mask=jm, emit_sym=False,
                  need_rowsum=True)
    got = A.attention_bnhd(t(q), t(k), t(v), sc, seg_len=seg, kv_mask=tm,
                           emit=True, emit_sym=False, need_rowsum=True)
    assert [g.shape for g in got] == [w.shape for w in want]
    check_rows([g.reshape(-1, g.shape[-1]) for g in got],
               [w.reshape(-1, w.shape[-1]) for w in want], scale_rtol=1e-5)


@pytest.mark.parametrize("D,masked", [
    pytest.param(192, False, id="192"), pytest.param(256, False, id="256"),
    pytest.param(192, True, id="192-kv2176-masked"),
    pytest.param(256, True, id="256-kv2176-masked")])
def test_k6_at_wide_head_dim_matches_jax(D, masked):
    """K6 (kv beyond the one-shot range) on one head, the float PV and the
    int8 PV: on one batch row over kv 2304 (9 blocks of 256); masked, on
    two over kv 2176, which K6 walks in 17 blocks of 128 (the kv block
    divides the kv length in both packages' rule, `stream_kv_block`), one
    of them masked whole in each row (the first block of row 1, so its
    running max starts at -inf, and the sixth of row 0)."""
    M = jattn.ONESHOT_MAX_M + (128 if masked else 256)
    q, k, v = _qkv(D, 256, M, seed=100 + D, heads=1)
    mask = None
    if masked:
        assert A.stream_kv_block(256, M, D) == 128
        mask = np.ones((2, M), np.int32)
        mask[0, 5 * 128:6 * 128] = 0
        mask[1, :128] = 0
        mask[1, 1000:1003] = 0
    else:
        q, k, v = q[:1], k[:1], v[:1]
    sc = D ** -0.5
    jm = None if mask is None else _j(mask)
    tm = None if mask is None else t(mask)
    for int8_pv in (False, True):
        want = interp(jattn.attention_bnhd, _j(q), _j(k), _j(v), sc,
                      kv_mask=jm, int8_pv=int8_pv)
        got = A.attention_bnhd(t(q), t(k), t(v), sc, kv_mask=tm,
                               int8_pv=int8_pv)
        assert got.shape == want.shape
        assert rel_err(got, want) < 1e-3


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_k3_bf16_at_wide_head_dim_matches_jax(D):
    """The bf16 modes on bf16 inputs (the probabilities rounded to bf16
    before the PV in both packages): full and seg, to 1e-2 (the output's
    bf16 rounding)."""
    q, k, v = _qkv(D, 128, 128, seed=200 + D)
    sc = D ** -0.5
    for seg in (0, 16):
        jb = [_j(a).astype(jnp.bfloat16) for a in (q, k, v)]
        want = interp(jattn.attention_bnhd, *jb, scale=sc, seg_len=seg)
        got = A.attention_bnhd(*(t(a).to(torch.bfloat16) for a in (q, k, v)),
                               sc, seg_len=seg)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert rel_err(got.float(), np.asarray(want, np.float32)) < 1e-2


@pytest.mark.parametrize("D", WIDE_DIMS)
def test_k8_at_wide_head_dim_matches_jax(D):
    rng = np.random.default_rng(D)
    q = (rng.standard_normal((2, 40, H, D)) * 3).astype(np.float32)
    k = (rng.standard_normal((2, 24, H, D)) * 0.5).astype(np.float32)
    pq, pk = A.qk_headwise_quant(t(q), t(k))
    for got, x in ((pq, q), (pk, k)):
        want = _jax_headwise(x, jnp.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)


def test_seg_tiled_takes_the_wide_heads_up_to_eight():
    """The tiled seg kernel's shape rule at the wide dims: a warp a half
    head, so H <= 8, odd H too; the row kernel takes the rest and needs
    one range statistic a 64-column part of a head."""
    for D in WIDE_DIMS:
        assert A.seg_tiled(8, 16, True, 256, D)
        assert A.seg_tiled(3, 16, False, None, D)
        assert not A.seg_tiled(9, 16, False, None, D)
        assert not A.seg_tiled(8, 32, False, None, D)
        assert A.seg_rows_parts(D) == D // 64
    assert not A.seg_tiled(2, 16, False, None, 128)
    assert A.seg_rows_parts(128) == 1
