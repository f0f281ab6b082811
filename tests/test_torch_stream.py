"""K6, the kv-streaming attention: the port's plain version (as it runs on
CPU tensors) against the JAX package's `_attn_stream_kernel` run in
interpret mode, on the same numpy inputs.

The shape is the JAX package's own streaming test (tests/
test_attention_kernel.py:158-163): N = 256 q rows, M = 2304 kv rows,
block 256, so 9 online-softmax steps.

Tolerances, each with its reason:
  * float outputs 1e-3 relative: both libraries compute the same
    recurrence in float32 but sum the scores, the row sums and the PV in
    another order; in the int8-PV mode a softmax code round(e*127) may
    flip by one when exp2 differs by an ulp at a rounding tie;
  * emission codes equal, or off by one at no more than 0.1% of entries
    (a float reduction precedes the round); scales to 2e-6 relative: a
    row's scale is its largest output over 127, and that output is itself
    a float32 sum over 2304 kv rows taken in another order (measured
    1.1e-6 at 2 of 256 rows in the bf16-PV mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viditq_tpu.kernels import attention as jattn
from viditq_tpu_torch.kernels import _counters
from viditq_tpu_torch.kernels import attention as A
from test_torch_kernels import assert_codes_close, interp, rel_err, t

B, H, D = 1, 2, 72
N, M = 256, jattn.ONESHOT_MAX_M + 256
FLOAT_TOL = 1e-3


def _inputs(seed=11, masked=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, n, H, D)).astype(np.float32)
               for n in (N, M, M))
    mask = None
    if masked:
        # fully masked later kv blocks exercise the m_safe guard
        mask = np.zeros((B, M), np.int32)
        mask[:, :300] = 1
    return q, k, v, mask


def _jax(fn, q, k, v, mask, **kw):
    return interp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  D ** -0.5, kv_mask=None if mask is None
                  else jnp.asarray(mask), **kw)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask"])
@pytest.mark.parametrize("int8_pv", [False, True], ids=["bf16_pv", "int8_pv"])
def test_k6_plain_matches_jax_stream_kernel(masked, int8_pv):
    q, k, v, mask = _inputs(masked=masked)
    want = _jax(jattn.attention_bnhd, q, k, v, mask, int8_pv=int8_pv)
    _counters.reset()
    got = A.attention_bnhd(t(q), t(k), t(v), D ** -0.5,
                           kv_mask=None if mask is None else t(mask),
                           int8_pv=int8_pv)
    assert got.shape == want.shape
    assert rel_err(got, want) < FLOAT_TOL
    # the dispatch took the streaming plain version, and launched nothing
    snap = _counters.snapshot()
    assert all(c["launches"] == 0 for c in snap.values()), snap


@pytest.mark.parametrize("int8_pv", [False, True], ids=["bf16_pv", "int8_pv"])
def test_k6_emission_matches_jax(int8_pv):
    q, k, v, mask = _inputs(seed=12, masked=True)
    codes, scales, zp, _ = _jax(jattn.attention_bnhd_int8out, q, k, v, mask,
                                int8_pv=int8_pv)
    assert zp is None
    pc, ps, _, _ = A.attention_bnhd(t(q), t(k), t(v), D ** -0.5,
                                    kv_mask=t(mask), int8_pv=int8_pv,
                                    emit=True)
    assert pc.shape == codes.shape and ps.shape == scales.shape
    assert_codes_close(pc, codes)
    np.testing.assert_allclose(ps.numpy(), scales, rtol=2e-6)


def test_k6_kv_block_changes_int8_numerics():
    # C3: the int8 codes round against the running max, so the kv block
    # enters the result: another block gives other codes
    q, k, v, _ = _inputs(seed=13)
    k[:, 1200:1300] *= 3.0  # row maxima that move between kv blocks
    want = _jax(jattn.attention_bnhd, q, k, v, None, int8_pv=True)
    args = (t(q), t(k), t(v), D ** -0.5)
    rule = A.attention_bnhd_stream(*args, int8_pv=True)
    other = A.attention_bnhd_stream(*args, int8_pv=True, bkv=768)
    assert rel_err(rule, want) < FLOAT_TOL
    assert rel_err(other, want) > 10 * rel_err(rule, want)


@pytest.mark.parametrize("n,m,c,v8", [
    (4096, 4096, 1152, False), (4096, 4096, 1152, True),
    (2304, 2304, 64, False), (256, 2304, 144, True), (4096, 4096, 1536,
                                                       False)])
def test_k6_kv_block_rule_matches_jax(n, m, c, v8):
    bq, bkv = jattn.select_stream_blocks(n, m, c, v_int8_in=v8)
    assert A.stream_kv_block(n, m, c, v_int8_in=v8) == bkv


def test_k6_kv_block_rule_main_path():
    assert A.stream_kv_block(4096, 4096, 1152) == 1024   # Σ-1024
    assert A.stream_kv_block(2304, 2304, 64) == 256      # tiny Σ
    with pytest.raises(ValueError):
        A.stream_kv_block(2304, 2300, 64)


def test_k6_dispatch_counts_stream_plain_version():
    # M > ONESHOT_MAX_M on CPU tensors goes to the streaming plain version,
    # M <= ONESHOT_MAX_M to the one-shot one (counted on CUDA tensors only,
    # so the CPU run is checked through the function that ran)
    q, k, v, _ = _inputs(seed=14)
    calls = []
    orig = A.attention_bnhd_stream_plain
    try:
        A.attention_bnhd_stream_plain = lambda *a, **kw: (
            calls.append(a[0].shape) or orig(*a, **kw))
        A.attention_bnhd(t(q), t(k), t(v), D ** -0.5)
        A.attention_bnhd(t(q), t(k[:, :2048]), t(v[:, :2048]), D ** -0.5)
    finally:
        A.attention_bnhd_stream_plain = orig
    assert calls == [torch.Size([B, N, H, D])]


def _k6_tiled(q, k, v, scale, bkv, mask, int8_pv):
    """K6 in the order the kernel runs it (csrc/attention_stream.cu): per
    kv block of bkv rows, pass 1 over KV_TILE-row tiles for the block's row
    max, pass 2 over the same tiles for e, its row sum and PV; bf16 PV adds
    the tiles' products to the corr-rescaled accumulator, int8 PV sums the
    s8 products of codes and transposed v codes (both in KV_PERM order)
    exactly per block."""
    B, N, H, D = q.shape
    M = k.shape[1]
    tile = A.KV_TILE
    qf = (q.float() * (scale * A.LOG2E)).to(torch.bfloat16).float()
    kf = k.float()
    perm = torch.tensor(A.KV_PERM)
    if int8_pv:
        vq, vs = A._v_quant(v.reshape(B, M, H * D), M)
        vt = A.v_codes_transposed(vq, H).long()          # [B, H, D, M]
        vsd = (vs * (1.0 / (127.0 * 127.0))).reshape(B, H, 1, D)
    m = torch.full((B, H, N, 1), float("-inf"))
    r = torch.zeros((B, H, N, 1))
    acc = torch.zeros((B, H, N, D))
    for j in range(0, M, bkv):
        tiles = range(j, j + bkv, tile)

        def scores(t0):
            s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, t0:t0 + tile])
            if mask is not None:
                s = s.masked_fill(mask[:, None, None, t0:t0 + tile] == 0,
                                  float("-inf"))
            return s
        bm = torch.full_like(m, float("-inf"))
        for t0 in tiles:
            bm = torch.maximum(bm, scores(t0).amax(dim=-1, keepdim=True))
        m_new = torch.maximum(m, bm)
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp2(m - m_safe)
        rs = torch.zeros_like(r)
        if not int8_pv:
            acc = acc * corr
        pvi = torch.zeros((B, H, N, D), dtype=torch.long)
        for t0 in tiles:
            e = torch.exp2(scores(t0) - m_safe)
            rs = rs + e.sum(dim=-1, keepdim=True)
            if int8_pv:
                codes = torch.round(e * 127.0).long()
                a = codes.reshape(B, H, N, tile // 32, 32)[..., perm]
                b = vt[..., t0:t0 + tile].reshape(B, H, D, tile // 32, 32)
                pvi += torch.einsum("bhnck,bhdck->bhnd", a, b)
            else:
                acc = acc + torch.einsum(
                    "bhnm,bmhd->bhnd", e.to(torch.bfloat16).float(),
                    v[:, t0:t0 + tile].float())
        if int8_pv:
            acc = acc * corr + pvi.float() * vsd
        r = r * corr + rs
        m = m_new
    o = acc * (1.0 / torch.clamp(r, min=1e-30))
    return o.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "block_masked"])
@pytest.mark.parametrize("int8_pv", [False, True], ids=["bf16_pv", "int8_pv"])
def test_k6_tile_schedule_matches_plain(masked, int8_pv):
    # the kernel's tile schedule (two passes of KV_TILE-row tiles per kv
    # block, the corr rescale folded into the bf16 accumulator, exact s8
    # block sums over the permuted operands) against the plain version's
    # whole-block recurrence; f32 sums in another order, bf16 outputs: at
    # most a few outputs one bf16 ulp (2^-8 relative) apart
    rng = np.random.default_rng(15)
    b, n, m, h, d, bkv = 2, 96, 512, 2, 16, 128
    q, k, v = (t(rng.standard_normal((b, x, h, d)).astype(np.float32))
               .to(torch.bfloat16) for x in (n, m, m))
    mask = None
    if masked:
        mask = torch.ones((b, m), dtype=torch.int32)
        mask[1, bkv:2 * bkv] = 0   # kv block 1 masked whole
        mask[0, 300:] = 0
    got = _k6_tiled(q, k, v, d ** -0.5, bkv, mask, int8_pv)
    want = A.attention_bnhd_stream_plain(q, k, v, d ** -0.5, bkv, mask,
                                         int8_pv)
    assert rel_err(got.float(), want.float()) < 2e-3


def test_k6_wrapper_takes_kv_blocks_of_whole_tiles():
    # the core's kv tile divides every stream_kv_block choice
    for n, m, c in ((4096, 4096, 1152), (2304, 2304, 64), (256, 2304, 144)):
        assert A.stream_kv_block(n, m, c) % A.KV_TILE == 0
