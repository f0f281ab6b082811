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
    pc, ps = A.attention_bnhd(t(q), t(k), t(v), D ** -0.5, kv_mask=t(mask),
                              int8_pv=int8_pv, emit=True)
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
