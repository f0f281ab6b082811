"""K6's float32 mode (the float32 block of AdaRound reconstruction at kv
lengths above the one-shot range): the port's `attention_bnhd` on f32
tensors, forward and gradients, against `jax.grad` through the JAX
package's `attention_bnhd` (its streaming Pallas kernel in interpret mode
in the forward, its `custom_vjp` recompute in the backward), on the same
numpy inputs; and its dispatch on CPU tensors.

The shape is the streaming test's (tests/test_torch_stream.py): N = 256
q rows, M = 2304 kv rows, 2 heads of 72.

Tolerance 1e-5 relative for the output and each gradient: both packages
compute q.k on the same bf16-rounded operands and everything else in
float32 (no rounding to a coarser type on either side), summed in another
order (readings below 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viditq_tpu.kernels import attention as jattn
from viditq_tpu_torch.kernels import _counters
from viditq_tpu_torch.kernels import attention as A
from test_torch_kernels import interp, rel_err, t

B, H, D = 1, 2, 72
N, M = 256, jattn.ONESHOT_MAX_M + 256
F32_TOL = 1e-5


def _inputs(seed, masked):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, n, H, D)).astype(np.float32)
               for n in (N, M, M))
    g = rng.standard_normal((B, N, H, D)).astype(np.float32)
    mask = None
    if masked:
        # the later kv blocks masked whole: the m_safe guard
        mask = np.zeros((B, M), np.int32)
        mask[:, :300] = 1
    return q, k, v, g, mask


@pytest.mark.parametrize("masked", [False, True], ids=["full", "mask"])
def test_k6_f32_vjp_matches_jax_grad(masked):
    q, k, v, g, mask = _inputs(21, masked)
    jm = None if mask is None else jnp.asarray(mask)

    def jloss(q_, k_, v_):
        out = jattn.attention_bnhd(q_, k_, v_, D ** -0.5, kv_mask=jm)
        return jnp.sum(out * jnp.asarray(g)), out
    (_, want), jgrads = interp(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                  has_aux=True),
                               jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v))
    qkv = [t(a).requires_grad_() for a in (q, k, v)]
    _counters.reset()
    out = A.attention_bnhd(*qkv, D ** -0.5,
                           kv_mask=None if mask is None else t(mask))
    assert out.dtype == torch.float32 and out.requires_grad
    grads = torch.autograd.grad(out, qkv, t(g))
    assert rel_err(out.detach(), want) < F32_TOL
    for got, w in zip(grads, jgrads):
        assert got.shape == w.shape
        assert rel_err(got, w) < F32_TOL
    assert all(c["launches"] == 0 for c in _counters.snapshot().values())


def test_k6_f32_dispatch_on_cpu_runs_the_streaming_plain_version():
    # f32 CPU tensors at M > ONESHOT_MAX_M go to the streaming plain version
    # (under grad too, through the autograd function) and launch nothing
    q, k, v, _, _ = _inputs(22, False)
    calls = []
    orig = A.attention_bnhd_stream_plain
    _counters.reset()
    try:
        A.attention_bnhd_stream_plain = lambda *a, **kw: (
            calls.append((a[0].dtype, a[1].shape[1], a[4])) or orig(*a, **kw))
        A.attention_bnhd(t(q), t(k), t(v), D ** -0.5)
        qg = t(q).requires_grad_()
        A.attention_bnhd(qg, t(k), t(v), D ** -0.5).sum().backward()
        A.attention_bnhd(t(q), t(k[:, :2048]), t(v[:, :2048]), D ** -0.5)
    finally:
        A.attention_bnhd_stream_plain = orig
    bkv = A.stream_kv_block(N, M, H * D)
    assert calls == [(torch.float32, M, bkv)] * 2
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    snap = _counters.snapshot()
    assert all(c["launches"] == 0 and c["plain_cuda"] == 0
               for c in snap.values()), snap

