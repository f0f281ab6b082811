"""K3, K6 and K8 at the head dims the card's kernels take
(16, 32, 64, 72, 128, 192 and 256 instantiated; any other D up to 256
padded with zero channels to the next of them), against the JAX package's
kernels in interpret mode on the same numpy inputs: D = 32, 64, 128 and the
padded 40 (192 and 256: tests/test_torch_head_dims_wide.py). The port's
plain versions run at the true D (the card holds each kernel to them,
chip_smoke.py `head_dim_cases`); the CUDA wrappers' padding itself is
checked here by intercepting the launch (no card), up to 256 and the
raises above it. Then DiT-L/2's head
dim on a model: a tiny DiT of 2 blocks, hidden 128, 2 heads of 64, fp and
sm8 forwards against JAX's on its kernel path.

Tolerances, each with its reason: K3 float outputs 1e-5 (bf16 PV) and
2e-3 (int8 PV: a softmax code may flip at a rounding tie), as
tests/test_torch_kernels.py holds them at D = 16 and 72; K6 1e-3 (its
online softmax over 2304 kv rows, tests/test_torch_stream.py); emitted
codes equal or off by one, their scales 2e-3 (int8 PV); K8 in float32
to 2.5e-7 (tests/test_torch_attn8.py: XLA's division); the DiT forwards
1e-4 fp, 1e-2 sm8 (PERF.md §2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attn8 import _jax_headwise
from test_torch_kernels import assert_codes_close, interp, rel_err, t
from test_torch_rules import _OnCard
from torch_parity import SM8, build_jax, build_port, inputs, jax_kernel_path
from viditq_tpu.kernels import attention as jattn
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.quant.qlinear import QuantCtx

HEAD_DIMS = [32, 40, 64, 128]
H = 2


def _qkv(D, N, M, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, n, H, D)).astype(np.float32)
            for n in (N, M, M)]


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("mode", ["full", "seg", "mask"])
def test_k3_at_head_dim_matches_jax(D, mode):
    N = 128
    q, k, v = _qkv(D, N, 24 if mode == "mask" else N, seed=D)
    seg = 16 if mode == "seg" else 0
    mask = None
    if mode == "mask":
        mask = np.ones((2, 24), np.int32)
        mask[1, 17:] = 0
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


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k6_at_head_dim_matches_jax(D):
    q, k, v = _qkv(D, 256, jattn.ONESHOT_MAX_M + 256, seed=100 + D)
    q = q[:1]
    k, v = k[:1], v[:1]
    sc = D ** -0.5
    for int8_pv in (False, True):
        want = interp(jattn.attention_bnhd, _j(q), _j(k), _j(v), sc,
                      int8_pv=int8_pv)
        got = A.attention_bnhd(t(q), t(k), t(v), sc, int8_pv=int8_pv)
        assert got.shape == want.shape
        assert rel_err(got, want) < 1e-3


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_k8_at_head_dim_matches_jax(D):
    rng = np.random.default_rng(D)
    q = (rng.standard_normal((2, 40, H, D)) * 3).astype(np.float32)
    k = (rng.standard_normal((2, 24, H, D)) * 0.5).astype(np.float32)
    pq, pk = A.qk_headwise_quant(t(q), t(k))
    for got, x in ((pq, q), (pk, k)):
        want = _jax_headwise(x, jnp.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)


class _Launched(Exception):
    pass


@pytest.fixture
def widths(monkeypatch):
    """The [B, N, C] width each CUDA attention path hands its kernel: the
    first `_aligned` call of a path (q, as the kernel reads it) is
    recorded and stops the call before any device allocation."""
    seen = []

    def aligned(x):
        seen.append(x.shape[-1])
        raise _Launched()
    monkeypatch.setattr(A, "_aligned", aligned)
    return seen


@pytest.mark.parametrize("D,Dp", [(40, 64), (24, 32), (100, 128),
                                  (8, 16), (136, 192), (200, 256)])
def test_cuda_attention_pads_other_head_dims(widths, D, Dp):
    """A CUDA call at a head dim the kernels do not instantiate reaches its
    kernel's operands at the next instantiated one, in every mode (K3 full
    and seg, K6, the float32 modes); H * D above JAX's gate, D above the
    widest instantiation (256) and padded heads above the gate refuse."""
    def card(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype).as_subclass(_OnCard)
    H4 = 4
    for kw in ({}, dict(seg_len=16, emit=True), dict(int8_pv=True)):
        q = card(2, 256, H4, D)
        with pytest.raises(_Launched):
            A.attention_bnhd(q, q, q, 0.1, **kw)
        assert widths[-1] == H4 * Dp, kw
    big = card(1, 2304 + 256, H4, D)
    with pytest.raises(_Launched):
        A.attention_bnhd(big, big, big, 0.1)
    assert widths[-1] == H4 * Dp
    for n in (256, 2304 + 256):
        f32 = card(1, n, H4, D, dtype=torch.float32)
        with pytest.raises(_Launched):
            A.attention_bnhd(f32, f32, f32, 0.1)
        assert widths[-1] == H4 * Dp
    with pytest.raises(ValueError, match="JAX's gate"):  # 17 * 121 > 2048
        A.attention_bnhd(card(2, 256, 17, 121), card(2, 256, 17, 121),
                         card(2, 256, 17, 121), 0.1)
    with pytest.raises(ValueError, match="D <= 256"):
        A.attention_bnhd(card(2, 256, 1, 264), card(2, 256, 1, 264),
                         card(2, 256, 1, 264), 0.1)
    with pytest.raises(ValueError, match="pads to 256"):  # 10 * 256 > 2048
        A.attention_bnhd(card(2, 256, 10, 200), card(2, 256, 10, 200),
                         card(2, 256, 10, 200), 0.1)


def test_padded_heads_emission_drops_the_pad_from_row_sums():
    """`_padded_heads` on the plain version (run at the padded D, as the
    card's kernels do) equals the plain version at the true D: the outputs
    sliced, the asym codes and scales unchanged, the row sums without the
    pad's zero-point codes; the column scales padded with zeros."""
    rng = np.random.default_rng(3)
    B, N, D = 2, 128, 40
    q, k, v = (t(rng.standard_normal((B, N, H, D)).astype(np.float32))
               for _ in range(3))
    cs = t(rng.uniform(0.5, 2.0, H * D).astype(np.float32))
    kw = dict(emit=True, emit_sym=False, need_rowsum=True)

    def plain(q_, k_, v_, cs_):
        return A.attention_bnhd_plain(q_, k_, v_, 0.15, col_scale=cs_, **kw)
    got = A._padded_heads(plain, q, k, v, cs, emit=True, emit_sym=False)
    want = plain(q, k, v, cs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out = A._padded_heads(
        lambda q_, k_, v_, cs_: A.attention_bnhd_plain(q_, k_, v_, 0.15),
        q, k, v)
    assert torch.equal(out, A.attention_bnhd_plain(q, k, v, 0.15))


# DiT-L/2's head dim on a model: the tiny DiT's 2 blocks at hidden 128 in
# 2 heads of 64
TINY_DIT_L = dict(hidden_size=128, num_heads=2)


@pytest.fixture(scope="module")
def dit64():
    jmodel, jv = build_jax(SM8, kind="dit", **TINY_DIT_L)
    return jmodel, jv, build_port(SM8, jv, kind="dit", **TINY_DIT_L)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "sm8"])
def test_dit_head_dim_64_forward_matches_jax(dit64, quant):
    jmodel, jv, port = dit64
    assert port.blocks[0].attn.head_dim == 64
    x, tt, y, mask = inputs(kind="dit")
    mode = "quant" if quant else "fp"
    with jax_kernel_path():
        want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
            v, *a, qctx=JQuantCtx(mode=mode, t_id=500)))(jv, x, tt, y, mask))
    with torch.no_grad():
        got = port(t(x), t(tt), t(y), t(mask), qctx=QuantCtx(
            mode=mode, t_id=500)).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < (1e-2 if quant else 1e-4)
