"""The port's kernels (plain versions, as they run on CPU tensors) against
the JAX package's Pallas kernels run in interpret mode — the same inputs,
made with numpy from a seed, through both packages.

Tolerances, each with its reason:
  * codes from identical float32 inputs with no float reduction before the
    round (K4, K5, K2's int32 accumulator) are equal;
  * where a float reduction precedes the round (K1's LayerNorm, K2's
    emission after tanh-GELU, K3's softmax sum and PV), the two libraries
    sum in another order, so codes may differ by 1 at no more than 0.1% of
    entries;
  * float32 outputs: 1e-6 relative where the arithmetic is the same
    elementwise sequence on exact integer sums (K2, K5); 1e-5 for K3's
    float softmax/PV (summation order); 2e-3 for K3's int8 PV, where a
    softmax code round(e*127) may flip by one when exp2 differs by an ulp
    at a rounding tie.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from viditq_tpu.kernels import attention as jattn
from viditq_tpu.kernels import fused_matmul as jfm
from viditq_tpu.kernels import int_matmul as jim
from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.kernels._common import k_major

CODE_FRAC = 1e-3


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_codes_close(got, want, exact=False):
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if exact:
        assert diff.max() == 0, diff.max()
        return
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= CODE_FRAC, (diff > 0).mean()


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def interp(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return jax.tree.map(np.asarray, fn(*args, **kw))


# the models' full width (C = 1152, the kernel's one-read layout) on 64 rows
@pytest.mark.parametrize("dtype,N,C", [("float32", 256, 64),
                                       ("bfloat16", 256, 64),
                                       ("bfloat16", 32, 1152)],
                         ids=["float32", "bfloat16", "bfloat16-C1152"])
def test_k1_ln_modulate_quantize(dtype, N, C):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, N, C)).astype(np.float32) * 2 + 0.3
    sh = rng.standard_normal((2, 1, C)).astype(np.float32) * 0.2
    sc = rng.standard_normal((2, 1, C)).astype(np.float32) * 0.2
    jd = jnp.dtype(dtype)
    jx, jsh, jsc = (jnp.asarray(a, jd) for a in (x, sh, sc))
    q, s, zp, rs = interp(jfm.ln_modulate_quantize, jx, jsh, jsc, sym=True,
                          need_rowsum=False, block_m=min(256, N))
    td = getattr(torch, dtype)
    pq, ps, _, _ = FM.ln_modulate_quantize(
        *(t(np.asarray(a, np.float32)).to(td) for a in (jx, jsh, jsc)))
    assert pq.shape == (2 * N, C) and pq.dtype == torch.int8
    assert_codes_close(pq, q)
    np.testing.assert_allclose(ps.numpy(), s, rtol=1e-5)


def test_k4_quantize_rows_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((96, 128)).astype(np.float32) * 3
    x[5] = 0.0  # all-zero row: the 1e-6 scale floor
    q, s, zp, rs = interp(jfm.quantize_rows_fused, jnp.asarray(x), sym=True,
                          need_rowsum=False)
    pq, ps, _, _ = FM.quantize_rows(t(x))
    assert_codes_close(pq, q, exact=True)
    # XLA on the CPU evaluates absmax / 127 as a multiply by the constant's
    # reciprocal (one ulp apart at some rows); the port divides, as the
    # kernel is written
    np.testing.assert_allclose(ps.numpy(), s, rtol=2.5e-7, atol=0)


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


# the weight as the CUDA kernels take it (K-major: a [K, N] view of [N, K]
# storage, QuantLinear.w_int's layout) and as a row-major copy; the plain
# versions give identical results on both
LAYOUTS = {"row-major": lambda w: w, "k-major": k_major}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_k2_consumer_plain(layout):
    rng = np.random.default_rng(2)
    M, K, N = 64, 256, 192
    xq, w = _i8(rng, (M, K)), _i8(rng, (K, N))
    xs = rng.uniform(1e-3, 2e-2, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    want = interp(jfm.int8_consumer_matmul, jnp.asarray(xq), jnp.asarray(xs),
                  jnp.asarray(w), jnp.asarray(ws), bias=jnp.asarray(b),
                  out_dtype=jnp.float32)
    got = FM.int8_consumer_matmul(t(xq), t(xs), LAYOUTS[layout](t(w)), t(ws),
                                  t(b), out_dtype=torch.float32)
    assert rel_err(got, want) < 1e-6
    assert torch.equal(got, FM.int8_consumer_matmul(
        t(xq), t(xs), t(w), t(ws), t(b), out_dtype=torch.float32))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_k2_consumer_emit_three_groups(layout):
    # fc1's shape class: K=1152 -> N=4608 emits G=3 groups of 1536 (C1)
    rng = np.random.default_rng(3)
    M, K, N = 16, 1152, 4608
    xq, w = _i8(rng, (M, K)), _i8(rng, (K, N))
    xs = rng.uniform(1e-3, 2e-2, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) * 0.1
    codes, scales = interp(jfm.int8_consumer_matmul, jnp.asarray(xq),
                           jnp.asarray(xs), jnp.asarray(w), jnp.asarray(ws),
                           bias=jnp.asarray(b), emit={"gelu": True})
    pc, pscale = FM.int8_consumer_matmul(t(xq), t(xs), LAYOUTS[layout](t(w)),
                                         t(ws), t(b), emit={"gelu": True})
    rc, rscale = FM.int8_consumer_matmul(t(xq), t(xs), t(w), t(ws), t(b),
                                         emit={"gelu": True})
    assert torch.equal(pc, rc) and torch.equal(pscale, rscale)
    assert pscale.shape == (M, 3) and scales.shape == (M, 3 * 128)
    # the TPU layout pads each group's scale across 128 lanes
    np.testing.assert_allclose(pscale.numpy(), scales[:, ::128], rtol=1e-6)
    assert_codes_close(pc, codes)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_k2_consumer_group_wise_x(layout):
    # fc2's shape class: K=4608 in 3 groups of 1536 with one scale each
    rng = np.random.default_rng(4)
    M, K, N, G = 16, 4608, 128, 3
    xq, w = _i8(rng, (M, K)), _i8(rng, (K, N))
    xs = rng.uniform(1e-3, 2e-2, (M, G)).astype(np.float32)
    ws = rng.uniform(1e-5, 1e-4, (1, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    want = interp(jfm.int8_consumer_matmul, jnp.asarray(xq),
                  jnp.asarray(np.repeat(xs, 128, axis=1)), jnp.asarray(w),
                  jnp.asarray(ws), bias=jnp.asarray(b),
                  out_dtype=jnp.float32)
    got = FM.int8_consumer_matmul(t(xq), t(xs), LAYOUTS[layout](t(w)), t(ws),
                                  t(b), out_dtype=torch.float32,
                                  group_scales=True)
    assert rel_err(got, want) < 1e-6
    assert torch.equal(got, FM.int8_consumer_matmul(
        t(xq), t(xs), t(w), t(ws), t(b), out_dtype=torch.float32,
        group_scales=True))


@pytest.mark.parametrize("sym", [True, False])
def test_int8_oracles_match_jax(sym):
    # pack_weight / dynamic_quant_rows_plain / int8_matmul_plain: the
    # round(x/s) oracle form; codes and integer sums exact, floats to
    # rounding
    rng = np.random.default_rng(10)
    w = rng.standard_normal((96, 64)).astype(np.float32) * 0.1
    d = np.abs(w).max(0, keepdims=True) / (127.0 if sym else 255.0)
    zp = np.zeros_like(d) if sym else np.round(-w.min(0, keepdims=True) / d)
    jp = jim.pack_weight(jnp.asarray(w), jnp.asarray(d), jnp.asarray(zp),
                         sym=sym)
    pp = IM.pack_weight(t(w), t(d), t(zp), sym=sym)
    for k in ("w_q", "w_zp", "w_colsum"):
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
    x = rng.standard_normal((32, 96)).astype(np.float32)
    jq = jim.dynamic_quant_rows_ref(jnp.asarray(x), sym=sym)
    pq = IM.dynamic_quant_rows_plain(t(x), sym=sym)
    for a, b in zip(pq, jq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.5e-7)
    want = jim.int8_matmul_ref(jq[0], jp["w_q"], *jq[1:], jp["w_scale"],
                               jp["w_zp"], jp["w_colsum"])
    got = IM.int8_matmul_plain(pq[0], pp["w_q"], *pq[1:], pp["w_scale"],
                               pp["w_zp"], pp["w_colsum"], torch.float32)
    assert rel_err(got, want) < 1e-6


@pytest.mark.parametrize("M", [240, 64])
def test_k5_fused_dynq_matmul(M):
    # M=240: the kv_linear row count (2 x 120 prompt tokens)
    rng = np.random.default_rng(5)
    K, N = 128, 256
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = _i8(rng, (K, N))
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    zeros = jnp.zeros((1, N), jnp.float32)
    want = interp(jfm.fused_dynq_int8_matmul, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(ws), zeros, zeros, sym=True, sym_w=True,
                  bias=jnp.asarray(b), out_dtype=jnp.float32)
    got = FM.fused_dynq_int8_matmul(t(x), t(w), t(ws), t(b),
                                    out_dtype=torch.float32)
    assert rel_err(got, want) < 1e-6


def _attn_inputs(mode, H, D, seed):
    rng = np.random.default_rng(seed)
    B = 2
    N = 512 if mode == "seg" else 128
    M = 24 if mode == "mask" else N
    q = rng.standard_normal((B, N, H, D)).astype(np.float32)
    k = rng.standard_normal((B, M, H, D)).astype(np.float32)
    v = rng.standard_normal((B, M, H, D)).astype(np.float32)
    mask = None
    if mode == "mask":
        mask = np.ones((B, M), np.int32)
        mask[1, 17:] = 0  # a padded prompt; its padded v rows still count
    return q, k, v, (4 if mode == "seg" else 0), mask


@pytest.mark.parametrize("mode", ["seg", "full", "mask"])
@pytest.mark.parametrize("int8_pv", [False, True])
@pytest.mark.parametrize("emit", [False, True])
def test_k3_attention(mode, int8_pv, emit):
    H, D = 2, 16
    q, k, v, seg, mask = _attn_inputs(mode, H, D, seed=6)
    scale = D ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tm = None if mask is None else t(mask)
    targs = (t(q), t(k), t(v))
    if emit:
        codes, scales, _, _ = interp(
            jattn.attention_bnhd_int8out, *jargs, scale=scale, seg_len=seg,
            kv_mask=jm, int8_pv=int8_pv)
        pc, ps, _, _ = A.attention_bnhd(*targs, scale, seg_len=seg,
                                        kv_mask=tm, int8_pv=int8_pv,
                                        emit=True)
        assert pc.shape == codes.shape and ps.shape == scales.shape
        assert_codes_close(pc, codes)
        np.testing.assert_allclose(ps.numpy(), scales,
                                   rtol=2e-3 if int8_pv else 1e-5)
        return
    want = interp(jattn.attention_bnhd, *jargs, scale=scale, seg_len=seg,
                  kv_mask=jm, int8_pv=int8_pv)
    got = A.attention_bnhd(*targs, scale, seg_len=seg, kv_mask=tm,
                           int8_pv=int8_pv)
    assert got.shape == want.shape
    assert rel_err(got, want) < (2e-3 if int8_pv else 1e-5)


@pytest.mark.parametrize("int8_pv", [False, True])
def test_k3_attention_head_dim_72(int8_pv):
    # STDiT-XL's head dim: neither a power of two nor a multiple of 16
    q, k, v, seg, mask = _attn_inputs("mask", 2, 72, seed=7)
    scale = 72 ** -0.5
    codes, scales, _, _ = interp(
        jattn.attention_bnhd_int8out, jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v), scale=scale, kv_mask=jnp.asarray(mask),
        int8_pv=int8_pv)
    pc, ps, _, _ = A.attention_bnhd(t(q), t(k), t(v), scale,
                                    kv_mask=t(mask), int8_pv=int8_pv,
                                    emit=True)
    assert_codes_close(pc, codes)
    np.testing.assert_allclose(ps.numpy(), scales, rtol=2e-3)


@pytest.mark.parametrize("n,seg", [(16384, 16), (512, 4), (96, 16),
                                   (320, 16), (48, 48)])
def test_k3_v_group_rule_matches_tpu_block_choice(n, seg):
    # C2: the seg-mode v scales are per (q-block x channel); the port's
    # explicit group is the JAX kernel's block_q rule
    assert A.seg_v_block(n, seg) == jattn.select_block_q(n, seg)


def test_k3_v_group_changes_numerics():
    # the group really enters the result: at N=512 the JAX kernel uses two
    # v groups of 256; one group over all 512 tokens gives other codes
    q, k, v, seg, _ = _attn_inputs("seg", 2, 16, seed=8)
    v[:, :256] *= 4.0  # different absmax in the two groups
    jout = interp(jattn.attention_bnhd, jnp.asarray(q), jnp.asarray(k),
                  jnp.asarray(v), scale=0.25, seg_len=seg, int8_pv=True)
    rule = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg,
                            int8_pv=True)
    one_group = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg,
                                 int8_pv=True, v_block=512)
    assert rel_err(rule, jout) < 2e-3
    assert rel_err(one_group, jout) > 10 * rel_err(rule, jout)


def test_k3_plain_matches_port_oracle():
    # the int8-PV oracle (exp, no bf16 score cast) against the plain
    # version: same quantization math, differing only by the kernel's bf16
    # q/k casts
    q, k, v, seg, _ = _attn_inputs("seg", 2, 16, seed=9)
    vb = A.seg_v_block(q.shape[1], seg)
    want = A.attention_bnhd_xla_quant(t(q), t(k), t(v), 0.25, seg_len=seg,
                                      int8_pv=True, v_block=vb)
    jwant = jattn.attention_bnhd_xla_quant(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25, seg_len=seg,
        int8_pv=True, v_block=vb)
    got = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg, int8_pv=True)
    assert rel_err(want, np.asarray(jwant)) < 2e-3
    assert rel_err(got, want) < 2e-2


def test_kv_perm_is_the_s8_fragment_order():
    # k index 4*t4 + j (+16) of the s8 wgmma's register operand, packed
    # from the score registers, holds score column {2t4, 2t4+1, 8+2t4,
    # 9+2t4}[j] (+16) of its 32-row chunk; csrc/attention.cu's kv_perm
    # writes v^T in the same order
    want = [half * 16 + (2 * t4, 2 * t4 + 1, 8 + 2 * t4, 9 + 2 * t4)[j]
            for half in (0, 1) for t4 in range(4) for j in range(4)]
    assert list(A.KV_PERM) == want
    src = (_build.CSRC / "attention.cu").read_text()
    assert ("(k >> 4) * 16 + ((k & 3) >> 1) * 8 + ((k & 15) >> 2) * 2 + "
            "(k & 1)") in src
    assert [(k >> 4) * 16 + ((k & 3) >> 1) * 8 + ((k & 15) >> 2) * 2
            + (k & 1) for k in range(32)] == want


@pytest.mark.parametrize("m", [24, 64, 120, 300, 1000])
def test_v_codes_transposed_layout(m):
    # the full modes' v codes: [B, H, D, Mp] per head, kv rows of each
    # 32-row chunk in KV_PERM order, zero past M
    rng = np.random.default_rng(20)
    B, H, D = 2, 3, 16
    vq = rng.integers(-127, 128, (B, m, H * D)).astype(np.float32)
    vt = A.v_codes_transposed(t(vq), H).numpy()
    mp = A.kv_padded(m)
    assert mp % A.KV_TILE == 0 and m <= mp < m + A.KV_TILE
    assert vt.shape == (B, H, D, mp) and vt.dtype == np.int8
    padded = np.zeros((B, mp, H, D), np.int8)
    padded[:, :m] = vq.reshape(B, m, H, D)
    rows = (np.arange(mp) // 32) * 32 + np.asarray(A.KV_PERM)[np.arange(mp)
                                                             % 32]
    np.testing.assert_array_equal(vt, padded[:, rows].transpose(0, 2, 3, 1))


def test_int8_pv_from_permuted_operands_equals_plain_sum():
    # the s8 product of the kernels: byte k of a 32-row chunk of the
    # register operand (codes from the score layout) against byte k of v^T;
    # with both in KV_PERM order it is the plain int8 PV sum, exactly
    rng = np.random.default_rng(21)
    rows, m, H, D = 16, 120, 2, 72
    codes = rng.integers(0, 128, (rows, m)).astype(np.int64)
    vq = rng.integers(-127, 128, (1, m, H * D)).astype(np.float32)
    vt = A.v_codes_transposed(t(vq), H).numpy()[0].astype(np.int64)
    mp = vt.shape[-1]
    a = np.zeros((rows, mp), np.int64)
    a[:, :m] = codes
    a = a.reshape(rows, mp // 32, 32)[:, :, list(A.KV_PERM)].reshape(rows, mp)
    for h in range(H):
        want = codes @ vq[0, :, h * D:(h + 1) * D].astype(np.int64)
        np.testing.assert_array_equal(a @ vt[h].T, want)
