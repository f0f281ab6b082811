"""The attn8 plan (`configs/opensora/w8a8_tpu_fused_attn8.yaml`: the sm8 plan
plus the reference's per-token int8 q/k quantizers at every attention site)
in the port, as it runs on CPU tensors, against the JAX package's kernel
path (Pallas interpret mode): K8's plain version (`qk_headwise_quant`)
against `_fake_quant_tokens_headwise`, `attention_bnhd(int8_qk=True)` in
its full, kv-masked, seg and kv-streaming modes with and without the
emission, the int8 oracle, and a tiny STDiT under the plan.

Tolerances, each with its reason:
  * K8: XLA on the CPU evaluates `sc / 127` as a multiply by the
    reciprocal, one rounding away from the true division the port (and
    the CUDA kernel) performs, so a dequantized value may differ by one
    ulp of its type: float32 values to 2.5e-7 relative, bfloat16 values
    equal or one bf16 step apart at no more than 0.1% of the entries;
  * attention: those one-ulp differences of q and k, and the softmax sums
    taken in another order, are what `tests/test_torch_kernels.py` already
    allows K3 with int8 PV: 2e-3 relative (a softmax code round(e*127)
    may flip at a rounding tie), codes equal or one off at no more than
    0.1% of entries, scales 2e-3; the kv-streaming mode 1e-3
    (`tests/test_torch_stream.py`);
  * the tiny STDiT: forward 1e-2 and 2-step CFG DDIM denoise 2e-2, the sm8
    limits (`tests/test_torch_stdit.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import assert_codes_close, interp, rel_err, t
from torch_parity import build_jax, build_port, inputs, jax_kernel_path
from viditq_tpu.kernels import attention as jattn
from viditq_tpu.pipelines.inference import quant_sample as j_quant_sample
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.samplers import IDDPM as JIDDPM
from viditq_tpu_torch.kernels import _counters
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.models.layers import (_exec_flags, attn_emit_int8_ok)
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.quant.qlinear import QuantCtx
from viditq_tpu_torch.samplers.iddpm import IDDPM

ATTN8 = "configs/opensora/w8a8_tpu_fused_attn8.yaml"
FWD_TOL = 1e-2
DENOISE_TOL = 2e-2
ULP_FRAC = 1e-3


def _jax_headwise(x, dtype):
    B, N, H, D = x.shape
    return np.asarray(jattn._fake_quant_tokens_headwise(
        jnp.asarray(x.reshape(B, N, H * D), dtype), B, N, H, D).astype(
            jnp.float32)).reshape(x.shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 4, 16), (2, 40, 2, 72)],
                         ids=["D16", "D72"])
def test_k8_plain_matches_jax_headwise_quant(dtype, shape):
    rng = np.random.default_rng(20)
    q = (rng.standard_normal(shape) * 3).astype(np.float32)
    k = (rng.standard_normal((shape[0], 24, *shape[2:])) * 0.5).astype(
        np.float32)
    k[0, 3] = 0.0  # a zero row: the 1e-6 floor
    td = getattr(torch, dtype)
    _counters.reset()
    pq, pk = A.qk_headwise_quant(t(q).to(td), t(k).to(td))
    assert pq.dtype == td and pk.shape == k.shape
    assert all(c["launches"] == 0 for c in _counters.snapshot().values())
    for got, x in ((pq, q), (pk, k)):
        want = _jax_headwise(x, jnp.dtype(dtype))
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)
        else:
            # one bf16 step apart at most, and rarely
            step = np.abs(want) * 2.0 ** -7
            diff = np.abs(got - want)
            assert np.all(diff <= step + 1e-30)
            assert (diff > 0).mean() <= ULP_FRAC
    # a zero row stays zero (its scale is the 1e-6 floor)
    assert float(pk[0, 3].abs().max()) == 0.0


def test_k8_plain_is_the_oracles_quantizer():
    # the oracle's q/k quantizer (kept in f32, as JAX's) and K8's plain
    # version give the same values on f32 inputs
    rng = np.random.default_rng(21)
    q = t(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    k = t(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    v = t(rng.standard_normal((2, 16, 2, 16)).astype(np.float32))
    qd, kd = A.qk_headwise_quant_plain(q, k)
    want = A.attention_bnhd_xla(qd, kd, v, 0.25)
    got = A.attention_bnhd_xla_quant(q, k, v, 0.25, int8_qk=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("int8_pv", [False, True], ids=["bf16_pv", "int8_pv"])
@pytest.mark.parametrize("seg", [0, 4], ids=["full", "seg"])
def test_oracle_int8_qk_matches_jax(seg, int8_pv):
    rng = np.random.default_rng(22)
    q, k, v = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = jattn.attention_bnhd_xla_quant(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25, seg_len=seg,
        int8_qk=True, int8_pv=int8_pv, v_block=32 if seg else None)
    got = A.attention_bnhd_xla_quant(t(q), t(k), t(v), 0.25, seg_len=seg,
                                     int8_qk=True, int8_pv=int8_pv,
                                     v_block=32 if seg else None)
    assert rel_err(got, np.asarray(want)) < 2e-3


def _attn_inputs(mode, seed):
    rng = np.random.default_rng(seed)
    B, H = 2 if mode != "stream" else 1, 2
    D = 72 if mode == "stream" else 16
    N = {"seg": 512, "stream": 256}.get(mode, 128)
    M = {"mask": 24, "seg": 512, "stream": jattn.ONESHOT_MAX_M + 256}.get(
        mode, 128)
    q = rng.standard_normal((B, N, H, D)).astype(np.float32)
    k = rng.standard_normal((B, M, H, D)).astype(np.float32)
    v = rng.standard_normal((B, M, H, D)).astype(np.float32)
    mask = None
    if mode == "mask":
        mask = np.ones((B, M), np.int32)
        mask[1, 17:] = 0  # a padded prompt
    elif mode == "stream":
        mask = np.zeros((B, M), np.int32)
        mask[:, :300] = 1  # whole kv blocks masked
    return q, k, v, (4 if mode == "seg" else 0), mask


@pytest.mark.parametrize("mode", ["full", "mask", "seg", "stream"])
@pytest.mark.parametrize("emit", [False, True], ids=["out", "emit"])
def test_attention_int8_qk_matches_jax_kernel(mode, emit):
    q, k, v, seg, mask = _attn_inputs(mode, seed=23)
    D = q.shape[-1]
    sc = D ** -0.5
    jm = None if mask is None else jnp.asarray(mask)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    targs = (t(q), t(k), t(v))
    tm = None if mask is None else t(mask)
    kw = dict(seg_len=seg, int8_qk=True, int8_pv=True)
    tol = 1e-3 if mode == "stream" else 2e-3
    if emit:
        codes, scales, _, _ = interp(jattn.attention_bnhd_int8out, *jargs,
                                     scale=sc, kv_mask=jm, **kw)
        pc, ps, _, _ = A.attention_bnhd(*targs, sc, kv_mask=tm, emit=True,
                                        **kw)
        assert pc.shape == codes.shape and ps.shape == scales.shape
        assert_codes_close(pc, codes)
        np.testing.assert_allclose(ps.numpy(), scales, rtol=tol)
    else:
        want = interp(jattn.attention_bnhd, *jargs, scale=sc, kv_mask=jm,
                      **kw)
        got = A.attention_bnhd(*targs, sc, kv_mask=tm, **kw)
        assert got.shape == want.shape
        assert rel_err(got, want) < tol
        # the quantizers really act: without them the output moves more
        plain = A.attention_bnhd(*targs, sc, kv_mask=tm, seg_len=seg,
                                 int8_pv=True)
        assert rel_err(plain, want) > 2 * rel_err(got, want)


def test_attention_int8_qk_counts_one_plain_k8_call():
    q, k, v, _, mask = _attn_inputs("mask", seed=24)
    calls = []
    orig = A.qk_headwise_quant_plain

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return orig(a, b)
    try:
        A.qk_headwise_quant_plain = spy
        A.attention_bnhd(t(q), t(k), t(v), 0.25, kv_mask=t(mask),
                         int8_qk=True, int8_pv=True, emit=True)
    finally:
        A.qk_headwise_quant_plain = orig
    assert calls == [(q.shape, k.shape)]


# ---- the tiny STDiT under attn8 ----

@pytest.fixture(scope="module")
def attn8():
    jmodel, jv = build_jax(ATTN8)
    fn = jax.jit(lambda x, tt, y, m: jmodel.apply(
        jv, x, tt, y, m, qctx=JQuantCtx(mode="quant")))
    return jmodel, jv, build_port(ATTN8, jv), fn


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_attn8_resolves_int8_qk_and_pv_at_every_site(attn8):
    port = attn8[2]
    q = QuantCtx(mode="quant")
    blk = port.blocks[0]
    for site in (blk.attn, blk.attn_temp):
        assert _exec_flags(site.specs[0], q) == (True, True)
        assert attn_emit_int8_ok(site.pspec, q)
    assert _exec_flags(blk.cross_attn.qspec, q) == (True, True)
    assert attn_emit_int8_ok(blk.cross_attn.pspec, q)
    # fp mode runs no quantizer
    assert _exec_flags(blk.attn.specs[0], None) == (False, False)


def test_attn8_forward_matches_jax_kernel_path(attn8, monkeypatch):
    _, _, port, fn = attn8
    args = inputs()
    with jax_kernel_path():
        want = np.asarray(fn(*args))
    calls = []
    orig = A.qk_headwise_quant_plain

    def spy(a, b):
        calls.append(a.shape)
        return orig(a, b)
    monkeypatch.setattr(A, "qk_headwise_quant_plain", spy)
    with torch.no_grad():
        got = port(*map(_t, args), qctx=QuantCtx(mode="quant")).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert rel_err(got, want) < FWD_TOL
    # K8 at the three sites of every block
    assert len(calls) == 3 * len(port.blocks)
    with torch.no_grad():
        fp = port(*map(_t, args)).numpy()
    assert rel_err(got, want) < 0.75 * rel_err(fp, want)


def test_attn8_denoise_matches_jax(attn8):
    jmodel, jv, port, _ = attn8
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


# ---- the card: K8's wrapper rules (no card: the launch is intercepted)
# and what chip_smoke.py runs ----

def test_cuda_k8_reaches_the_launch_and_refuses_what_it_does_not_take(
        monkeypatch):
    from test_torch_rules import _OnCard
    from viditq_tpu_torch.kernels import _build

    class Launched(Exception):
        pass

    def lib():
        raise Launched()
    monkeypatch.setattr(_build, "lib", lib)
    card = lambda a: t(a).as_subclass(_OnCard)  # noqa: E731
    q = card(np.zeros((2, 8, 4, 16), np.float32)).bfloat16()
    k = card(np.zeros((2, 3, 4, 16), np.float32)).bfloat16()
    with pytest.raises(Launched):
        A.qk_headwise_quant(q, k)
    with pytest.raises(ValueError, match="bfloat16"):
        A.qk_headwise_quant(q.float(), k.float())
    # D % 8 != 0 runs padded with zero channels (it was refused once);
    # only a head wider than JAX's attention gate (H * D <= 2048) refuses
    with pytest.raises(Launched):
        A.qk_headwise_quant(q[..., :12], k[..., :12])
    wide = card(np.zeros((1, 2, 1, A.QK_MAX_D + 8), np.float32)).bfloat16()
    with pytest.raises(ValueError, match="head dim"):
        A.qk_headwise_quant(wide, wide)
    # the attention's int8_qk goes through K8 first
    with pytest.raises(Launched):
        A.attention_bnhd(q, k, k, 0.25, int8_qk=True)


def test_chip_smoke_carries_the_attn8_cases_and_arm():
    import inspect
    import chip_smoke as cs
    assert cs.SLICE_KERNELS["stdit"]["attn8"] == cs.FUSED_KERNELS + (
        "qk_headwise_quant",)
    assert cs.ARM_PLANS[("stdit", "attn8")].name == ATTN8.split("/")[-1]
    per_block = cs.BLOCK_LAUNCHES[("stdit", "attn8")]
    # K8 once per attention site: 84 a forward, 1680 over the 20 steps
    assert per_block == {**cs.BLOCK_LAUNCHES[("stdit", "sm8")],
                         "qk_headwise_quant": 3}
    assert per_block["qk_headwise_quant"] * 28 * cs.STEPS == 1680
    assert cs.SOURCES["qk_headwise_quant"] == \
        "viditq_tpu_torch/csrc/qk_quant.cu"
    assert cs.REPLACES["qk_headwise_quant"].endswith("attention.py:481")
    src = inspect.getsource(cs.attn8_cases)
    for part in ("A.qk_headwise_quant(q, k)", "exact=True", "int8_qk=True",
                 "int8_pv_slack(qd, kd", '"spatial"', '"temporal"',
                 '"cross"'):
        assert part in src, part
    assert "attn8_cases(records)" in inspect.getsource(cs.phase_kernels)
    assert "ATTN8_PLAN" in inspect.getsource(cs.phase_reference)
