"""K5, the quantize-in int8 matmul (`csrc/dynq_gemm.cu`), as far as it can
be checked without a card:

  * the shared-memory byte layout its warps write the row codes in (and
    the producer warpgroup W^T where TMA cannot load it): every (row, k)
    byte of an M tile's codes lands once, at the address TMA's 128-byte
    swizzle gives, so the wgmma descriptors the core uses read them;
  * its tile schedule, replayed on the CPU through that layout: every
    output tile is written once, each M tile's codes are made once per run
    of its N tiles, and the result equals the plain version exactly (the
    int32 sums are exact and the f32 epilogue is the same sequence of
    operations), in all three symmetry modes;
  * the one mode no other test holds against the JAX kernel, sym acts x
    asym weights, in interpret mode: the codes come from identical float32
    inputs with no float reduction before the round (the absmax is exact),
    so the outputs agree to 1e-6 relative, as the sym x sym case
    (`tests/test_torch_kernels.py`);
  * the CUDA wrapper's rules: one launch of its own in every mode (K4's and
    K2's counts do not move), and K above 1152 refused before any launch.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import interp, rel_err, t
from test_torch_rules import _OnCard
from viditq_tpu.kernels import fused_matmul as jfm
from viditq_tpu_torch.kernels import _build, _counters
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels._common import k_major

BM, BN, BK = FM.K5_BM, FM.K5_BN, 128
SRC = (_build.CSRC / "dynq_gemm.cu").read_text()


def code_at(r, k):
    """dynq_gemm.cu `code_at`: k-tile k >> 7 of BM * 128 bytes, row r at
    r * 128 in it, its 16-byte chunk (k >> 4) & 7 moved to that XOR r & 7."""
    return ((k >> 7) * BM * BK + r * BK + ((((k >> 4) & 7) ^ (r & 7)) << 4)
            + (k & 15))


def swizzle_128b(off):
    """TMA's CU_TENSOR_MAP_SWIZZLE_128B on a 1024-byte aligned box of
    128-byte rows: bits 4-6 of the offset XOR bits 7-9."""
    return off ^ (((off >> 7) & 7) << 4)


def test_code_layout_formula_is_the_kernels():
    assert ("return (k >> 7) * CODE_TILE + r * BK + ((((k >> 4) & 7) ^ "
            "(r & 7)) << 4) +\n         (k & 15);") in SRC
    assert int(re.search(r"constexpr int BN = (\d+);", SRC).group(1)) == BN
    assert int(re.search(r"constexpr int MAX_KT = (\d+);", SRC).group(1)) \
        * BK == FM.K5_MAX_K


@pytest.mark.parametrize("nkt", [1, 9])
def test_codes_land_once_where_tma_swizzle_puts_them(nkt):
    r, k = np.meshgrid(np.arange(BM), np.arange(nkt * BK), indexing="ij")
    addr = code_at(r, k)
    # each byte once, and the whole buffer
    assert np.array_equal(np.sort(addr.ravel()), np.arange(nkt * BM * BK))
    # TMA's layout of k-tile kt, a [BM, 128] box at kt * BM * 128 (1024-byte
    # aligned): the wgmma descriptors of the core read exactly this
    lin = (k >> 7) * BM * BK + r * BK + (k & 127)
    assert np.array_equal(addr, swizzle_128b(lin))
    # a lane's 16-byte chunk of 16 codes is one aligned 16-byte store
    chunk = addr[:, ::16]
    assert (chunk % 16 == 0).all()
    assert np.array_equal(addr, np.repeat(chunk, 16, axis=1)
                          + np.tile(np.arange(16), nkt * BK // 16))


def test_byte_wise_weight_slot_is_tmas_layout():
    # the producer warpgroup's W^T loads (K % 16 != 0) use the same formula
    # on a [BN, 128] slot
    n, k = np.meshgrid(np.arange(BN), np.arange(BK), indexing="ij")
    addr = code_at(n, k)
    assert np.array_equal(np.sort(addr.ravel()), np.arange(BN * BK))
    assert np.array_equal(addr, swizzle_128b(n * BK + k))


def test_quad_exchange_gives_each_lane_one_contiguous_run():
    # dynq_gemm.cu `quad_transpose`: before, quad lane t4 holds columns
    # 2*t4, 2*t4 + 1 of each of four 8-column blocks j (the wgmma fragment,
    # `acc_col`); after, lane t4 holds all of block t4 in column order, the
    # run it stores as one 16-byte (bf16) or 32-byte (f32) piece
    src = SRC[SRC.index("__device__ __forceinline__ void quad_transpose"):]
    assert "const int send = (t4 - k) & 3;" in src
    assert "const int src = (t4 + k) & 3;" in src
    assert "const P r = shfl(v, (lane & ~3) | src);" in src
    held = {lane: [(j, 2 * (lane & 3)) for j in range(4)] for lane in range(32)}
    out = {lane: list(held[lane]) for lane in range(32)}
    for k in range(4):
        sent = {lane: held[lane][((lane & 3) - k) & 3] for lane in range(32)}
        for lane in range(32):
            s = ((lane & 3) + k) & 3
            out[lane][s] = sent[(lane & ~3) | s]
    for lane in range(32):
        t4 = lane & 3
        assert out[lane] == [(t4, 2 * s) for s in range(4)]


# ---------------------------------------------------------------------------
# the tile schedule, replayed
# ---------------------------------------------------------------------------

def _replay(x, w, ws, b, sms, sym, sym_w, w_zp, w_colsum):
    """The kernel's order on the CPU: persistent blocks walk the units
    (M tile u // nsplit, run u % nsplit of N tiles); a unit quantizes its M
    tile's rows into a shared-memory image (the row quantizer of the plain
    version, `code_at` addresses, zero codes past M and K), then runs each
    N tile: k32 steps over the k-tiles read back through the layout, and
    the plain version's epilogue on the rows of the tile that exist.
    Returns the output and the audit (writes of each output tile,
    quantizes of each M tile) and nsplit."""
    M, K = x.shape
    N = w.shape[1]
    nkt = -(-K // BK)
    nsplit = FM.k5_split(M, N, sms)
    tiles_m, tiles_n = -(-M // BM), -(-N // BN)
    run = -(-tiles_n // nsplit)
    units = tiles_m * nsplit
    out = torch.full((M, N), float("nan"))
    writes = np.zeros((tiles_m, tiles_n), np.int32)
    quantized = np.zeros(tiles_m, np.int32)
    r, k = np.meshgrid(np.arange(BM), np.arange(nkt * BK), indexing="ij")
    addr = torch.from_numpy(code_at(r, k))
    wpad = torch.zeros((nkt * BK, tiles_n * BN), dtype=torch.int8)
    wpad[:K, :N] = w
    wz = None if sym_w else w_zp
    for block in range(min(units, sms)):
        for unit in range(block, units, min(units, sms)):
            m0, part = unit // nsplit * BM, unit % nsplit
            rows = min(BM, M - m0)
            q, s, zp, rs = FM.quantize_rows_plain(
                x[m0:m0 + rows], sym, need_rowsum=not (sym and sym_w))
            smem = torch.zeros(nkt * BM * BK, dtype=torch.int8)
            tile = torch.zeros((BM, nkt * BK), dtype=torch.int8)
            tile[:rows, :K] = q
            smem[addr.reshape(-1)] = tile.reshape(-1)
            quantized[m0 // BM] += 1
            a = smem[addr]  # the codes as the wgmmas read them
            for tn in range(part * run, min((part + 1) * run, tiles_n)):
                n0 = tn * BN
                acc = torch.zeros((BM, BN), dtype=torch.float64)
                for kk in range(0, K, 32):  # the k32 steps below K
                    acc += (a[:, kk:kk + 32].double()
                            @ wpad[kk:kk + 32, n0:n0 + BN].double())
                cols = min(BN, N - n0)
                acc = acc[:rows, :cols].float()
                wsl, bl = ws[:, n0:n0 + cols], b[n0:n0 + cols]
                if sym and sym_w:
                    val = acc * (s * wsl)
                else:
                    val = FM._zp_epilogue(
                        acc, rows, cols, K, s, wsl, zp, rs,
                        None if wz is None else wz[:, n0:n0 + cols],
                        None if w_colsum is None
                        else w_colsum[:, n0:n0 + cols])
                out[m0:m0 + rows, n0:n0 + cols] = val + bl.reshape(1, -1)
                writes[m0 // BM, tn] += 1
    return out, writes, quantized, nsplit


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("mode", ["sym", "symx", "asym"])
@pytest.mark.parametrize("M", [19, 240, 300])
def test_k5_schedule_matches_plain(M, mode, sms):
    g = torch.Generator().manual_seed(M + len(mode) + sms)
    K, N = 1152, (2304 if M == 240 else 1152)
    x = torch.randn(M, K, generator=g) * 2.0 + 0.2
    x[M // 2] = 0  # a row of zeros: the 1e-6 scale floor
    w = k_major(torch.randint(-128, 128, (K, N), generator=g,
                              dtype=torch.int8))
    ws = torch.rand(1, N, generator=g) * 1e-3 + 1e-4
    b = torch.randn(N, generator=g) * 0.1
    sym, sym_w = mode != "asym", mode == "sym"
    wzp = torch.randint(-20, 20, (1, N), generator=g).float()
    wcs = w.float().sum(0, keepdim=True)
    want = FM.fused_dynq_int8_matmul_plain(
        x, w, ws, b, torch.float32, sym=sym, sym_w=sym_w, w_zp=wzp,
        w_colsum=wcs)
    got, writes, quantized, nsplit = _replay(x, w, ws, b, sms, sym, sym_w,
                                             wzp, wcs)
    assert (writes == 1).all()            # every output tile once
    assert (quantized == nsplit).all()    # an M tile's codes once a run
    assert torch.equal(got, want)


def test_k5_split_fills_the_card_without_empty_runs():
    # q_linear's 256 M tiles fill 132 SMs: one run (x read once); kv_linear
    # (2 M tiles of 12 N tiles) splits into 12 runs of one tile
    assert FM.k5_split(32768, 1152, 132) == 1
    assert FM.k5_split(240, 2304, 132) == 12
    for m in (19, 240, 300, 1000, 4096, 32768):
        for n in (192, 1008, 1152, 2304, 4608):
            for sms in (3, 78, 132):
                s = FM.k5_split(m, n, sms)
                tiles_n = -(-n // BN)
                run = -(-tiles_n // s)
                assert 1 <= s <= tiles_n
                assert (s - 1) * run < tiles_n  # the last run is not empty


# ---------------------------------------------------------------------------
# the JAX kernel: sym acts x asym weights
# ---------------------------------------------------------------------------

def test_k5_sym_acts_asym_weights_matches_jax():
    rng = np.random.default_rng(41)
    M, K, N = 240, 128, 256  # M: the kv_linear row count
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    wzp = rng.integers(-20, 20, (1, N)).astype(np.float32)
    wcs = w.astype(np.float32).sum(0, keepdims=True)
    b = rng.standard_normal(N).astype(np.float32)
    want = interp(jfm.fused_dynq_int8_matmul, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(ws), jnp.asarray(wzp), jnp.asarray(wcs),
                  sym=True, sym_w=False, bias=jnp.asarray(b),
                  out_dtype=jnp.float32)
    got = FM.fused_dynq_int8_matmul(t(x), k_major(t(w)), t(ws), t(b),
                                    torch.float32, sym=True, sym_w=False,
                                    w_zp=t(wzp), w_colsum=t(wcs))
    assert rel_err(got, want) < 1e-6


# ---------------------------------------------------------------------------
# the CUDA wrapper (no card: the launch is intercepted)
# ---------------------------------------------------------------------------

class _Launched(Exception):
    pass


def _card_args(K=128, N=192, row_major=False, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(K + N)
    x = torch.randn(32, K, generator=g).to(dtype)
    w = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    w = w.contiguous() if row_major else k_major(w)
    ws, wzp = torch.rand(1, N, generator=g), torch.zeros(1, N)
    card = lambda a: a.as_subclass(_OnCard)  # noqa: E731
    return ([card(x), card(w), card(ws)],
            dict(w_zp=card(wzp), w_colsum=card(w.float().sum(0, keepdim=True))))


@pytest.fixture
def no_launch(monkeypatch):
    def lib():
        raise _Launched()
    monkeypatch.setattr(_build, "lib", lib)


@pytest.mark.parametrize("mode", ["sym", "symx", "asym"])
@pytest.mark.parametrize("K", [72, 1152])
def test_cuda_k5_is_one_launch_of_its_own(no_launch, mode, K):
    args, kw = _card_args(K=K)
    _counters.reset()
    with pytest.raises(_Launched):
        FM.fused_dynq_int8_matmul(*args, sym=mode != "asym",
                                  sym_w=mode == "sym", **kw)
    # neither K4 nor K2 ran (or counted) on the way to K5's launch
    assert all(v == {"launches": 0, "plain_cuda": 0}
               for v in _counters.snapshot().values())


@pytest.mark.parametrize("bad,match", [
    (dict(row_major=True), "K-major"),
    (dict(dtype=torch.float16), "bfloat16 or float32")],
    ids=["row-major-w", "fp16-x"])
def test_cuda_k5_refuses_what_its_kernel_does_not_take(no_launch, bad,
                                                       match):
    args, kw = _card_args(**bad)
    with pytest.raises(ValueError, match=match):
        FM.fused_dynq_int8_matmul(*args, sym=False, sym_w=False, **kw)
    with pytest.raises(ValueError, match="w_colsum"):
        FM.fused_dynq_int8_matmul(*_card_args()[0], sym=False, sym_w=False,
                                  w_zp=_card_args()[1]["w_zp"])


@pytest.mark.parametrize("shape", [
    dict(K=1168), dict(K=2304), dict(K=4608), dict(N=200), dict(N=1000),
    dict(K=1004)], ids=["K1168", "K2304", "K4608", "N200", "N1000", "K1004"])
@pytest.mark.parametrize("mode", ["sym", "asym"])
def test_cuda_k5_takes_every_k_and_n(no_launch, shape, mode):
    """Shapes beyond the resident schedule (K <= 1152, N % 16 == 0,
    16-byte rows) reach K5's launch, and nothing else launches on the
    way (the padding of N and of x's rows is plain tensor work)."""
    args, kw = _card_args(**shape)
    _counters.reset()
    with pytest.raises(_Launched):
        FM.fused_dynq_int8_matmul(*args, sym=mode == "sym",
                                  sym_w=mode == "sym", **kw)
    assert all(v == {"launches": 0, "plain_cuda": 0}
               for v in _counters.snapshot().values())


@pytest.mark.parametrize("K,N", [(4608, 1152), (1152, 1000), (1004, 192)])
@pytest.mark.parametrize("mode", ["sym", "symx", "asym"])
def test_k5_wide_k_and_padded_n_match_jax(K, N, mode):
    """JAX's K5 in interpret mode at fc2's K, at N % 16 != 0 and at rows
    that are not 16 bytes, against the port's plain version (the card
    holds its kernel to the same plain version bit for bit)."""
    rng = np.random.default_rng(K + N)
    M = 40
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    ws = rng.uniform(1e-4, 1e-3, (1, N)).astype(np.float32)
    wzp = (rng.integers(-20, 20, (1, N)).astype(np.float32)
           if mode != "sym" else np.zeros((1, N), np.float32))
    wcs = w.astype(np.float32).sum(0, keepdims=True)
    sym, sym_w = mode != "asym", mode == "sym"
    want = interp(jfm.fused_dynq_int8_matmul, jnp.asarray(x), jnp.asarray(w),
                  jnp.asarray(ws), jnp.asarray(wzp), jnp.asarray(wcs),
                  sym=sym, sym_w=sym_w, out_dtype=jnp.float32)
    got = FM.fused_dynq_int8_matmul(t(x), k_major(t(w)), t(ws), None,
                                    torch.float32, sym=sym, sym_w=sym_w,
                                    w_zp=t(wzp), w_colsum=t(wcs))
    assert got.shape == (M, N)
    assert rel_err(got, want) < 1e-6


def test_chip_smoke_carries_the_k5_cases():
    import inspect
    import chip_smoke as cs
    cases = [p for _, p in cs.K5_EDGE_CASES]
    assert {19, 240, 300} <= {p["M"] for p in cases}
    assert any(p["N"] % BN and p["N"] % 16 == 0 for p in cases)
    assert any(p["K"] == 72 for p in cases)
    assert any(p.get("zero_rows") and p.get("mode") == "asym" for p in cases)
    assert any(p.get("zero_rows") and p.get("mode", "sym") == "sym"
               for p in cases)
    assert any(p["K"] == FM.K5_MAX_K for p in cases)
    # the shapes the kernel once refused compute: wide K (f32 x too), rows
    # that are not 16 bytes, N % 16 != 0
    assert not any(p.get("refused") for p in cases)
    assert any(p["K"] > FM.K5_MAX_K and p.get("f32") for p in cases)
    assert any(p["K"] > FM.K5_MAX_K and p.get("mode") == "symx"
               for p in cases)
    assert any(p["K"] * 2 % 16 for p in cases)
    assert any(p["N"] % 16 for p in cases)
    wide = inspect.getsource(cs.k5_wide_cases)
    assert "M, K, N = 32768, 4608, 1152" in wide
    assert '("sym", "symx", "asym")' in wide and "residual=res" in wide
    assert {"sym", "symx", "asym"} <= {p.get("mode", "sym") for p in cases}
    assert cs.SOURCES["fused_dynq_int8_matmul"] == \
        "viditq_tpu_torch/csrc/dynq_gemm.cu"
    main = inspect.getsource(cs.phase_kernels)
    asym = inspect.getsource(cs.asym_cases)
    assert "check_k5(records, case" in main and "k5_edge_cases(records)" \
        in main and "k5_wide_cases(records)" in main
    for case in ('"asym kv_linear', '"asym q_linear',
                 '"sym x asym-weight kv_linear'):
        assert case in asym, case
    assert "check_k5(records, case" in asym
    # each case: identical to the route, the plain version, timed against
    # the route and cuBLAS bf16
    check = inspect.getsource(cs.check_k5)
    for part in ("torch.equal(got, want)", "k5_route(", "check_case(",
                 "cuda_ms_back_to_back", "xb @ wb"):
        assert part in check, part
    route = inspect.getsource(cs.k5_route)
    assert "FM.quantize_rows(" in route and "FM.int8_consumer_matmul(" in route
