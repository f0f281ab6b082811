"""K3's seg mode (STDiT temporal attention) and K7a's row quantize: CPU
replays of the Hopper kernels' schedules (csrc/attention.cu
`attn_seg_tiled` and `vquant_tiles_kernel`, csrc/int_matmul.cu
`dyn_quant_rows_kernel`), held against the port's plain versions and the
JAX package's Pallas kernels run in interpret mode, on inputs made with
numpy from a seed.

A replay computes what the kernel computes in the kernel's own blocking:
16-row tiles across all heads, two heads a warp, the row reductions of the
emission per warp and then across warps, the int8 PV as an integer product
over the tile's v codes in their stored slot order; K7a's row split into
16-element chunks per lane, min/max per lane and then over the warp.

Tolerances, each with its reason: the replay and the plain version sum
the f32 scores, r and PV in other orders, so bf16 outputs agree to 1e-5
relative and int8-PV outputs to 2e-3 (a softmax code round(e*127) may
flip by one where exp2 differs by an ulp at a tie); emitted codes may
differ by one at no more than 0.1% of entries; K7a's every step is exact
or correctly rounded, so its replay is identical.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viditq_tpu.kernels import attention as jattn
from viditq_tpu_torch.kernels import _build, _counters
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.kernels._common import divc, rdiv

from test_torch_asym import check_rows
from test_torch_kernels import assert_codes_close, interp, rel_err, t
from test_torch_rules import _OnCard

TR = A.SEG_TILE
HPW = 2  # heads a warp of the tiled kernel


def _inputs(N, H, D, seed, B=2, v_shift=0.0):
    """q, k, v [B, N, H, D] float32 holding bf16 values (the kernel's
    input type), v shifted off zero by v_shift."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, H, D)).astype(np.float32)
               for _ in range(3))
    return tuple(torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                 for a in (q, k, v + v_shift))


def replay_vquant_tiles(v, vgroup):
    """vquant_tiles_kernel: one block per (v group, batch row) writes the
    scales of its group and, per 16-row tile that holds its rows and per
    channel, the codes in slot order: 16 bytes where the tile is the
    group's alone (the last group also owns the rows past N), else only
    its own rows' bytes. Bytes no block writes keep the buffer's fill
    (0x5a), so a hole shows."""
    B, N, C = v.shape
    nt = -(-N // TR)
    G = N // vgroup
    vt = torch.full((B, nt, C, TR), 0x5a, dtype=torch.int8)
    vs = torch.empty((B, G, C))
    perm = A.KV_PERM[:TR]
    for grp in range(G):
        g0 = grp * vgroup
        g1 = nt * TR if grp == G - 1 else g0 + vgroup
        rows = v[:, g0:g0 + vgroup].float()
        s = torch.clamp(rows.abs().amax(dim=1), min=1e-6)       # [B, C]
        vs[:, grp] = s
        mul = rdiv(127.0, s)
        for tile in range(g0 // TR, (g0 + vgroup - 1) // TR + 1):
            for slot in range(TR):
                n = tile * TR + perm[slot]
                if g0 <= n < g0 + vgroup:
                    vt[:, tile, :, slot] = torch.round(
                        v[:, n].float() * mul).to(torch.int8)
                elif n < g1 and n >= g0:
                    vt[:, tile, :, slot] = 0
    return vt, vs


def replay_seg_tiled(q, k, v, scale, seg, int8_pv=False, v_block=None,
                     emit=None, need_rowsum=False):
    """attn_seg_tiled on the CPU. q/k/v [B, N, H, D] float; emit None (bf16
    out), "sym" or "asym". Returns what attention_bnhd returns."""
    B, N, H, D = q.shape
    C = H * D
    W = H // HPW
    nt = -(-N // TR)
    Np = nt * TR
    scale2 = float(np.float32(scale * A.LOG2E))

    def tiles(x):  # [B, N, H, D] -> [B, nt, TR, H, D], zero past N
        xp = torch.zeros((B, Np, H, D))
        xp[:, :N] = x
        return xp.reshape(B, nt, TR, H, D)
    qt = tiles((q.float() * scale2).to(torch.bfloat16).float())
    kt = tiles(k.to(torch.bfloat16).float())
    s = torch.einsum("btrhd,btchd->bthrc", qt, kt)        # [B, nt, H, 16, 16]
    shift = int(math.log2(seg))
    idx = torch.arange(TR)
    same = (idx[:, None] >> shift) == (idx[None, :] >> shift)
    s = torch.where(same, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - m)
    r = e.sum(dim=-1, keepdim=True)
    if int8_pv:
        vq, vs = replay_vquant_tiles(v.to(torch.bfloat16).reshape(B, N, C),
                                     v_block)
        # the s8 A operand: byte k of a row's 16 codes holds column perm[k]
        perm = list(A.KV_PERM[:TR])
        codes = torch.round(e * 127.0)[..., perm].long()
        vt = vq.reshape(B, nt, H, D, TR).long()
        acc = torch.einsum("bthrk,bthdk->btrhd", codes, vt).float()
        tq = rdiv(1.0 / (127.0 * 127.0), r)               # [B, nt, H, 16, 1]
        n = torch.arange(Np).clamp(max=N - 1)
        vsr = vs[:, n // v_block].reshape(B, nt, TR, H, D)
        o = (acc * tq.permute(0, 1, 3, 2, 4)) * vsr
    else:
        # probabilities in v's type (bf16 on the card), as the plain
        # version rounds them
        p = (e * rdiv(1.0, r)).to(v.dtype).float()
        o = torch.einsum("bthrc,btchd->btrhd", p, tiles(v.float()))
    o = o.reshape(B, Np, C)
    if emit is None:
        return o[:, :N].to(q.dtype).reshape(B, N, H, D)  # the kernel: bf16
    # each warp's two heads, then across warps (max and min: exact in any
    # order)
    ow = o.reshape(B, Np, W, HPW * D)
    if emit == "sym":
        hi = ow.abs().amax(dim=-1).amax(dim=-1, keepdim=True)
        smax = torch.clamp(hi, min=1e-6)
        q8 = torch.clamp(torch.round(o * rdiv(127.0, smax)), -128, 127)
        sc, zp = divc(smax, 127.0), None
    else:
        hi = torch.clamp(ow.amax(dim=-1), min=0.0).amax(-1, keepdim=True)
        lo = torch.clamp(ow.amin(dim=-1), max=0.0).amin(-1, keepdim=True)
        sc = torch.clamp(divc(hi - lo, 255.0), min=1e-6)
        inv = rdiv(1.0, sc)
        zp = torch.round(-lo * inv) - 128.0
        q8 = torch.clamp(torch.round(o * inv) + zp, -128, 127)
    rowsum = None
    if need_rowsum:
        rowsum = q8.reshape(B, Np, W, HPW * D).sum(-1).sum(-1, keepdim=True)

    def rows(x):
        return None if x is None else x[:, :N].reshape(B * N, -1)
    out = (rows(q8).to(torch.int8), rows(sc), rows(zp), rows(rowsum))
    return A._bn1(B, N, *out)


CASES = [(seg, D, int8_pv, emit)
         for seg in (2, 16) for D in (16, 72) for int8_pv in (False, True)
         for emit in (None, "sym", "asym")]


@pytest.mark.parametrize("seg,D,int8_pv,emit", CASES,
                         ids=[f"seg{s}-D{d}-{'i8' if i else 'bf16'}-{e}"
                              for s, d, i, e in CASES])
def test_seg_tiled_replay(seg, D, int8_pv, emit):
    # H = 4: two warps, so the emission's rows reduce across warps
    H, N = 4, 64
    q, k, v = _inputs(N, H, D, seed=50 + D + seg, v_shift=0.5 if emit ==
                      "asym" else 0.0)
    scale = D ** -0.5
    vb = A.seg_v_block(N, seg) if int8_pv else None
    kw = dict(seg_len=seg, int8_pv=int8_pv, v_block=vb,
              emit=emit is not None, emit_sym=emit != "asym",
              need_rowsum=emit == "asym")
    got = replay_seg_tiled(t(q), t(k), t(v), scale, seg, int8_pv, vb, emit,
                           emit == "asym")
    plain = A.attention_bnhd(t(q), t(k), t(v), scale, **kw)
    jkw = dict(scale=scale, seg_len=seg, int8_pv=int8_pv)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    if emit is None:
        want = interp(jattn.attention_bnhd, *jargs, **jkw)
        tol = 2e-3 if int8_pv else 1e-5
        assert rel_err(got.float(), plain.float()) < tol
        assert rel_err(got.float(), want) < tol
        return
    want = interp(jattn.attention_bnhd_int8out, *jargs, **jkw,
                  emit_sym=emit == "sym", need_rowsum=emit == "asym")
    flat = [None if x is None else x.reshape(-1, x.shape[-1])
            for x in got]
    rtol = 2e-3 if int8_pv else 1e-5
    for other in (plain, want):
        ref = [None if x is None else t(x).reshape(-1, x.shape[-1])
               for x in other]
        check_rows(flat, ref, sym=emit == "sym", scale_rtol=rtol)


@pytest.mark.parametrize("N,seg", [(50, 2), (72, 4), (24, 8)])
def test_seg_tiled_replay_ragged_last_tile(N, seg):
    # N not a multiple of the 16-row tile: the last tile's rows past N are
    # zeros, its segments whole; v groups straddle tiles (int8 PV)
    H, D = 4, 16
    q, k, v = _inputs(N, H, D, seed=60 + N)
    vb = A.seg_v_block(N, seg)
    assert N % TR and vb % TR
    got = replay_seg_tiled(t(q), t(k), t(v), 0.25, seg, True, vb, "sym")
    plain = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg,
                             int8_pv=True, v_block=vb, emit=True)
    want = interp(jattn.attention_bnhd_int8out, jnp.asarray(q),
                  jnp.asarray(k), jnp.asarray(v), scale=0.25, seg_len=seg,
                  int8_pv=True)
    for ref in (plain, want):
        assert_codes_close(got[0], np.asarray(ref[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=2e-3)


@pytest.mark.parametrize("N,vgroup", [(50, 10), (64, 16), (512, 256),
                                      (48, 6)])
def test_vquant_tiles_replay_is_the_tile_layout(N, vgroup):
    # every byte of the tiled v codes is written once, by its group's block
    # (a tile shared by two groups byte by byte), and equals the plain
    # layout of the plain per-group codes
    rng = np.random.default_rng(70)
    v = torch.from_numpy(rng.standard_normal((2, N, 32)).astype(
        np.float32)).to(torch.bfloat16)
    vt, vs = replay_vquant_tiles(v, vgroup)
    vq, vs_plain = A._v_quant(v, vgroup)
    assert torch.equal(vs, vs_plain)
    assert torch.equal(vt, A.v_codes_tiles(vq))


def test_v_codes_tiles_layout():
    rng = np.random.default_rng(71)
    B, N, C = 2, 40, 24
    vq = rng.integers(-127, 128, (B, N, C)).astype(np.float32)
    vt = A.v_codes_tiles(t(vq)).numpy()
    nt = 3
    assert vt.shape == (B, nt, C, TR) and vt.dtype == np.int8
    padded = np.zeros((B, nt * TR, C), np.int8)
    padded[:, :N] = vq
    perm = np.asarray(A.KV_PERM[:TR])
    for tile in range(nt):
        np.testing.assert_array_equal(
            vt[:, tile], padded[:, tile * TR + perm].transpose(0, 2, 1))


def test_kv16_is_the_s8_k16_fragment_order():
    # k index 4*t4 + j of the m16n8k16 s8 A operand, packed from the score
    # accumulators, holds column {2t4, 2t4+1, 8+2t4, 9+2t4}[j]; the tiled
    # kernel's kv16 and the row kernel's kv_perm are KV_PERM
    want = [(2 * t4, 2 * t4 + 1, 8 + 2 * t4, 9 + 2 * t4)[j]
            for t4 in range(4) for j in range(4)]
    assert list(A.KV_PERM[:TR]) == want
    src = (_build.CSRC / "attention.cu").read_text()
    assert "((k & 3) >> 1) * 8 + (k >> 2) * 2 + (k & 1)" in src
    assert [((k & 3) >> 1) * 8 + (k >> 2) * 2 + (k & 1)
            for k in range(16)] == want
    assert ("(k >> 4) * 16 + ((k & 3) >> 1) * 8 + ((k & 15) >> 2) * 2 + "
            "(k & 1)") in src


@pytest.mark.parametrize("H,seg,int8_pv,v_block,tiled", [
    (16, 16, True, 256, True), (4, 2, False, None, True),
    (2, 16, True, 1024, True), (16, 16, True, 2048, False),
    (16, 32, False, None, False), (3, 16, False, None, False),
    (1, 1088, True, 1088, False)])
def test_seg_tiled_dispatch_rule(H, seg, int8_pv, v_block, tiled):
    assert A.seg_tiled(H, seg, int8_pv, v_block, 72) == tiled
    # the tiled kernel's widths; D = 128 (two heads a warp would hold 128
    # accumulators a thread) takes the row kernel
    for D in (16, 32, 64):
        assert A.seg_tiled(H, seg, int8_pv, v_block, D) == tiled
    assert not A.seg_tiled(H, seg, int8_pv, v_block, 128)


def test_seg_int8_pv_beyond_1040_kv_rows_matches_jax():
    # the old f32-sum limit (a q tile's kv range <= 1040) is gone: seg 1088
    # int8 PV (the row kernel on the card) against the JAX kernel
    N, H, D, seg = 1088, 1, 16, 1088
    q, k, v = _inputs(N, H, D, seed=72, B=1)
    want = interp(jattn.attention_bnhd, jnp.asarray(q), jnp.asarray(k),
                  jnp.asarray(v), scale=0.25, seg_len=seg, int8_pv=True)
    got = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg,
                           int8_pv=True, v_block=seg)
    assert rel_err(got.float(), want) < 2e-3


# ---------------------------------------------------------------------------
# K7a: one warp per row
# ---------------------------------------------------------------------------

def replay_dyn_quant_rows(x, sym):
    """dyn_quant_rows_kernel on the CPU: each row to one warp; lane l owns
    the 16-element chunks l + 32*i (resident rows: one read; longer rows
    in passes of CPL chunks a lane, read twice); min/max and the code sum
    per lane, then over the warp. Checks that every element is read and
    every code written exactly once per pass."""
    M, K = x.shape
    vec = 16 // x.element_size()
    nvec = K // vec
    nchunk = -(-nvec // (16 // vec))
    big = 9 if x.dtype == torch.bfloat16 else 5
    per_lane = -(-nchunk // 32)
    cpl = 3 if per_lane <= 3 else big
    passes = 1 if per_lane <= big else -(-nchunk // (32 * cpl))
    lane_of = torch.empty(K, dtype=torch.long)
    seen = torch.zeros(K, dtype=torch.long)
    for base in range(0, passes * 32 * cpl, 32 * cpl):
        for lane in range(32):
            for i in range(cpl):
                ch = base + lane + 32 * i
                if ch < nchunk:
                    lo, hi = ch * 16, min(ch * 16 + 16, K)
                    lane_of[lo:hi] = lane
                    seen[lo:hi] += 1
    assert torch.equal(seen, torch.ones(K, dtype=torch.long))
    xf = x.float()
    lanes = torch.zeros((M, 32, K))
    lanes[:, lane_of, torch.arange(K)] = 1.0
    own = lanes.bool()
    if sym:
        part = torch.where(own, xf.abs()[:, None, :], 0.0).amax(-1)
        s = torch.clamp(divc(part.amax(-1, keepdim=True), 127.0), min=1e-6)
        z = torch.zeros_like(s)
        q = torch.clamp(torch.round(xf / s), -128, 127)
    else:
        lo = torch.where(own, xf[:, None, :], 0.0).amin(-1).clamp(max=0.0)
        hi = torch.where(own, xf[:, None, :], 0.0).amax(-1).clamp(min=0.0)
        lo, hi = lo.amin(-1, keepdim=True), hi.amax(-1, keepdim=True)
        s = torch.clamp(divc(hi - lo, 255.0), min=1e-6)
        z = torch.round(-lo / s) - 128.0
        q = torch.clamp(torch.round(xf / s) + z, -128, 127)
    lane_sums = torch.zeros((M, 32)).index_add_(1, lane_of, q)
    return q.to(torch.int8), s, z, lane_sums.sum(-1, keepdim=True)


@pytest.mark.parametrize("K,dtype,sym", [
    (1152, torch.bfloat16, False), (1152, torch.bfloat16, True),
    (4608, torch.bfloat16, False), (4608, torch.float32, False),
    (9216, torch.bfloat16, True), (72, torch.bfloat16, False),
    (1160, torch.float32, True)])
def test_k7a_warp_per_row_replay_is_identical(K, dtype, sym):
    rng = np.random.default_rng(80 + K)
    x = torch.from_numpy(rng.standard_normal((6, K)).astype(np.float32)
                         + 0.2).to(dtype)
    got = replay_dyn_quant_rows(x, sym)
    want = IM.dynamic_quant_rows_plain(x, sym)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the seg launch paths (no card: the device, the stream and the library are
# stand-ins that record what a call allocates and launches)
# ---------------------------------------------------------------------------

@pytest.fixture
def launches(monkeypatch):
    record = {"calls": [], "alloc": []}

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                record["calls"].append(name)
                return 0
            return call
    real_empty = torch.empty

    def empty(*shape, dtype=None, device=None, **kw):
        shape = shape[0] if len(shape) == 1 and isinstance(
            shape[0], (tuple, list, torch.Size)) else shape
        record["alloc"].append((tuple(shape), dtype))
        return real_empty(shape, dtype=dtype)
    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(_build, "stream_ptr", lambda x: 0)
    monkeypatch.setattr(torch, "empty", empty)
    yield record
    _counters.reset()


def _card(*shape):
    g = torch.Generator().manual_seed(0)
    return torch.randn(*shape, generator=g).to(torch.bfloat16).as_subclass(
        _OnCard)


@pytest.mark.parametrize("H,seg,int8_pv,emit,emit_sym", [
    (16, 16, False, False, True), (16, 16, True, True, True),
    (16, 16, False, True, False), (4, 2, True, True, False),
    (16, 16, True, False, True), (3, 16, False, True, False),
    (16, 48, True, True, True), (16, 48, False, False, True)])
def test_seg_launch_paths_write_no_f32_scratch(launches, H, seg, int8_pv,
                                               emit, emit_sym):
    # the tiled kernel emits in one launch; the row kernel (H odd, seg not
    # dividing 16) in two (per-head ranges, then codes); no launch writes
    # an f32 output of the attention's size
    B, N, D = 2, 96, 72
    q, k, v = (_card(B, N, H, D) for _ in range(3))
    A.attention_bnhd(q, k, v, 0.1, seg_len=seg, int8_pv=int8_pv, emit=emit,
                     emit_sym=emit_sym, need_rowsum=not emit_sym)
    tiled = A.seg_tiled(H, seg, int8_pv, A.seg_v_block(N, seg), D)
    vquant = "vq_attn_vquant_tiles" if tiled else "vq_attn_vquant"
    attn = (["vq_attention_seg"] if tiled else
            ["vq_attention_seg_rows"] * (2 if emit else 1))
    assert launches["calls"] == ([vquant] if int8_pv else []) + attn
    big_f32 = [s for s, dt in launches["alloc"] if dt == torch.float32
               and math.prod(s) >= B * N * H * D]
    assert not big_f32, launches["alloc"]


def test_seg_row_kernel_takes_long_segments_without_a_kv_limit(launches):
    # seg 1088 int8 PV reaches the row kernel (no 1040 refusal), with and
    # without emission
    q, k, v = (_card(1, 1088, 1, 16) for _ in range(3))
    A.attention_bnhd(q, k, v, 0.25, seg_len=1088, int8_pv=True,
                     v_block=1088)
    A.attention_bnhd(q, k, v, 0.25, seg_len=1088, int8_pv=True,
                     v_block=1088, emit=True)
    assert launches["calls"] == ["vq_attn_vquant", "vq_attention_seg_rows",
                                 "vq_attn_vquant"] + [
                                     "vq_attention_seg_rows"] * 2


@pytest.mark.parametrize("emit", ["sym", "asym"])
def test_seg_rows_two_pass_emission_replay(emit):
    # attn_seg_rows' emission: launch 1 keeps each (row, head)'s max(o, 0)
    # and min(o, 0), launch 2 quantizes every row from their range over
    # the heads and adds each head's code sum: the plain emission exactly
    B, N, H, D, seg = 2, 96, 3, 16, 48
    q, k, v = _inputs(N, H, D, seed=73, v_shift=0.5 if emit == "asym"
                      else 0.0)
    o = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg)   # f32 rows
    heads = o.reshape(B * N, H, D)
    hi = heads.amax(-1).clamp(min=0.0).amax(-1, keepdim=True)
    lo = heads.amin(-1).clamp(max=0.0).amin(-1, keepdim=True)
    rows = o.reshape(B * N, H * D)
    if emit == "sym":
        smax = torch.clamp(torch.maximum(hi, -lo), min=1e-6)
        codes = torch.clamp(torch.round(rows * rdiv(127.0, smax)), -128, 127)
        sc, zp = divc(smax, 127.0), None
    else:
        sc = torch.clamp(divc(hi - lo, 255.0), min=1e-6)
        inv = rdiv(1.0, sc)
        zp = torch.round(-lo * inv) - 128.0
        codes = torch.clamp(torch.round(rows * inv) + zp, -128, 127)
    rowsum = codes.reshape(B * N, H, D).sum(-1).sum(-1, keepdim=True)
    got = (codes.to(torch.int8), sc, zp, rowsum)
    plain = A.attention_bnhd(t(q), t(k), t(v), 0.25, seg_len=seg, emit=True,
                             emit_sym=emit == "sym", need_rowsum=True)
    for g, w in zip(got, plain):
        assert (g is None) == (w is None)
        if g is not None:
            assert torch.equal(g.reshape(w.shape), w)
    want = interp(jattn.attention_bnhd_int8out, jnp.asarray(q),
                  jnp.asarray(k), jnp.asarray(v), scale=0.25, seg_len=seg,
                  emit_sym=emit == "sym", need_rowsum=True)
    check_rows(list(got), [None if w is None else t(w).reshape(-1, 1)
                           if w.shape[-1] == 1 else t(w).reshape(B * N, -1)
                           for w in want], sym=emit == "sym",
               scale_rtol=1e-5)


def test_int8_pv_kv_limit_is_gone():
    assert not hasattr(A, "INT8_PV_MAX_KV")
    src = (_build.CSRC.parent / "kernels" / "attention.py").read_text()
    assert "INT8_PV_MAX_KV" not in src and "1040" not in src
