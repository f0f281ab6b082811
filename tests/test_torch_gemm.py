"""The int8 GEMM core that K2 and K7b share (`csrc/int8_mma.cuh`), as far
as it can be checked without a card:

  * the weight layout it reads: every native `QuantLinear.w_int` is a
    [1, K, N] view of [1, N, K] storage (K-major) and stays so through
    `load_state_dict` (the bridge's way in), `pack_native_weights`,
    `copy.deepcopy` and `.to()`;
  * the wgmma accumulator fragment the epilogues index covers each output
    tile once;
  * the kernel's schedule (k32 wgmma steps over 128-byte k-tiles, a K tail,
    group-wise folds at k-group boundaries that may fall inside a k-tile),
    replayed on the CPU, gives exactly the plain versions' outputs: the
    int32 sums are exact and the f32 epilogue is the same sequence of
    operations, so the comparison is equality;
  * K2's emission group quantize (`int8_gemm.cu` `group_quant_kernel`):
    every group width the wrapper passes fits the row group a warp holds
    in registers, and the kernel's lane order of the absmax gives the plain
    version's codes and scales.
"""

import copy
import re

import numpy as np
import pytest
import torch

from viditq_tpu_torch.kernels import _build
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM
from viditq_tpu_torch.kernels._common import k_major
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.quant.qlinear import QuantLinear
from viditq_tpu_torch.utils.config import load_quant_config
from viditq_tpu_torch.utils.workload import build_model

SM8 = "configs/opensora/w8a8_tpu_fused_sm8.yaml"
DYN = "configs/opensora/w8a8_dynamic.yaml"
TINY_STDIT = {"model": dict(type="STDiT", hidden_size=64, depth=2,
                            num_heads=4, caption_channels=32,
                            model_max_length=8),
              "num_frames": 2, "image_size": (128, 256), "dtype": "fp32"}


def _native(model):
    mods = [m for m in model.modules()
            if isinstance(m, QuantLinear) and m.native]
    assert mods
    return mods


def _is_k_major(w_int):
    K, N = w_int.shape[1:]
    return w_int.stride() == (N * K, 1, K)


def _tiny(plan_path):
    plan = load_quant_config(plan_path)
    if plan_path == DYN:
        plan = plan.with_backend("native")
    model = build_model(TINY_STDIT, plan.resolver(), device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model


@pytest.mark.parametrize("plan", [SM8, DYN], ids=["sm8", "w8a8"])
def test_packed_weights_stay_k_major(plan):
    model = _tiny(plan)
    assert all(_is_k_major(m.w_int) for m in _native(model))
    calibrate_weight_tables(model)
    pack_native_weights(model)
    mods = _native(model)
    assert all(_is_k_major(m.w_int) for m in mods)
    assert any(m.w_int.abs().sum() > 0 for m in mods)
    # the packed codes are those of the fp kernel [K, N]
    m = mods[0]
    d = m.w_delta[m.lspec.weight.bit_idx, 0].reshape(1, -1)
    code = torch.round(m.kernel.float() / d)
    if not m.lspec.weight.sym:
        z = m.w_zp[m.lspec.weight.bit_idx, 0].reshape(1, -1)
        code = torch.clamp(code + z, 0, 255) - 128
    assert torch.equal(m.w_int[0], torch.clamp(code, -128, 127).to(torch.int8))
    for moved in (copy.deepcopy(model), model.to(torch.float64),
                  model.to("cpu", torch.bfloat16)):
        assert all(_is_k_major(m.w_int) for m in _native(moved))


def test_load_state_dict_fills_k_major_storage():
    # the bridge hands over [1, K, N] arrays in the JAX layout; loading them
    # copies the values into the K-major buffers
    src = _tiny(SM8)
    calibrate_weight_tables(src)
    pack_native_weights(src)
    sd = {k: v.contiguous().clone() for k, v in src.state_dict().items()}
    assert all(v.is_contiguous() for v in sd.values())
    dst = _tiny(SM8)
    dst.load_state_dict(sd)
    for name, m in dst.named_modules():
        if isinstance(m, QuantLinear) and m.native:
            assert _is_k_major(m.w_int)
            assert torch.equal(m.w_int, sd[f"{name}.w_int"])


# ---------------------------------------------------------------------------
# the wgmma accumulator fragment (int8_mma.cuh `acc_row` / `acc_col`)
# ---------------------------------------------------------------------------

def acc_row(warp, g, i):
    return 16 * warp + g + 8 * ((i >> 1) & 1)


def acc_col(t4, i):
    return 8 * (i >> 2) + 2 * t4 + (i & 1)


@pytest.mark.parametrize("bn", [128, 192])
def test_wgmma_fragment_covers_the_tile_once(bn):
    seen = np.zeros((64, bn), np.int32)
    for tid in range(128):  # one consumer warpgroup
        warp, g, t4 = tid >> 5, (tid & 31) >> 2, tid & 3
        for i in range(bn // 2):
            seen[acc_row(warp, g, i), acc_col(t4, i)] += 1
    assert (seen == 1).all()
    # the epilogue writes register pairs (i, i+1) as one 2-element store:
    # same row, adjacent columns
    for i in range(0, bn // 2, 2):
        assert acc_row(1, 3, i) == acc_row(1, 3, i + 1)
        assert acc_col(2, i) + 1 == acc_col(2, i + 1)


def test_fragment_formulas_are_the_cores():
    src = (_build.CSRC / "int8_mma.cuh").read_text()
    assert "return 16 * warp + g + 8 * ((i >> 1) & 1);" in src
    assert "return 8 * (i >> 2) + 2 * t4 + (i & 1);" in src


# ---------------------------------------------------------------------------
# the kernel's k schedule, replayed
# ---------------------------------------------------------------------------

BK, KSTEP = 128, 32  # bytes of k per ring slot, per wgmma


def _schedule_k2(xq, xs, w, ws, bias, G):
    """K2's tma_gemm_kernel order: k32 steps over the k-tiles (steps past K
    skipped), with group_wise scales a fold facc + float(acc) * xs[:, grp]
    before the first step of every new k-group and after the last step."""
    M, K = xq.shape
    kg = K // G
    acc = torch.zeros((M, w.shape[1]), dtype=torch.float64)
    facc = torch.zeros((M, w.shape[1]), dtype=torch.float32)
    for kt in range((K + BK - 1) // BK):
        for s in range(BK // KSTEP):
            kk = kt * BK + s * KSTEP
            if kk >= K:
                break
            if G > 1 and kk > 0 and kk % kg == 0:
                facc = facc + acc.float() * xs[:, kk // kg - 1:kk // kg]
                acc.zero_()
            acc += xq[:, kk:kk + KSTEP].double() @ w[kk:kk + KSTEP].double()
    if G > 1:
        facc = facc + acc.float() * xs[:, G - 1:G]
        out = facc * ws
    else:
        out = acc.float() * (xs * ws)
    return out + bias


@pytest.mark.parametrize("M,K,N,G", [(40, 576, 64, 3), (24, 4608, 48, 3),
                                     (33, 1152, 40, 1), (17, 576, 24, 1)],
                         ids=["gw-K576-boundary-in-tile", "gw-fc2-K4608",
                              "plain-K1152", "plain-K576-tail"])
def test_k2_schedule_matches_plain(M, K, N, G):
    g = torch.Generator().manual_seed(M + K)
    xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = k_major(torch.randint(-127, 128, (K, N), generator=g,
                              dtype=torch.int8))
    xs = torch.rand(M, G, generator=g) * 0.02
    ws = torch.rand(1, N, generator=g) * 1e-3
    bias = torch.randn(N, generator=g)
    want = FM.int8_consumer_matmul_plain(xq, xs, w, ws, bias,
                                         out_dtype=torch.float32,
                                         group_scales=G > 1)
    assert torch.equal(_schedule_k2(xq, xs, w, ws, bias, G), want)


@pytest.mark.parametrize("K", [1168, 72], ids=["K1168-tail16", "K72"])
def test_k7b_k_tail_zero_fill_matches_plain(K):
    # a K tail reads zeros past K (TMA's fill, the byte-wise kernel's
    # loads): the sums, and so the outputs, do not change
    g = torch.Generator().manual_seed(K)
    M, N = 21, 40
    xq = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, dtype=torch.int8)
    Kp = (K + BK - 1) // BK * BK
    xpad = torch.zeros((M, Kp), dtype=torch.int8)
    wpad = torch.zeros((Kp, N), dtype=torch.int8)
    xpad[:, :K], wpad[:K] = xq, w
    tabs = (torch.rand(M, 1, generator=g) * 0.05,
            torch.randint(-128, 128, (M, 1), generator=g).float(),
            xq.float().sum(1, keepdim=True), torch.rand(1, N, generator=g),
            torch.randint(-20, 20, (1, N), generator=g).float(),
            w.float().sum(0, keepdim=True))
    want = IM.int8_matmul_plain(xq, k_major(w), *tabs, torch.float32)
    acc = sum(xpad[:, k:k + KSTEP].double() @ wpad[k:k + KSTEP].double()
              for k in range(0, Kp, KSTEP)).float()
    xs, xzp, xrs, ws, wzp, wcs = tabs
    c = acc - xzp * wcs - wzp * xrs + K * xzp * wzp
    assert torch.equal((c * xs * ws), want)


@pytest.mark.parametrize("n", [1152, 2304, 4608, 1040, 6144],
                         ids=lambda n: f"N{n}")
def test_emission_groups_fit_the_group_quantize_kernel(n):
    # K2's emission quantizes each (row, group) from float4 held in the
    # registers of one warp: every group width the wrapper can pass (any N
    # the GEMM takes: N % 16 == 0) must be a multiple of 16 that divides N
    # and fits 32 lanes x GQ_VECS vectors of 4
    src = (_build.CSRC / "int8_gemm.cu").read_text()
    vecs = int(re.search(r"constexpr int GQ_VECS = (\d+);", src).group(1))
    for k in (1152, 4608):
        gw = FM.emit_groups(n, k)
        assert gw % 16 == 0 and n % gw == 0 and gw <= 32 * vecs * 4, (k, gw)


def _group_quant_lanes(y, gw):
    """group_quant_kernel's order on the CPU: lane l of the warp holds the
    float4 vectors l, l + 32, ...; the absmax is a max over the lanes' own
    maxima, then the codes of each vector."""
    M, N = y.shape
    G = N // gw
    codes = torch.empty((M, N), dtype=torch.int8)
    scales = torch.empty((M, G))
    for r in range(M):
        for grp in range(G):
            vec = y[r, grp * gw:(grp + 1) * gw].reshape(-1, 4)
            lane_max = [vec[l::32].abs().max() if len(vec[l::32]) else
                        torch.tensor(0.0) for l in range(32)]
            am = torch.stack(lane_max).max().reshape(1)
            s = torch.clamp(am * (1.0 / 127.0), min=1e-6)
            inv = torch.ones(1) / s
            q = torch.clamp(torch.round(vec * inv), -128, 127)
            codes[r, grp * gw:(grp + 1) * gw] = q.reshape(-1).to(torch.int8)
            scales[r, grp] = s
    return codes, scales


def test_group_quantize_lane_order_matches_plain():
    g = torch.Generator().manual_seed(3)
    M, K, N = 5, 1152, 4608
    gw = FM.emit_groups(N, K)
    y = FM.gelu_tanh(torch.randn(M, N, generator=g) * 3.0)
    bn = y.reshape(M, N // gw, gw)
    s = torch.clamp(bn.abs().amax(-1, keepdim=True) * (1.0 / 127.0), min=1e-6)
    want = torch.clamp(torch.round(bn * FM.rdiv(1.0, s)), -128, 127)
    codes, scales = _group_quant_lanes(y, gw)
    assert torch.equal(codes, want.reshape(M, N).to(torch.int8))
    assert torch.equal(scales, s.reshape(M, -1))


def test_gemm_tiles_divide_the_main_path_widths():
    # every tile width of K2, K5 and K7b divides the main path's N (1152,
    # 2304, 4608): no ragged last tile there. The epilogues (K2's sym one,
    # and the zero-point one of K7b and K2) are in the core, int8_mma.cuh;
    # K5's kernel has its own tile width
    for name in ("int8_mma.cuh", "dynq_gemm.cu"):
        src = (_build.CSRC / name).read_text()
        rules = re.findall(r"constexpr int BN = ([^;]*);", src)
        assert rules, name
        for width in map(int, re.findall(r"\d+", " ".join(rules))):
            assert all(n % width == 0 for n in (1152, 2304, 4608)), width
    assert "ZpEpilogue" in (_build.CSRC / "int_matmul.cu").read_text()
    assert "int8_gemm_epilogue" in (_build.CSRC / "int8_gemm.cu").read_text()
