"""Rules of the PyTorch port (`viditq_tpu_torch`) that hold without a GPU:
it never imports jax/flax, its wrappers run their plain versions on CPU
tensors without counting kernel launches, the modes the port does not
implement raise instead of computing something else (and the modes it
has ported since compute), plans resolve as in the JAX package, and
every CUDA source is bound and checked on the card."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from viditq_tpu_torch.kernels import _build, _counters
from viditq_tpu_torch.kernels import attention as A
from viditq_tpu_torch.kernels import fused_matmul as FM
from viditq_tpu_torch.kernels import int_matmul as IM

PKG = Path(__file__).resolve().parent.parent / "viditq_tpu_torch"


def _imported_roots(src: str):
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_port_never_imports_jax_or_flax():
    # an import check cannot work here: the image preloads jax
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                         PKG.parent / "chip_profile.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(PKG.parent)): sorted(
        r for r in set(_imported_roots(f.read_text()))
        if r in ("jax", "flax", "jaxlib", "optax", "viditq_tpu"))
        for f in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def _inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 32, 64, generator=g)
    sh, sc = torch.randn(2, 1, 64, generator=g), torch.randn(2, 1, 64,
                                                             generator=g)
    w = torch.randint(-127, 128, (64, 128), generator=g, dtype=torch.int8)
    ws = torch.rand(1, 128, generator=g) * 1e-3
    return x, sh, sc, w, ws


def test_cpu_tensors_run_plain_versions_and_count_no_launch():
    _counters.reset()
    x, sh, sc, w, ws = _inputs()
    q, s, _, _ = FM.ln_modulate_quantize(x, sh, sc)
    FM.int8_consumer_matmul(q, s, w, ws)
    FM.int8_consumer_matmul(q, s, w, ws, emit={"gelu": True})
    FM.quantize_rows(x.reshape(-1, 64))
    FM.fused_dynq_int8_matmul(x.reshape(-1, 64), w, ws)
    qh = x.reshape(2, 32, 4, 16)
    A.attention_bnhd(qh, qh, qh, 0.25, seg_len=4, int8_pv=True, emit=True)
    A.attention_bnhd(qh, qh, qh, 0.25)
    q = IM.dynamic_quant_rows(x.reshape(-1, 64))
    IM.int8_matmul(q[0], w, *q[1:], ws, ws, ws)
    IM.quantized_linear_native(x, {"w_q": w, "w_scale": ws, "w_zp": ws,
                                   "w_colsum": ws})
    snap = _counters.snapshot()
    assert all(v == {"launches": 0, "plain_cuda": 0} for v in snap.values()), \
        snap


def test_cpu_plain_results_match_direct_plain_calls():
    x, sh, sc, w, ws = _inputs(1)
    for sym in (True, False):
        got = FM.ln_modulate_quantize(x, sh, sc, sym=sym, need_rowsum=True)
        want = FM.ln_modulate_quantize_plain(x, sh, sc, sym=sym,
                                             need_rowsum=True)
        assert [a is None for a in got] == [False, False, sym, False]
        assert all(a is b is None or torch.equal(a, b)
                   for a, b in zip(got, want))


def _k2_residual(x, sh, sc, w, ws):
    q, s = FM.quantize_rows(x[0])[:2]
    res = sc.reshape(2, 64).repeat(16, 2)
    got = FM.int8_consumer_matmul(q, s, w, ws, residual=res)
    out = FM.int8_consumer_matmul(q, s, w, ws, out_dtype=torch.float32)
    return got, (out + res).to(torch.bfloat16)


def _k5_gate(x, sh, sc, w, ws):
    res, gate = sh.reshape(2, 64).repeat(16, 2), sc.reshape(2, 64).repeat(
        1, 2)
    got = FM.fused_dynq_int8_matmul(x[0], w, ws, residual=res, gate=gate)
    out = FM.fused_dynq_int8_matmul(x[0], w, ws, out_dtype=torch.float32)
    return got, (out * gate.repeat_interleave(16, 0) + res).to(torch.bfloat16)


def _k3_int8_qk(x, sh, sc, w, ws):
    q = x.reshape(2, 32, 4, 16)
    k = sh.reshape(2, 1, 4, 16).repeat(1, 8, 1, 1) * x[:, :8].reshape(
        2, 8, 4, 16)
    got = A.attention_bnhd(q, k, k, 0.25, int8_qk=True)
    qd, kd = A.qk_headwise_quant(q, k)
    return got, A.attention_bnhd(qd, kd, k, 0.25)


@pytest.mark.parametrize("call", [_k2_residual, _k5_gate, _k3_int8_qk],
                         ids=["k2-residual", "k5-gate", "k3-int8_qk"])
def test_unported_modes_raise(call):
    # these modes raised NotImplementedError until they were ported; each
    # now computes what its formula says: K2 and K5 `res + gate * out` in
    # f32 before the one cast, K3 on q and k quantize-dequantized by K8
    got, want = call(*_inputs())
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_unported_plans_raise_at_model_construction():
    # simulate, static acts, weight-only and the q-diffusion split raised
    # NotImplementedError until they were ported: each now builds its path
    # and computes what the JAX package computes (the parity cases:
    # tests/test_torch_simulate.py, test_torch_static.py); what still
    # raises is below
    from viditq_tpu_torch.quant.calibrate import finalize_act_tables
    from viditq_tpu_torch.quant.qlinear import QuantCtx, QuantLinear
    from viditq_tpu_torch.utils.config import load_quant_config
    spec = load_quant_config(
        "configs/opensora/w8a8_tpu_fused_sm8.yaml").default_layer
    static = dataclasses.replace(spec, act=dataclasses.replace(
        spec.act, dynamic=False))
    simulate = dataclasses.replace(spec, backend="simulate")
    for case, path in ((simulate, "simulate"), (static, "native_static"),
                       (dataclasses.replace(spec, act_quant=False),
                        "weight_only"),
                       (dataclasses.replace(simulate, split=2), "simulate")):
        lin = QuantLinear(64, 64, case, dtype=torch.float32)
        assert lin.path == path
        with torch.no_grad():
            lin.kernel.normal_()
            lin.w_delta.fill_(0.05)
            lin.w_zp.zero_()
            x = torch.randn(2, 8, 64)
            if lin.static_act:  # per-token tables from one a_calib pass
                lin(x, QuantCtx(mode="a_calib"))
                finalize_act_tables(lin)
            out = lin(x, QuantCtx())
        assert out.shape == (2, 8, 64) and torch.isfinite(out).all()
    QuantLinear(64, 64, spec)  # the sm8 layer spec is ported
    # still raising: stochastic rounding, AdaRound, the grid-search scale
    # method (the PTQ slice) and the 'dynamic' CB type on native (as JAX)
    for bad in (dataclasses.replace(simulate, weight=dataclasses.replace(
                    spec.weight, round_mode="stochastic")),
                dataclasses.replace(simulate, weight=dataclasses.replace(
                    spec.weight, round_mode="learned_hard_sigmoid")),
                dataclasses.replace(simulate, weight=dataclasses.replace(
                    spec.weight, scale_method="grid_search_lp")),
                dataclasses.replace(simulate, act=dataclasses.replace(
                    spec.act, scale_method="grid_search_lp"))):
        with pytest.raises(NotImplementedError):
            QuantLinear(64, 64, bad)
    with pytest.raises(NotImplementedError):
        QuantLinear(64, 64, load_quant_config(
            "configs/opensora/w4a8_adaround.yaml").default_layer)
    dyn_cb = dataclasses.replace(spec, smooth_quant=type(spec.smooth_quant)(
        enable=True, channel_wise_scale_type="dynamic"))
    with pytest.raises(ValueError, match="momentum"):
        QuantLinear(64, 64, dyn_cb)
    # so is the native backend with any other impl
    for impl in (None, "xla", "mixed", "pallas"):
        assert not QuantLinear(64, 64, dataclasses.replace(
            spec, impl=impl)).fused


def test_with_backend_resolves_like_jax():
    from test_torch_quant import LAYERS
    from viditq_tpu.utils.config import load_quant_config as j_load
    from viditq_tpu_torch.utils.config import load_quant_config
    for plan in ("configs/opensora/w8a8_dynamic.yaml",
                 "configs/opensora/w8a8_tpu_fused_sm8.yaml"):
        # 'simulate' raised until the simulate backend was ported
        for backend in ("native", "fused", "simulate"):
            jres = j_load(plan).with_backend(backend).resolver()
            pres = load_quant_config(plan).with_backend(backend).resolver()
            for name in LAYERS:
                assert (dataclasses.asdict(pres(name))
                        == dataclasses.asdict(jres(name))), (plan, name)
    assert load_quant_config(plan).with_backend(
        "simulate").default_layer.backend == "simulate"


def test_hybrid_plan_overrides_raise_at_load():
    # the hybrid plans raised at load until `backend_overrides` was
    # ported: they now resolve per module group as in the JAX package
    from test_torch_quant import LAYERS
    from viditq_tpu.utils.config import load_quant_config as j_load
    from viditq_tpu_torch.utils.config import load_quant_config
    for plan in ("configs/opensora/w8a8_tpu_hybrid.yaml",
                 "configs/opensora/w8a8_tpu_hybrid_sym.yaml"):
        jp, pp = j_load(plan), load_quant_config(plan)
        assert pp.backend_overrides == jp.backend_overrides == (
            ("mlp", "native"), ("attn", "weight_only"),
            ("attn_temp", "weight_only"), ("cross_attn", "weight_only"))
        assert pp.uses_native() and jp.uses_native()
        jres, pres = jp.resolver(), pp.resolver()
        for name in LAYERS:
            assert (dataclasses.asdict(pres(name))
                    == dataclasses.asdict(jres(name))), (plan, name)
        mlp, attn = pres("blocks.5.mlp.fc2"), pres("blocks.5.attn_temp.v")
        assert (mlp.backend, mlp.act_quant) == ("native", True)
        assert (attn.backend, attn.act_quant) == ("native", False)


def test_every_kernel_source_is_bound_and_checked_on_the_card():
    import re
    import chip_smoke
    exported = set()
    for src in _build.CSRC.glob("*.cu"):
        names = re.findall(r"VQ_EXPORT int (\w+)\(", src.read_text())
        assert names, src.name
        exported |= set(names)
        rel = f"viditq_tpu_torch/csrc/{src.name}"
        assert rel in chip_smoke.SOURCES.values(), rel
    assert exported == set(_build.SIGNATURES)
    assert set(chip_smoke.SOURCES) == set(chip_smoke.REPLACES) == set(
        _counters.COUNTERS)
    assert chip_smoke.SOURCES["dynamic_quant_rows"] == \
        chip_smoke.SOURCES["int8_matmul"] == \
        "viditq_tpu_torch/csrc/int_matmul.cu"
    assert chip_smoke.REPLACES["dynamic_quant_rows"].endswith(
        "int_matmul.py:72")
    assert chip_smoke.REPLACES["int8_matmul"].endswith("int_matmul.py:142")


def test_emission_group_rule_matches_runtime_call():
    # C1: fc1 at STDiT-XL ([*, 1152] x [1152, 4608]) emits 3 groups of 1536
    assert FM.emit_groups(4608, 1152) == 1536
    assert FM.emission_block_n(4608, 512, 1152) == 1536
    assert np.all([FM.select_block_k(k, 2304) == min(k, 2304)
                   for k in (1152, 2304, 4608)])


TINY_SIGMA_CFG = {
    "model": dict(type="PixArt", hidden_size=64, depth=2,
                  num_heads=4, caption_channels=32, model_max_length=8,
                  kv_compress_sampling="conv", kv_compress_scale=2,
                  kv_compress_layers=(1,)),
    "image_size": 256,
    "scheduler": dict(type="dpm-solver", num_sampling_steps=20,
                      cfg_scale=4.5),
    "dtype": "fp32",
}


def test_workload_build_model_defaults_to_cuda_and_never_falls_back(
        monkeypatch):
    import inspect
    from viditq_tpu_torch.utils import workload
    assert (inspect.signature(workload.build_model).parameters["device"]
            .default == "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        workload.build_model(TINY_SIGMA_CFG)
    model = workload.build_model(TINY_SIGMA_CFG, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert model.input_size == 32 and len(model.blocks) == 2
    assert model.blocks[1].kv_compress and not model.blocks[0].kv_compress


def test_workload_build_sampler():
    from viditq_tpu_torch.samplers.dpm_solver import DPMSolverSampler
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    from viditq_tpu_torch.utils import workload
    s = workload.build_sampler(TINY_SIGMA_CFG, cfg_split=True)
    assert isinstance(s, DPMSolverSampler)
    assert s.cfg_split and s.cfg_scale == 4.5 and s.steps == 20
    s = workload.build_sampler({"scheduler": dict(type="iddpm",
                                                  num_sampling_steps=3)})
    assert isinstance(s, IDDPM) and not s.cfg_split
    assert workload.latent_size({"image_size": 1024}) == (128, 128)
    assert workload.latent_size({"num_frames": 16,
                                 "image_size": (512, 512)}) == (16, 64, 64)


@pytest.mark.parametrize("kw", [dict(micro_condition=True),
                                dict(qk_norm=True),
                                dict(kv_compress_sampling="ave",
                                     kv_compress_scale=2,
                                     kv_compress_layers=(0,))],
                         ids=["micro_condition", "qk_norm", "kv-ave"])
def test_unported_pixart_options_raise(kw):
    from viditq_tpu_torch.models.pixart import PixArt
    with pytest.raises(NotImplementedError):
        PixArt(input_size=8, hidden_size=32, depth=1, num_heads=2,
               caption_channels=8, **kw)


def test_chip_smoke_carries_the_attention_edge_cases():
    import chip_smoke
    cases = [(name, p) for name, _, p in chip_smoke.EDGE_CASES]
    one_shot = [p for name, p in cases if name == "attention_bnhd"]
    stream = [p for name, p in cases if name == "attention_bnhd_stream"]
    # ragged q and kv tiles: full attention at N = M = 1000, bf16 PV and
    # int8 PV with emission
    assert any(p["N"] == p["M"] == 1000 and not p["int8_pv"]
               for p in one_shot)
    assert any(p["N"] == p["M"] == 1000 and p["int8_pv"] and p["emit"]
               for p in one_shot)
    # K6 at N = M = 2304, kv blocks of 256, one of them masked whole
    assert any(p["N"] == p["M"] == 2304 and p["bkv"] == 256
               and "masked" in p and p["masked"][0] % 256 == 0
               and p["masked"][1] - p["masked"][0] >= 256 for p in stream)
    # the tiny models' head dim, in both kernels
    assert any(p["D"] == 16 for p in one_shot)
    assert any(p["D"] == 16 for p in stream)
    assert "attention_edge_cases(records" in Path(
        chip_smoke.__file__).read_text()
    # seg mode: the tiled kernel at the tiny STDiT's seg 2 (D = 16) and at
    # seg 16 with D = 16, a ragged last 16-row tile with int8 PV and
    # emission, asym emission with row sums, seg 16 over an odd tile count;
    # the row kernel's int8 PV past 1040 kv rows (seg 1088, v_block 1088)
    # and its two-launch emission, sym and asym
    seg = [p for p in one_shot if p.get("seg")]
    tiled = [p for p in seg if A.SEG_TILE % p["seg"] == 0]
    assert any(p["seg"] == 2 and p["D"] == 16 for p in tiled)
    assert any(p["seg"] == 16 and p["D"] == 16 for p in tiled)
    assert any(p["N"] % A.SEG_TILE and p["int8_pv"] and p["emit"]
               for p in tiled)
    assert any(p["emit"] and p.get("emit_sym") is False for p in tiled)
    assert any(p["seg"] == 16 and (p["N"] // A.SEG_TILE) % 2 for p in tiled)
    assert any(p["seg"] == p.get("v_block") == 1088 and p["int8_pv"]
               for p in seg)
    rows = [p for p in seg if A.SEG_TILE % p["seg"]]
    assert any(p["emit"] and p.get("emit_sym", True) for p in rows)
    assert any(p["emit"] and p.get("emit_sym") is False for p in rows)


def test_attention_kernels_share_the_wgmma_core():
    core = (_build.CSRC / "attn_core.cuh").read_text()
    assert "wgmma.mma_async" in core and "cp.async" in core
    for name in ("attention.cu", "attention_stream.cu"):
        assert '#include "attn_core.cuh"' in (_build.CSRC / name).read_text()
    assert "mma.sync" not in (_build.CSRC / "attention_stream.cu").read_text()


def test_int8_gemms_share_the_tma_wgmma_core():
    core = (_build.CSRC / "int8_mma.cuh").read_text()
    assert "wgmma.mma_async" in core and ".s32.s8.s8" in core
    assert "cp.async.bulk.tensor" in core and "mbarrier" in core
    assert "setmaxnreg" in core
    for name in ("int8_gemm.cu", "int_matmul.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "int8_mma.cuh"' in src
        assert "mma.sync" not in src
    # the weight arrives K-major: no byte transpose is left anywhere
    assert not [s.name for s in _build.sources()
                if "__byte_perm" in s.read_text()]


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so a wrapper takes its
    CUDA path up to the launch (no device is touched: see _no_launch)."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def _no_launch(monkeypatch):
    class Launched(Exception):
        pass

    def lib():
        raise Launched()
    monkeypatch.setattr(_build, "lib", lib)
    return Launched


def _gemm_calls(k_major):
    g = torch.Generator().manual_seed(0)
    M, K, N = 32, 128, 64
    xq = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    w = w.t().contiguous().t() if k_major else w.contiguous()
    xs, ws = torch.rand(M, 1, generator=g), torch.rand(1, N, generator=g)
    wz, wc = torch.zeros(1, N), w.float().sum(0, keepdim=True)
    card = [t.as_subclass(_OnCard) for t in (xq, w, xs, ws, wz, wc)]
    xq, w, xs, ws, wz, wc = card
    return {
        "k2": lambda: FM.int8_consumer_matmul(xq, xs, w, ws),
        "k2-emit": lambda: FM.int8_consumer_matmul(xq, xs, w, ws,
                                                   emit={"gelu": False}),
        "k2-gw_x": lambda: FM.int8_consumer_matmul(
            xq, torch.cat([xs, xs], 1), w, ws, group_scales=True),
        "k7b": lambda: IM.int8_matmul(xq, w, xs, xs, xs, ws, wz, wc),
    }


@pytest.mark.parametrize("call", ["k2", "k2-emit", "k2-gw_x", "k7b"])
def test_cuda_gemm_wrappers_take_only_k_major_weights(call, _no_launch):
    # a row-major w_q raises before any launch (no per-call transpose on
    # the card); a K-major one passes every check and reaches the launch
    with pytest.raises(ValueError, match="K-major"):
        _gemm_calls(False)[call]()
    with pytest.raises(_no_launch):
        _gemm_calls(True)[call]()


def test_chip_smoke_carries_the_gemm_edge_cases():
    import chip_smoke
    cases = chip_smoke.GEMM_EDGE_CASES
    k2 = [p for name, _, p in cases if name == "int8_consumer_matmul"]
    k7b = [p for name, _, p in cases if name == "int8_matmul"]
    assert any(p["M"] == 240 for p in k2)                       # kv_linear
    assert any((p["M"], p["K"], p["N"]) == (19, 72, 40) for p in k7b)
    assert any(p["N"] % 192 for p in k2) and any(p["N"] % 192 for p in k7b)
    assert any(p["K"] % 128 for p in k2) and any(p["K"] % 128 for p in k7b)
    assert any(p.get("G") == 3 and (p["K"] // 3) % 128 for p in k2)
    assert any(p.get("offset") for p in k7b)
    src = Path(chip_smoke.__file__).read_text()
    assert "gemm_edge_cases(records" in src
    # every K2 and K7b case is held identical to its plain version
    body = src[src.index("def gemm_edge_cases"):]
    assert "exact=True" in body[:body.index("\ndef ")]
    for case in ('"plain [32768,1152]x[1152,1152]"',
                 '"emit [32768,1152]x[1152,4608]"',
                 '"gw_x [32768,4608]x[4608,1152]"',
                 'check_case("int8_matmul", case,'):
        call = src[src.index(case):]
        assert "exact=True" in call[:call.index("\n\n")], case


def test_chip_smoke_carries_the_row_edge_cases():
    import chip_smoke
    cases = chip_smoke.ROW_EDGE_CASES
    k4 = [p for name, _, p in cases if name == "quantize_rows"]
    k1 = [p for name, _, p in cases if name == "ln_modulate_quantize"]
    # K4: f32 and bf16 at Σ's K6 emission shape, ragged K, K5's 240 rows,
    # the GELU on 19 rows both ways, rows of zeros, rows read in passes and
    # rows that are not 16-byte aligned
    assert any(p.get("f32") and (p["M"], p["K"]) == (8192, 1152) for p in k4)
    assert any(not p.get("f32") and (p["M"], p["K"]) == (8192, 1152)
               for p in k4)
    assert {72, 1000} <= {p["K"] for p in k4}
    assert any((p["M"], p["K"]) == (240, 1152) for p in k4)
    assert {True, False} <= {p["sym"] for p in k4
                             if p.get("gelu") and (p["M"], p["K"]) == (19,
                                                                       4608)}
    assert any(p.get("zero_rows") for p in k4)
    assert any(p["K"] > 12288 for p in k4)
    assert any(p["K"] * 2 % 16 for p in k4)
    # K1: f32 input, C = 64, rows crossing the batch boundary inside a
    # block of 8 rows, C % 4 != 0, a row wider than one read
    assert any(p.get("f32") for p in k1)
    assert any(p["C"] == 64 for p in k1)
    assert any(p["B"] == 2 and p["N"] == 19 for p in k1)
    assert any(p["C"] % 4 for p in k1) and any(p["C"] > 1152 for p in k1)
    src = Path(chip_smoke.__file__).read_text()
    assert "row_edge_cases(records)" in src
    body = src[src.index("def row_edge_cases"):]
    body = body[:body.index("\ndef ")]
    # K4 asym identical, K1 asym rows by ASYM_TOL["ln"], each timed back to
    # back beside one call
    assert "exact=not sym" in body and 'ASYM_TOL["ln"]' in body
    assert "b2b=True" in body


def test_chip_smoke_carries_the_mp_and_sigma_cb_arms():
    import inspect
    import chip_smoke as cs
    # cb_mp samples the cb arm's model through the MP sampler: the fused
    # kernels, cb's per-block launches, held equal to cb's in the run
    assert cs.SLICE_KERNELS["stdit"]["cb_mp"] == cs.FUSED_KERNELS
    arms = list(cs.SLICE_KERNELS["stdit"])
    assert arms.index("cb_mp") == arms.index("cb") + 1
    assert cs.MP_ARMS[("stdit", "cb_mp")] == ("cb", cs.MP_WEIGHT, cs.MP_ACT)
    assert cs.arm_build("stdit", "cb_mp") == cs.arm_build("stdit", "cb")
    assert cs.BLOCK_LAUNCHES[("stdit", "cb_mp")] == cs.BLOCK_LAUNCHES[
        ("stdit", "cb")]
    for f in (cs.MP_WEIGHT, cs.MP_ACT):
        assert f.exists()
    run = inspect.getsource(cs.run_slice)
    for part in ("mp_report(", "mp_run(model, z, y, mask)",
                 "sum(lo <= tt <= hi for tt in tmap)",
                 "'s {want}", "tr_steps != want"):
        assert part in run, part
    report = inspect.getsource(cs.mp_report)
    assert "GatherMPSampler" in report and "n_ranges" in report
    # Σ cb: the Σ W4A8 plan on the fused kernels with K6, calibrated at
    # t = 500; keyed by slice, so no STDiT arm's plan changed
    assert cs.SLICE_KERNELS["sigma"]["cb"] == cs.FUSED_KERNELS + (
        "attention_bnhd_stream",)
    assert cs.arm_build("sigma", "cb") == (cs.SIGMA_CB_PLAN, "cb", ())
    assert cs.arm_build("stdit", "cb") == (cs.CB_PLAN, "cb", ())
    assert cs.STAT_T == {"stdit": (250, 750), "sigma": (500,)}
    d = cs.quant_plan(cs.SIGMA_CB_PLAN, "cb").default_layer
    assert (d.backend, d.impl, d.weight.n_bits) == ("native", "fused", 6)
    assert d.smooth_quant.qkv_share_cs and d.smooth_quant.alpha == (
        cs.SIGMA_CB_ALPHA,)
    assert "stat_t=STAT_T[name]" in run
    # K6's +cs emission through K4 at the Σ shape, beside the same call
    # without the scale
    src = inspect.getsource(cs.cb_cases)
    # and K5 at its patch embed (K = 16) and final linear (N = 32)
    for part in ("Σ cb [2,4096,16,72] col_scale asym emit (K6->K4)",
                 "col_scale=ics_s", 'ASYM_TOL["stream"]',
                 'with_and_without("attention_bnhd_stream"',
                 "Σ cb x_embedder [8192,16]x[16,1152] W6",
                 "Σ cb final_layer [8192,1152]x[1152,32] W6",
                 "fused_dynq_int8_matmul_plain(xa, wa, wsa, ba,"):
        assert part in src, part
    # the tiny cb_mp (gather), segmented-MP and Σ-cb models card vs CPU
    ref = inspect.getsource(cs.phase_reference)
    for part in ('SIGMA_CB_PLAN, "cb")', '"native_nocb")',
                 "retile(MP_WEIGHT, 2)", "tiny_verdict(", "GatherMPSampler"):
        assert part in ref, part
    assert "TINY_REL_ERR" in inspect.getsource(cs.tiny_verdict)
    # chip_profile profiles every arm of both slices, cb_mp's union model
    prof = (Path(cs.__file__).parent / "chip_profile.py").read_text()
    for part in ("cs.arm_build(name, arm)", "cs.MP_ARMS",
                 "cs.mp_report(", "profile_forward(runner",
                 "stat_t=cs.STAT_T[name]"):
        assert part in prof, part


def test_chip_smoke_mp_helpers_on_the_cpu():
    import chip_smoke as cs
    from viditq_tpu_torch.pipelines import mixed_precision as mp
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    # retiling the t20 ranges onto 2 steps, as the JAX bench's tiny mode
    w = cs.retile(cs.MP_WEIGHT, 2)
    assert list(w) == ["0-0", "1-1"]
    assert w["1-1"]["model.blocks.0.attn.q"] == 4
    assert w["0-0"]["model.blocks.27.mlp.fc2"] == 8
    sampler = IDDPM(num_sampling_steps=2)
    for recipe, kind in (("cb", mp.GatherMPSampler),
                         ("native_nocb", mp.SegmentedMPSampler)):
        run = cs.mp_sampler(cs.TINY_STDIT_CFG, "cpu",
                            cs.quant_plan(cs.CB_PLAN, recipe), sampler, w)
        assert isinstance(run, kind), recipe
    run = cs.mp_sampler(cs.STDIT_CFG, "cpu", cs.quant_plan(cs.CB_PLAN, "cb"),
                        IDDPM(num_sampling_steps=cs.STEPS), cs.MP_WEIGHT,
                        cs.MP_ACT)
    assert run.spans == ((0, 236), (237, 499), (500, 500), (501, 762),
                         (763, 1000))


def test_chip_smoke_draws_the_same_fp_weights_under_every_plan():
    # the Σ W4A8 plan quantizes the patch embed and the final linear, which
    # the sm8 plan keeps in fp: their quant tables must not move the draws
    # of the parameters after them (every arm's error is against bf16 on
    # the sm8 plan's model)
    import chip_smoke as cs
    from viditq_tpu_torch.utils.workload import build_model
    models = []
    for plan, recipe in ((cs.SM8_PLAN, None), (cs.SIGMA_CB_PLAN, "cb")):
        m = build_model(cs.TINY_SIGMA_CFG,
                        cs.quant_plan(plan, recipe).resolver(), device="cpu")
        cs.random_init_(m, 0, 0.02)
        models.append(dict(m.named_parameters()))
    assert models[0].keys() == models[1].keys()
    for k, p in models[0].items():
        assert torch.equal(p, models[1][k]), k


def test_chip_smoke_carries_the_reference_plan_arms():
    import chip_smoke as cs
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    stdit = cs.SLICE_KERNELS["stdit"]
    # the simulate arms launch K3 alone; naive_fused K2 on static codes;
    # hybrid K7a -> K7b at the MLP; each held to its per-block count
    for arm in ("sim_w8a8", "sim_w6a6", "naive"):
        assert stdit[arm] == ("attention_bnhd",)
        assert cs.BLOCK_LAUNCHES[("stdit", arm)] == {"attention_bnhd": 3}
    assert cs.BLOCK_LAUNCHES[("stdit", "naive_fused")] == {
        "int8_consumer_matmul": 13, "attention_bnhd": 3}
    assert cs.BLOCK_LAUNCHES[("stdit", "hybrid")] == {
        "dynamic_quant_rows": 2, "int8_matmul": 2, "attention_bnhd": 3}
    assert cs.SLICE_KERNELS["sigma"]["naive"] == ("attention_bnhd",
                                                   "attention_bnhd_stream")
    # the plans as written (naive_fused: naive's tables on impl 'fused')
    for (sl, arm), plan in (
            (("stdit", "sim_w8a8"), "opensora/viditq_w8a8.yaml"),
            (("stdit", "sim_w6a6"), "opensora/viditq_w6a6.yaml"),
            (("stdit", "naive"), "opensora/w8a8_naive.yaml"),
            (("stdit", "hybrid"), "opensora/w8a8_tpu_hybrid.yaml"),
            (("sigma", "naive"), "pixart_sigma/w8a8_naive.yaml")):
        got = cs.arm_build(sl, arm)
        assert got[0] == cs.ROOT / "configs" / plan and got[1] is None
    assert cs.arm_build("stdit", "naive_fused")[1] == "fused"
    assert cs.TABLES_FROM == {("stdit", "naive_fused"): "naive"}
    assert cs.LOW_BIT_ARMS == {("stdit", "sim_w6a6"): "sim_w8a8"}
    d = cs.quant_plan(cs.NAIVE_PLAN, "fused").default_layer
    assert (d.backend, d.impl, d.act.dynamic) == ("native", "fused", False)
    assert cs.static_acts(cs.quant_plan(cs.SIGMA_NAIVE_PLAN))
    assert not cs.static_acts(cs.quant_plan(cs.SIM_W8A8_PLAN))
    # the sampler: an arm that runs its plan as written takes the plan's
    # cfg_split (viditq_w8a8 and the hybrid plan set it), the earlier arms
    # the joint CFG batch
    for arm, split in (("sim_w8a8", True), ("hybrid", True),
                       ("sim_w6a6", False), ("naive", False),
                       ("w8a8", False), ("bf16", False)):
        assert cs.arm_sampler("stdit", arm, cs.TINY_STDIT_CFG).cfg_split \
            == split, arm
    # the static-act set-up on tiny CPU models: naive calibrates through
    # run_ptq over the fp trajectory, naive_fused takes naive's tables, a
    # dynamic-act arm has none; a forward's context carries t's slot
    x, _, y, mask = cs.tiny_inputs(cs.TINY_STDIT_CFG)
    sampler = IDDPM(num_sampling_steps=3, cfg_scale=4.0)
    tables, models, got = {}, {}, {}
    for arm in ("naive", "naive_fused", "sim_w8a8"):
        plan, recipe, _ = cs.arm_build("stdit", arm)
        models[arm] = cs.build_model(cs.TINY_STDIT_CFG, "cpu", scale=0.1,
                                     plan=plan, recipe=recipe)
        got[arm] = cs.arm_static_setup("stdit", arm, models[arm], sampler,
                                       x[:1], y, mask[:1], tables)
    slot_map, calib_ts, _ = got["naive"]
    assert sorted(calib_ts) == sorted(
        int(t) for t in sampler.schedule.timestep_map)
    assert got["naive_fused"][1] is None
    np.testing.assert_array_equal(got["naive_fused"][0], slot_map)
    assert got["sim_w8a8"] == (None, None, 0.0)
    assert set(tables) == {"naive", "naive_fused"}
    lin = {a: models[a].blocks[0].mlp.fc1 for a in models}
    assert lin["naive"].path == "simulate"
    assert lin["naive_fused"].path == "native_static"
    for k in ("a_delta", "a_zp", "w_delta"):
        assert torch.equal(getattr(lin["naive_fused"], k),
                           getattr(lin["naive"], k)), k
    assert cs.qctx_for("bf16", 999, None) is None
    q = cs.qctx_for("naive", 999, slot_map)
    assert (q.t_id, q.mode, q.act_slot) == (999, "quant", slot_map[999])
    assert cs.qctx_for("sim_w8a8", 999, None).act_slot == 0
