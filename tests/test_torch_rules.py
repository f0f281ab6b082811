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
    # an import check cannot work here: the image preloads jax (nor optax
    # and orbax, the JAX package's training and checkpoint libraries)
    files = sorted(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py",
                                         PKG.parent / "chip_profile.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(PKG.parent)): sorted(
        r for r in set(_imported_roots(f.read_text()))
        if r in ("jax", "flax", "jaxlib", "optax", "orbax", "viditq_tpu"))
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


def _k2_zp_emit(x, sh, sc, w, ws):
    # asym acts, their zero-point epilogue, then the GELU and the one
    # group's row quantize (fused_matmul.py:352-378)
    q, s, zp, rs = FM.quantize_rows(x[0] + 0.3, sym=False)
    kw = dict(x_zp=zp, x_rowsum=rs, w_colsum=w.float().sum(0, keepdim=True))
    got = FM.int8_consumer_matmul(q, s, w, ws, emit={"gelu": True}, **kw)
    y = FM.gelu_tanh(FM.int8_consumer_matmul(q, s, w, ws,
                                             out_dtype=torch.float32, **kw))
    scale = torch.clamp(y.abs().amax(-1, keepdim=True) * (1.0 / 127.0),
                        min=1e-6)
    codes = torch.clamp(torch.round(y * (torch.ones_like(scale) / scale)),
                        -128, 127).to(torch.int8)
    return torch.cat([got[0].float(), got[1]], 1), torch.cat(
        [codes.float(), scale], 1)


def _k3_int8_qk(x, sh, sc, w, ws):
    q = x.reshape(2, 32, 4, 16)
    k = sh.reshape(2, 1, 4, 16).repeat(1, 8, 1, 1) * x[:, :8].reshape(
        2, 8, 4, 16)
    got = A.attention_bnhd(q, k, k, 0.25, int8_qk=True)
    qd, kd = A.qk_headwise_quant(q, k)
    return got, A.attention_bnhd(qd, kd, k, 0.25)


@pytest.mark.parametrize("call", [_k2_residual, _k5_gate, _k3_int8_qk,
                                  _k2_zp_emit],
                         ids=["k2-residual", "k5-gate", "k3-int8_qk",
                              "k2-zp-emit"])
def test_unported_modes_raise(call):
    # these modes raised NotImplementedError until they were ported; each
    # now computes what its formula says: K2 and K5 `res + gate * out` in
    # f32 before the one cast, K3 on q and k quantize-dequantized by K8,
    # K2's emission after its zero-point epilogue (codes beside scales)
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
    # stochastic rounding, AdaRound, the grid-search scale method and the
    # AdaRound plan raised NotImplementedError until they were ported:
    # each now builds, calibrates and runs its simulate path (the parity
    # cases: tests/test_torch_quant_modes.py, test_torch_recon.py); the
    # 'dynamic' CB type on native still raises (as JAX)
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    for case in (dataclasses.replace(simulate, weight=dataclasses.replace(
                     spec.weight, round_mode="stochastic")),
                 dataclasses.replace(simulate, weight=dataclasses.replace(
                     spec.weight, round_mode="learned_hard_sigmoid")),
                 dataclasses.replace(simulate, weight=dataclasses.replace(
                     spec.weight, scale_method="grid_search_lp")),
                 dataclasses.replace(simulate, act=dataclasses.replace(
                     spec.act, scale_method="grid_search_lp")),
                 load_quant_config(
                     "configs/opensora/w4a8_adaround.yaml").default_layer):
        lin = QuantLinear(64, 64, case, dtype=torch.float32)
        assert lin.path == "simulate"
        assert lin.adaround == (case.weight.round_mode
                                == "learned_hard_sigmoid")
        with torch.no_grad():
            lin.kernel.normal_()
        calibrate_weight_tables(lin)
        out = lin(torch.randn(2, 8, 64), QuantCtx(
            generator=torch.Generator().manual_seed(0)))
        assert out.shape == (2, 8, 64) and torch.isfinite(out).all()
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
                                     kv_compress_layers=(0,)),
                                dict(kv_compress_sampling="uniform_every",
                                     kv_compress_scale=2,
                                     kv_compress_layers=(0,))],
                         ids=["micro_condition", "qk_norm", "kv-ave",
                              "kv-uniform_every"])
def test_unported_pixart_options_raise(kw):
    """PixArt's options that raised NotImplementedError before they were
    ported now build and run one tiny forward (C = 48: the micro-condition
    takes C // 3 channels for each of three sizes); their parity with the
    JAX package is in tests/test_torch_pixart_options.py."""
    import torch
    from viditq_tpu_torch.models.pixart import PixArt
    from viditq_tpu_torch.utils import workload
    model = PixArt(input_size=8, hidden_size=48, depth=1, num_heads=3,
                   caption_channels=8, model_max_length=4,
                   dtype=torch.float32, **kw)
    workload.random_init_(model, 0, 0.1)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 8, 8, generator=g)
    y = torch.randn(2, 1, 4, 8, generator=g)
    info = {"img_hw": torch.tensor([[64.0, 64.0]]),
            "aspect_ratio": torch.tensor([[1.0]])}
    with torch.no_grad():
        out = model(x, torch.tensor([10, 500]), y,
                    torch.ones(2, 4, dtype=torch.int32), data_info=info)
    assert out.shape == (2, 8, 8, 8) and torch.isfinite(out).all()
    if kw.get("micro_condition"):
        with pytest.raises(ValueError):
            model(x, torch.tensor([10, 500]), y)  # data_info is required


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
    assert cs.STAT_T == {"stdit": (250, 750), "sigma": (500,),
                         "latte": (250, 750), "dit": (), "mmdit": (),
                         # DiT-L/2 and the plan slices
                         "dit_l": (), "stdit_plans": (250, 750),
                         "alpha": (500,), "sigma_plans": (500,),
                         # the wide-head slices (no CB arm)
                         "stdit_h6": (), "dit_l_h4": ()}
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


def test_chip_smoke_carries_the_backbone_arms():
    import inspect
    import chip_smoke as cs
    from viditq_tpu_torch.models import MODELS
    from viditq_tpu_torch.pipelines import mixed_precision as mp
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    # Latte-XL/2 under the W4A8 CB recipe and its four-range MP (the cb
    # arm's model, its launches), DiT-XL/2 sm8 on a label, MMDiT W4A8
    for cfg, kind in ((cs.LATTE_CFG, "Latte-XL/2"), (cs.DIT_CFG, "DiT-XL/2"),
                      (cs.MMDIT_CFG, "MMDiT")):
        assert cfg["model"]["type"] == kind and kind in MODELS
    assert list(cs.SLICE_KERNELS["latte"]) == ["bf16", "cb", "cb_mp"]
    assert list(cs.SLICE_KERNELS["dit"]) == ["bf16", "sm8"]
    assert list(cs.SLICE_KERNELS["mmdit"]) == ["bf16", "w4a8"]
    assert cs.arm_build("latte", "cb_mp") == cs.arm_build("latte", "cb") \
        == cs.arm_build("latte", "bf16") == (cs.CB_PLAN, "cb", ())
    assert cs.arm_build("mmdit", "w4a8")[0] == cs.MMDIT_PLAN
    assert cs.BLOCK_LAUNCHES[("latte", "cb_mp")] == cs.BLOCK_LAUNCHES[
        ("latte", "cb")]
    w = cs.latte_mp_weight()
    assert [k for k in w if k != "fp_layers"] == ["19-15", "14-10", "9-5",
                                                  "4-0"]
    assert w["14-10"]["blocks.27.attn"] == 4 and w["4-0"]["blocks.3.attn"] \
        == 8 and w["9-5"]["blocks.0.mlp"] == 8
    # the gather path on the full-width schedule, bits by span as MP_BITS
    run = cs.mp_sampler(cs.LATTE_CFG, "cpu", cs.quant_plan(cs.CB_PLAN, "cb"),
                        IDDPM(num_sampling_steps=cs.STEPS), w)
    assert isinstance(run, mp.GatherMPSampler)
    bits = run.resolver("blocks.5.attn.proj").weight.mp_bits
    assert bits == tuple(cs.MP_BITS[("latte", "cb_mp")]("blocks.attn.proj",
                                                        r)
                         for r in run.mp_idx) == (8, 4, 4, 4, 8)
    assert isinstance(cs.arm_sampler("mmdit", "w4a8", cs.MMDIT_CFG),
                      cs.RectifiedFlow)
    # the kernels at the new shapes, the tiny models card vs CPU, and
    # quant-generate-mp with a simulate plan and with static tables
    src = inspect.getsource(cs.backbone_cases)
    for part in ("Latte temporal", "Latte spatial", "DiT [2,", "MMDiT img",
                 'ASYM_TOL["attn"]', "scaled_dot_product_attention"):
        assert part in src, part
    ref = inspect.getsource(cs.phase_reference)
    for part in ("TINY_DIT_CFG", "TINY_LATTE_CFG", "TINY_MMDIT_CFG"):
        assert part in ref, part
    cli_src = inspect.getsource(cs.phase_cli)
    for part in ("quant-generate-mp viditq_w4a8", "quant-generate-mp naive",
                 "act_slot_map=slot_map", "CLI_SAME_REL"):
        assert part in cli_src, part


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
    from viditq_tpu_torch.utils.workload import build_model, random_init_
    models = []
    for plan, recipe in ((cs.SM8_PLAN, None), (cs.SIGMA_CB_PLAN, "cb")):
        m = build_model(cs.TINY_SIGMA_CFG,
                        cs.quant_plan(plan, recipe).resolver(), device="cpu")
        random_init_(m, 0, 0.02)
        models.append(dict(m.named_parameters()))
    assert models[0].keys() == models[1].keys()
    for k, p in models[0].items():
        assert torch.equal(p, models[1][k]), k


def test_chip_smoke_carries_the_reference_plan_arms():
    import chip_smoke as cs
    from viditq_tpu_torch.samplers.iddpm import IDDPM
    # the reference plans' simulate arms run at PLAN_DEPTH blocks, in a slice
    # of their own with a bf16 arm at that depth
    plans = cs.SLICE_KERNELS["stdit_plans"]
    # the simulate arms launch K3 alone; naive_fused K2 on static codes;
    # hybrid K7a -> K7b at the MLP; each held to its per-block count
    for arm in ("sim_w8a8", "sim_w6a6", "naive"):
        assert plans[arm] == ("attention_bnhd",)
        assert cs.BLOCK_LAUNCHES[("stdit_plans", arm)] == {
            "attention_bnhd": 3}
    assert cs.BLOCK_LAUNCHES[("stdit_plans", "naive_fused")] == {
        "int8_consumer_matmul": 13, "attention_bnhd": 3}
    assert cs.BLOCK_LAUNCHES[("stdit", "hybrid")] == {
        "dynamic_quant_rows": 2, "int8_matmul": 2, "attention_bnhd": 3}
    assert cs.SLICE_KERNELS["sigma"]["naive"] == ("attention_bnhd",
                                                   "attention_bnhd_stream")
    # the plans as written (naive_fused: naive's tables on impl 'fused')
    for (sl, arm), plan in (
            (("stdit_plans", "sim_w8a8"), "opensora/viditq_w8a8.yaml"),
            (("stdit_plans", "sim_w6a6"), "opensora/viditq_w6a6.yaml"),
            (("stdit_plans", "naive"), "opensora/w8a8_naive.yaml"),
            (("stdit", "hybrid"), "opensora/w8a8_tpu_hybrid.yaml"),
            (("sigma", "naive"), "pixart_sigma/w8a8_naive.yaml")):
        got = cs.arm_build(sl, arm)
        assert got[0] == cs.ROOT / "configs" / plan and got[1] is None
    assert cs.arm_build("stdit_plans", "naive_fused")[1] == "fused"
    assert cs.TABLES_FROM == {("stdit_plans", "naive_fused"): "naive"}
    # every plan arm is held to SLICE_REL_ERR at PLAN_DEPTH (sim_w6a6 took
    # the low-bit rule at 28 blocks)
    assert cs.LOW_BIT_ARMS == {}
    d = cs.quant_plan(cs.NAIVE_PLAN, "fused").default_layer
    assert (d.backend, d.impl, d.act.dynamic) == ("native", "fused", False)
    assert cs.static_acts(cs.quant_plan(cs.SIGMA_NAIVE_PLAN))
    assert not cs.static_acts(cs.quant_plan(cs.SIM_W8A8_PLAN))
    # the sampler: an arm that runs its plan as written takes the plan's
    # cfg_split (viditq_w8a8 and the hybrid plan set it), the earlier arms
    # the joint CFG batch
    for sl, arm, split in (("stdit_plans", "sim_w8a8", True),
                           ("stdit", "hybrid", True),
                           ("stdit_plans", "sim_w6a6", False),
                           ("stdit_plans", "naive", False),
                           ("stdit", "w8a8", False), ("stdit", "bf16", False)):
        assert cs.arm_sampler(sl, arm, cs.TINY_STDIT_CFG).cfg_split \
            == split, arm
    # the static-act set-up on tiny CPU models: naive calibrates through
    # run_ptq over the fp trajectory, naive_fused takes naive's tables, a
    # dynamic-act arm has none; a forward's context carries t's slot
    x, _, y, mask = cs.tiny_inputs(cs.TINY_STDIT_CFG)
    sampler = IDDPM(num_sampling_steps=3, cfg_scale=4.0)
    tables, models, got = {}, {}, {}
    for arm in ("naive", "naive_fused", "sim_w8a8"):
        plan, recipe, _ = cs.arm_build("stdit_plans", arm)
        models[arm] = cs.build_model(cs.TINY_STDIT_CFG, "cpu", scale=0.1,
                                     plan=plan, recipe=recipe)
        got[arm] = cs.arm_static_setup("stdit_plans", arm, models[arm],
                                       sampler, x[:1], y, mask[:1], tables)
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


def test_cli_help_imports_no_jax():
    # a fresh interpreter: the command line's --help of the program and
    # of each command must not pull in jax, flax or the JAX package
    import subprocess
    import sys
    code = (
        "import runpy, sys\n"
        "for argv in ([], ['split-ckpt'], ['ptq'], ['quant-generate'],\n"
        "             ['get-sensitivity']):\n"
        "    sys.argv = ['viditq_tpu_torch.cli', *argv, '--help']\n"
        "    try:\n"
        "        runpy.run_module('viditq_tpu_torch.cli', run_name='__main__',\n"
        "                         alter_sys=True)\n"
        "    except SystemExit:\n"
        "        pass\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'viditq_tpu'))\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout[-2000:]
    assert "quant-generate-mp" in out.stdout


def test_cli_runs_on_the_card_unless_told_otherwise(monkeypatch, tmp_path):
    from viditq_tpu_torch import cli
    parser = cli.build_parser()
    subs = next(a for a in parser._actions
                if a.__class__.__name__ == "_SubParsersAction").choices
    assert set(subs) == {"split-ckpt", "inference", "get-calib-data", "ptq",
                         "quant-generate", "quant-generate-mp",
                         "get-sensitivity", "sweep-alpha",
                         "smooth-quant-list", "calibrate-ptqd-k", "train",
                         "extract-features"}
    for name, sp in subs.items():
        # split-ckpt converts files and calibrate-ptqd-k fits k_t to saved
        # trajectories, both on the host: no model
        if name not in ("split-ckpt", "calibrate-ptqd-k"):
            assert sp.get_default("device") == "cuda", name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = "configs/workload/opensora_tiny.py"
    plan = ["--ptq_config", "configs/opensora/w8a8_dynamic.yaml"]
    for argv in (["inference"], ["get-calib-data"],
                 ["ptq", "--calib_data", "none.npz", *plan],
                 ["quant-generate", *plan], ["get-sensitivity", *plan],
                 ["sweep-alpha", *plan], ["smooth-quant-list", *plan],
                 ["train"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([*argv, "--config", tiny, "--save_dir",
                      str(tmp_path)])
    clip = tmp_path / "clip.npz"
    np.savez(clip, video=np.zeros((2, 16, 16, 3), np.uint8))
    (tmp_path / "d.csv").write_text(f"{clip},a clip")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["extract-features", "--csv", str(tmp_path / "d.csv"),
                  "--num_frames", "2", "--image_size", "16", "--save_dir",
                  str(tmp_path)])


# the rest of the shipped plans' arms by (slice, arm): the plan each runs
NEW_PLAN_ARMS = {
    ("stdit", "w4a8_fused"): "opensora/w4a8_tpu_fused.yaml",
    ("stdit", "hybrid_sym"): "opensora/w8a8_tpu_hybrid_sym.yaml",
    ("stdit_plans", "naive_cb_w4a8"): "opensora/w4a8_naive_cb.yaml",
    ("stdit_plans", "naive_cb_w6a6"): "opensora/w6a6_naive_cb.yaml",
    ("stdit_plans", "sq_w4a8"): "opensora/w4a8_smooth_quant.yaml",
    ("stdit_plans", "sq_w6a6"): "opensora/w6a6_smooth_quant.yaml",
    ("stdit_plans", "sq_w8a8"): "opensora/w8a8_smooth_quant.yaml",
    ("stdit_plans", "ptqd_w6a6"): "opensora/w6a6_ptqd.yaml",
    ("stdit_plans", "ptqd_w8a8"): "opensora/w8a8_ptqd.yaml",
    ("alpha", "sq_static"): "pixart/w8a8_sq_static.yaml",
    ("alpha", "q_diffusion"): "pixart/w8a8_q_diffusion.yaml",
    ("alpha", "alpha_w4a8"): "pixart/w4a8.yaml",
    ("alpha", "alpha_naive"): "pixart/w8a8_naive.yaml",
    ("sigma_plans", "sigma_w8a8"): "pixart_sigma/w8a8.yaml",
    ("sigma_plans", "sigma_w4a8_naive"): "pixart_sigma/w4a8_naive.yaml",
}


@pytest.mark.parametrize("key", sorted(NEW_PLAN_ARMS))
def test_chip_smoke_carries_each_shipped_plan_arm(key):
    import chip_smoke as cs
    sl, arm = key
    assert arm in cs.SLICE_KERNELS[sl]
    assert cs.arm_build(sl, arm)[0] == cs.ROOT / "configs" / \
        NEW_PLAN_ARMS[key]
    # sampled as written (its plan's cfg_split), its launches held exactly
    assert key in cs.AS_WRITTEN
    assert key in cs.BLOCK_LAUNCHES or key in cs.FORWARD_LAUNCHES
    assert set(cs.BLOCK_LAUNCHES.get(key) or cs.FORWARD_LAUNCHES[key]) \
        <= set(cs.SLICE_KERNELS[sl][arm])
    sib = cs.LOW_BIT_ARMS.get(key)
    assert sib is None or sib in cs.SLICE_KERNELS[sl]


def test_chip_smoke_runs_every_shipped_plan():
    """Every plan YAML of the STDiT and PixArt families runs on the card:
    as an arm, or in phase cli / recon / samplers."""
    import chip_smoke as cs
    used = {v for v in vars(cs).values() if isinstance(v, Path)}
    used |= set(cs.ARM_PLANS.values())
    for fam in ("opensora", "pixart", "pixart_sigma"):
        for plan in sorted((cs.ROOT / "configs" / fam).glob("*.yaml")):
            assert plan in used, plan


def test_chip_smoke_plan_slices_and_ptqd():
    import inspect
    import chip_smoke as cs
    from viditq_tpu_torch.utils.config import load_quant_config
    main = inspect.getsource(cs.main)
    for name in ("stdit_plans", "alpha", "sigma_plans", "dit_l"):
        assert f'"{name}"' in main, name
    # the simulate-backend slices: PLAN_DEPTH blocks at XL/2 width, their
    # own bf16 arm first; PixArt-Sigma keeps KV compression on its later half
    for cfg in (cs.STDIT_CFG, cs.ALPHA_CFG, cs.SIGMA_CFG):
        m = cs.plan_cfg(cfg)["model"]
        assert (m["depth"], m["hidden_size"], m["num_heads"]) == (
            cs.PLAN_DEPTH, 1152, 16)
    assert cs.plan_cfg(cs.SIGMA_CFG)["model"]["kv_compress_layers"] == \
        tuple(range(cs.PLAN_DEPTH // 2, cs.PLAN_DEPTH))
    assert cs.PLAN_DEPTH < 28
    for sl in ("stdit_plans", "alpha", "sigma_plans"):
        assert next(iter(cs.SLICE_KERNELS[sl])) == "bf16"
    assert cs.FORWARD_LAUNCHES[("sigma_plans", "sigma_w8a8")] == {
        "attention_bnhd": cs.PLAN_DEPTH,
        "attention_bnhd_stream": cs.PLAN_DEPTH // 2}
    # the PTQD arms run calibrate-ptqd-k through cli.main on the recorded
    # outputs along the fp trajectory
    assert cs.PTQD_ARMS == {("stdit_plans", "ptqd_w6a6"),
                            ("stdit_plans", "ptqd_w8a8")}
    src = inspect.getsource(cs.ptqd_k_check)
    for part in ('"calibrate-ptqd-k"', "cli.main(", "recording(model)",
                 "get_calib_data(", "calibrate_ptqd_k(fp, qt)"):
        assert part in src, part
    assert "ptqd_k_check(" in inspect.getsource(cs.run_slice)
    # the recipes: a static slot a calibration step, the q-diffusion split
    ts = cs.quant_plan(cs.ALPHA_SQ_STATIC_PLAN, "timestep_wise")
    assert ts.default_layer.act.timestep_wise
    split = cs.quant_plan(cs.ALPHA_Q_DIFFUSION_PLAN, "q_diffusion")
    res = split.resolver()
    assert res("blocks.3.mlp.fc2").split == 1728
    assert res("blocks.3.cross_attn.proj").split == 432
    assert res("blocks.3.attn.proj").split == \
        load_quant_config(str(cs.ALPHA_Q_DIFFUSION_PLAN)).resolver()(
            "blocks.3.attn.proj").split


def test_chip_smoke_carries_the_head_dim_and_dit_l_cases():
    import inspect
    import chip_smoke as cs
    from viditq_tpu_torch.kernels import attention as A
    assert cs.HEAD_DIM_CASES == ((32, 16), (40, 16), (64, 16), (128, 16),
                                 (192, 6), (256, 8), (136, 6), (200, 8))
    for d in (40, 136, 200):  # the padded widths
        assert d not in A.KERNEL_HEAD_DIMS
    assert A.KERNEL_HEAD_DIMS == (16, 32, 64, 72, 128, 192, 256)
    assert all(d * h <= A.MAX_HD for d, h in cs.HEAD_DIM_CASES)
    src = inspect.getsource(cs.head_dim_cases)
    for part in ("A.attention_bnhd(q, k, v, sc)", "int8_pv=True",
                 "emit_sym=False, need_rowsum=True", "col_scale=ics",
                 "seg_len=16", "A.attention_bnhd_stream(q, k, v, sc)",
                 "A.qk_headwise_quant(q, k)", "exact=True",
                 '"attention_bnhd_f32"', '"attention_bnhd_stream_f32"',
                 "F32_REL_ERR", "sdpa(q, k, v, sc)", "kv_mask=pm",
                 "seg_len=32", "int8_pv_slack(", "(row kernel)"):
        assert part in src, part
    main = inspect.getsource(cs.phase_kernels)
    assert "head_dim_cases(records)" in main and "dit_l_cases(records)" \
        in main and "wide_path_cases(records)" in main
    # the wide-head slices: STDiT-XL/2 and DiT-L/2 with the head split
    # changed and nothing else, bf16 and sm8, launches as at 16 heads
    for cfg, base, heads in ((cs.STDIT_H6_CFG, dict(
            depth=28, hidden_size=1152, patch_size=(1, 2, 2)), 6),
            (cs.DIT_L_H4_CFG, cs.DIT_L_CFG["model"], 4)):
        m = cfg["model"]
        assert m["num_heads"] == heads and all(
            m[k] == base[k] for k in ("depth", "hidden_size", "patch_size"))
    assert cs.STDIT_H6_CFG["image_size"] == cs.STDIT_CFG["image_size"]
    assert cs.SLICE_KERNELS["stdit_h6"] == {
        "bf16": ("attention_bnhd",), "sm8": cs.FUSED_KERNELS}
    assert cs.SLICE_KERNELS["dit_l_h4"] == cs.SLICE_KERNELS["dit"]
    assert cs.BLOCK_LAUNCHES[("stdit_h6", "sm8")] == cs.SM8_BLOCK
    assert cs.BLOCK_LAUNCHES[("dit_l_h4", "sm8")] == \
        cs.BLOCK_LAUNCHES[("dit", "sm8")]
    run = inspect.getsource(cs.main)
    assert '"stdit_h6"' in run and '"dit_l_h4"' in run
    m = cs.DIT_L_CFG["model"]
    assert (m["type"], m["depth"], m["hidden_size"], m["num_heads"],
            m["patch_size"]) == ("DiT", 24, 1024, 16, (1, 2, 2))
    assert cs.SLICE_KERNELS["dit_l"] == cs.SLICE_KERNELS["dit"]
    assert cs.BLOCK_LAUNCHES[("dit_l", "sm8")] == \
        cs.BLOCK_LAUNCHES[("dit", "sm8")]
