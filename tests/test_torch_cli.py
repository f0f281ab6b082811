"""The port's CLI (`python -m viditq_tpu_torch.cli`, run here with
`--device cpu`) against the JAX package's (`viditq_tpu.cli`) on the tiny
workloads (`configs/workload/{opensora,pixart}_tiny.py`).

Both get the same weights: numpy draws (a seed) in the JAX model's
parameter tree, saved as the JAX CLI's flax msgpack and, through the
bridge, as the port's params file. Where the two CLIs are compared the
workloads take `tests/torch_parity.py`'s sizes (a 2x16x32 video latent,
a 32x32 image latent), at which the JAX package runs its attention
kernel (in interpret mode here, `jax_kernel_path`): the port runs its
kernels' numerics (bf16 q.k) at every size, the JAX package its XLA f32
attention below them. Files cross between the packages: the
port's `ptq` reads the JAX `get-calib-data`'s `calib_data.npz`; on
`w8a8_naive.yaml` (static acts) its `quant_ckpt.npz` has the JAX key set
and tables within 1e-6 relative (`PERF.md` §2), on `w8a8_dynamic.yaml`
the JAX weight tables. `quant-generate` on `w8a8_dynamic.yaml`, the
port's latent patched to the JAX CLI's draw: samples within 2e-2
relative of JAX's (the denoise tolerance), and the port with JAX's
`quant_ckpt.npz` gives its own checkpoint's samples to 1e-6. The tiny
PixArt under `configs/pixart/w8a8.yaml` (DPM-Solver) against JAX's. Then
the port alone: `resume_with_w_quantized` (flag and YAML key), the sm8
plan's samples against the in-process path, `quant-generate-mp` against
the in-process `build_mp_sampler` run (native CB, the simulate backend,
and static act tables from `ptq`), and the
`--sampler_type` aliases.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parity import jax_kernel_path, randomize, rel_err
from viditq_tpu import cli as j_cli
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.utils import ckpt as j_ckpt
from viditq_tpu.utils import workload as j_workload
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines.inference import quant_sample
from viditq_tpu_torch.pipelines.mixed_precision import (GatherMPSampler,
                                                         SegmentedMPSampler,
                                                         build_mp_sampler)
from viditq_tpu_torch.pipelines.ptq import resume_w_quantized
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.utils import ckpt, workload
from viditq_tpu_torch.utils.bridge import state_dict_from_flax
from viditq_tpu_torch.utils.config import (load_bitwidth_config,
                                           load_quant_config)

STDIT_CFG = "configs/workload/opensora_tiny.py"
PIXART_CFG = "configs/workload/pixart_tiny.py"
# the tiny workloads at the kernel-path sizes (module header)
# (and 2 sampler steps: JAX's interpret mode costs ~3 s a forward there)
KERNEL_PATH_SIZES = {
    STDIT_CFG: (("num_frames = 4", "num_frames = 2"),
                ("image_size = (64, 64)", "image_size = (128, 256)"),
                ("num_sampling_steps=3", "num_sampling_steps=2")),
    PIXART_CFG: (("image_size = 64", "image_size = 256"),
                 ("input_size=8,", "input_size=32,"),
                 ("num_sampling_steps=4", "num_sampling_steps=2")),
}
NAIVE = "configs/opensora/w8a8_naive.yaml"
DYN = "configs/opensora/w8a8_dynamic.yaml"
SM8 = "configs/opensora/w8a8_tpu_fused_sm8.yaml"
CB = "configs/opensora/w4a8_timestep_aware_cb.yaml"
PIXART_PLAN = "configs/pixart/w8a8.yaml"
MP_W = "configs/opensora/mixed_precision/t20_weight_4_mp.yaml"
MP_A = "configs/opensora/mixed_precision/t20_act_8_mp.yaml"
SEED = 42
TABLE_REL = 1e-6
DENOISE_REL = 2e-2


def kernel_path_config(config, tmp):
    """A copy of a tiny workload config at the kernel-path sizes."""
    with open(config) as f:
        src = f.read()
    for a, b in KERNEL_PATH_SIZES[config]:
        assert a in src
        src = src.replace(a, b)
    path = str(tmp / os.path.basename(config))
    with open(path, "w") as f:
        f.write(src)
    return path


def _weights(config, tmp, seed, scale=0.1):
    """(JAX msgpack path, port params path, JAX z [1, 4, *latent]) of the
    workload's model with numpy-drawn parameters (normal x scale)."""
    cfg = j_workload.load_py_config(config)
    model = j_workload.build_model(cfg)
    ls = j_workload.latent_size(cfg)
    z = jax.random.normal(jax.random.PRNGKey(SEED), (1, 4, *ls), jnp.float32)
    mcfg = cfg["model"]
    y = jnp.zeros((1, 1, mcfg["model_max_length"], mcfg["caption_channels"]))
    mask = jnp.ones((1, mcfg["model_max_length"]), jnp.int32)
    v = jax.jit(functools.partial(model.init, qctx=JQuantCtx(mode="fp")))(
        jax.random.PRNGKey(0), z, jnp.zeros((1,)), y, mask)
    params = randomize(v["params"], seed=seed, scale=scale)
    jpath, ppath = str(tmp / "params.msgpack"), str(tmp / "params.pt")
    j_ckpt.save_params(jpath, params)
    ckpt.save_params(ppath, state_dict_from_flax(params))
    return jpath, ppath, np.array(z)


@contextlib.contextmanager
def port_noise(z):
    """The port's latent draw replaced by z (the JAX CLI's)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "noise", lambda shape, seed, device: torch.from_numpy(
            np.array(z)).to(device))
        yield


def _run(main, cmd, config, save_dir, params, *extra):
    """One command of either CLI; the JAX one on its kernel path (Pallas
    interpret mode), whose attention numerics the port's keep."""
    args = [cmd, "--config", config, "--save_dir", save_dir,
            "--ckpt_path", params, *extra]
    if main is cli.main:
        return main(args + ["--device", "cpu"])
    with jax_kernel_path():
        return main(args)


@pytest.fixture(scope="module")
def stdit(tmp_path_factory):
    """The JAX CLI's and the port's runs on the tiny STDiT that the tests
    compare: {name: output directory}."""
    tmp = tmp_path_factory.mktemp("cli_stdit")
    config = kernel_path_config(STDIT_CFG, tmp)
    jpath, ppath, z = _weights(config, tmp, seed=1)
    d = {k: str(tmp / k) for k in ("jcal", "jnaive", "pnaive", "jdyn",
                                    "pdyn", "jgen", "pgen", "pgen_j")}
    def run_j(cmd, save_dir, *extra):
        return _run(j_cli.main, cmd, config, save_dir, jpath, *extra)

    def run_p(cmd, save_dir, *extra):
        return _run(cli.main, cmd, config, save_dir, ppath, *extra)
    n1 = ("--num_samples", "1")
    run_j("get-calib-data", d["jcal"], *n1)
    cal = os.path.join(d["jcal"], "calib_data.npz")
    for plan, jd, pd in ((NAIVE, "jnaive", "pnaive"), (DYN, "jdyn", "pdyn")):
        run_j("ptq", d[jd], "--ptq_config", plan, "--calib_data", cal)
        run_p("ptq", d[pd], "--ptq_config", plan, "--calib_data", cal)
    gen = n1 + ("--ptq_config", DYN)
    run_j("quant-generate", d["jgen"], *gen, "--quant_ckpt",
          os.path.join(d["jdyn"], "quant_ckpt.npz"))
    with port_noise(z):
        for out, src in (("pgen", "pdyn"), ("pgen_j", "jdyn")):
            run_p("quant-generate", d[out], *gen, "--quant_ckpt",
                  os.path.join(d[src], "quant_ckpt.npz"))
    return {"dirs": d, "z": z, "params": ppath, "calib": cal,
            "config": config}


def _ckpt(d):
    data = np.load(os.path.join(d, "quant_ckpt.npz"))
    return {k: data[k] for k in data.files if k != "__meta__"}


def _samples(d, name="quant_samples.npz"):
    return np.load(os.path.join(d, name))["samples"]


def test_port_ptq_naive_tables_match_jax(stdit):
    d = stdit["dirs"]
    jt, pt = _ckpt(d["jnaive"]), _ckpt(d["pnaive"])
    assert jt.keys() == pt.keys()
    assert any(k.endswith("::a_delta") for k in jt)
    for k, v in jt.items():
        assert pt[k].shape == v.shape, k
        assert rel_err(pt[k], v) <= TABLE_REL, k
    jm = ckpt.read_quant_ckpt(os.path.join(d["jnaive"], "quant_ckpt.npz"))[1]
    pm = ckpt.read_quant_ckpt(os.path.join(d["pnaive"], "quant_ckpt.npz"))[1]
    assert np.array_equal(jm["act_slot_map"], pm["act_slot_map"])
    assert np.array_equal(jm["calib_ts"], pm["calib_ts"])
    for snap in ("jnaive", "pnaive"):
        assert os.path.exists(os.path.join(d[snap],
                                           "quant_config_snapshot.yaml"))


def test_port_ptq_dynamic_weight_tables_match_jax(stdit):
    d = stdit["dirs"]
    jt, pt = _ckpt(d["jdyn"]), _ckpt(d["pdyn"])
    assert jt.keys() == pt.keys()
    assert {k.split("::")[1] for k in jt} == {"w_delta", "w_zp"}
    for k, v in jt.items():
        assert rel_err(pt[k], v) <= TABLE_REL, k


def test_port_quant_generate_matches_jax(stdit):
    d = stdit["dirs"]
    jgen, pgen = _samples(d["jgen"]), _samples(d["pgen"])
    assert pgen.shape == jgen.shape == (1, 4, 2, 16, 32)
    assert rel_err(pgen, jgen) <= DENOISE_REL
    # the JAX checkpoint in the port: its own checkpoint's samples
    assert rel_err(_samples(d["pgen_j"]), pgen) <= TABLE_REL


def test_pixart_quant_generate_matches_jax(tmp_path):
    config = kernel_path_config(PIXART_CFG, tmp_path)
    jpath, ppath, z = _weights(config, tmp_path, seed=2)
    args = ("--num_samples", "1", "--ptq_config", PIXART_PLAN)
    _run(j_cli.main, "quant-generate", config, str(tmp_path / "j"),
         jpath, *args)
    with port_noise(z):
        _run(cli.main, "quant-generate", config, str(tmp_path / "p"),
             ppath, *args)
    jgen, pgen = _samples(tmp_path / "j"), _samples(tmp_path / "p")
    assert pgen.shape == jgen.shape == (1, 4, 32, 32)
    assert rel_err(pgen, jgen) <= DENOISE_REL


def _tampered(src, dst, scale_w=1.0, scale_a=1.0, drop_w=False, extra=None):
    data = dict(np.load(src))
    for k in list(data):
        tab = k.split("::")[-1]
        if tab in ("w_delta", "w_zp"):
            if drop_w:
                del data[k]
            else:
                data[k] = data[k] * scale_w
        elif tab == "a_delta":
            data[k] = data[k] * scale_a
    data.update(extra or {})
    np.savez(dst, **data)
    return dst


@pytest.mark.parametrize("how", ["flag", "yaml"])
def test_resume_with_w_quantized(stdit, tmp_path, how):
    d = stdit["dirs"]
    src = os.path.join(d["pnaive"], "quant_ckpt.npz")
    # weight tables x2 (so they show), act tables x3 (so a copy shows)
    res = _tampered(src, str(tmp_path / "resume.npz"), 2.0, 3.0)
    plan = NAIVE
    extra = ()
    if how == "flag":
        extra = ("--resume_with_w_quantized", res)
    else:
        with open(NAIVE) as f:
            y = yaml.safe_load(f)
        y["resume_with_w_quantized"] = {"path": res}
        plan = str(tmp_path / "plan.yaml")
        with open(plan, "w") as f:
            yaml.safe_dump(y, f)
        assert load_quant_config(plan).resume_w_path == res
    cli.main(["ptq", "--config", stdit["config"], "--save_dir",
              str(tmp_path / "out"), "--ckpt_path", stdit["params"],
              "--device", "cpu", "--ptq_config", plan,
              "--calib_data", stdit["calib"], *extra])
    got, want, own = (_ckpt(str(tmp_path / "out")), dict(np.load(res)),
                      _ckpt(d["pnaive"]))
    for k, v in got.items():
        tab = k.split("::")[-1]
        if tab in ("w_delta", "w_zp"):
            assert np.array_equal(v, want[k]), k
        else:  # this run's act tables, not the file's (x3)
            assert tab in ("a_delta", "a_zp")
            assert v.shape == own[k].shape
            if tab == "a_delta":
                assert not np.isclose(v, want[k], rtol=1e-3).any(), k
    meta = ckpt.read_quant_ckpt(os.path.join(str(tmp_path / "out"),
                                             "quant_ckpt.npz"))[1]
    assert meta["act_slot_map"] is not None


def test_resume_errors(stdit, tmp_path):
    src = os.path.join(stdit["dirs"]["pnaive"], "quant_ckpt.npz")
    model = workload.build_model(workload.load_py_config(stdit["config"]),
                                 load_quant_config(NAIVE).resolver(),
                                 device="cpu")
    cases = (
        (dict(extra={"blocks.9.attn.q::w_delta": np.ones((1, 1, 1, 64),
                                                         np.float32)}),
         "not in this model"),
        (dict(extra={"blocks.0.attn.q::w_zp": np.ones((1, 1, 1, 3),
                                                      np.float32)}),
         "shape"),
        (dict(drop_w=True), "no weight tables"),
    )
    for i, (kw, msg) in enumerate(cases):
        path = _tampered(src, str(tmp_path / f"bad{i}.npz"), **kw)
        with pytest.raises(ValueError, match=msg):
            resume_w_quantized(model, path)


def _in_process(config, plan_path, params, backend=None):
    """(cfg, plan, model with the params file's weights) in this
    process."""
    cfg = workload.load_py_config(config)
    plan = load_quant_config(plan_path)
    if backend:
        plan = plan.with_backend(backend)
    model = workload.build_model(cfg, plan.resolver(), device="cpu")
    ckpt.load_params_into(model, params)
    return cfg, plan, model


def _embeds(config, n=1):
    """The CLI's smoke-mode embeds (numpy seed 0, all-ones mask)."""
    cfg = workload.load_py_config(config)
    m = cfg["model"]
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(
        (2 * n, 1, m["model_max_length"], m["caption_channels"])).astype(
            np.float32))
    return y, torch.ones((n, m["model_max_length"]), dtype=torch.int32)


def test_sm8_quant_generate_matches_in_process(stdit, tmp_path):
    out = cli.main(["quant-generate", "--config", STDIT_CFG, "--save_dir",
                    str(tmp_path), "--ckpt_path", stdit["params"],
                    "--device", "cpu", "--num_samples", "1",
                    "--ptq_config", SM8])
    y, mask = _embeds(STDIT_CFG)
    z = cli.noise((1, 4, 4, 8, 8), SEED, "cpu")
    cfg, plan, model = _in_process(STDIT_CFG, SM8, stdit["params"])
    assert plan.default_layer.impl == "fused"
    calibrate_weight_tables(model)
    pack_native_weights(model)
    want = quant_sample(model, workload.build_sampler(
        cfg, cfg_split=plan.cfg_split), z, y, mask)
    got = _samples(str(tmp_path))
    assert np.array_equal(got, want.float().numpy())
    assert out["steps"] == 3


@pytest.fixture(scope="module")
def tiny20(stdit, tmp_path_factory):
    """(config path, common flags, calib_data.npz path) of the tiny
    workload at 20 sampler steps (the t20 configs tile 20) on the stdit
    fixture's weights, its calibration data from `get-calib-data`."""
    tmp = tmp_path_factory.mktemp("tiny20")
    cfg_path = str(tmp / "tiny20.py")
    with open(STDIT_CFG) as f:
        src = f.read()
    with open(cfg_path, "w") as f:
        f.write(src.replace("num_sampling_steps=3", "num_sampling_steps=20"))
    common = ["--config", cfg_path, "--ckpt_path", stdit["params"],
              "--device", "cpu"]
    cli.main(["get-calib-data", "--save_dir", str(tmp / "cal"),
              "--num_samples", "1", *common])
    return cfg_path, common, str(tmp / "cal" / "calib_data.npz")


def _mp_in_process(cfg_path, plan_path, params, qck=None, backend=None):
    """The in-process MP run `quant-generate-mp` makes: the params' model,
    the quant checkpoint's tables (else min-max weight tables from the
    params) and slabs, `build_mp_sampler` with the checkpoint's act slot
    map, the plan's `cfg_split`. Returns (samples, sampler)."""
    y, mask = _embeds(cfg_path)
    z = cli.noise((1, 4, 4, 8, 8), SEED, "cpu")
    cfg, plan, model = _in_process(cfg_path, plan_path, params,
                                   backend=backend)
    slot_map = None
    if qck is None:
        calibrate_weight_tables(model)
    else:
        slot_map = ckpt.load_quant_ckpt(qck, model).get("act_slot_map")
    if plan.uses_native():
        pack_native_weights(model)
    run = build_mp_sampler(
        lambda r: workload.build_model(cfg, r, device="cpu"),
        workload.build_sampler(cfg, cfg_split=plan.cfg_split), plan,
        load_bitwidth_config(MP_W), load_bitwidth_config(MP_A),
        act_slot_map=slot_map)
    return run(model, z, y, mask).float().numpy(), run


def test_quant_generate_mp_matches_in_process(stdit, tiny20, tmp_path):
    cfg_path, common, calib = tiny20
    q = ["--ptq_config", CB, "--backend", "native"]
    mp_cfgs = ["--time_mp_config_weight", MP_W, "--time_mp_config_act",
               MP_A]
    cli.main(["ptq", "--save_dir", str(tmp_path / "q"), "--calib_data",
              calib, *common, *q])
    qck = str(tmp_path / "q" / "quant_ckpt.npz")
    cli.main(["quant-generate-mp", "--save_dir", str(tmp_path / "mp"),
              "--num_samples", "1", "--quant_ckpt", qck, *mp_cfgs, *common,
              *q])
    want, run = _mp_in_process(cfg_path, CB, stdit["params"], qck,
                               backend="native")
    assert isinstance(run, GatherMPSampler)
    got = _samples(str(tmp_path / "mp"))
    assert np.isfinite(got).all()
    assert np.array_equal(got, want)
    # on the simulate backend (the plan as written, its cfg_split; weight
    # tables from the params, no checkpoint): the segmented path
    cli.main(["quant-generate-mp", "--save_dir", str(tmp_path / "sim"),
              "--num_samples", "1", "--ptq_config", CB, *mp_cfgs, *common])
    want, run = _mp_in_process(cfg_path, CB, stdit["params"])
    assert isinstance(run, SegmentedMPSampler) and not run.native_repack
    got = _samples(str(tmp_path / "sim"))
    assert np.isfinite(got).all()
    assert np.array_equal(got, want)


def test_quant_generate_mp_static_tables_match_in_process(stdit, tiny20,
                                                          tmp_path):
    """`ptq` under w8a8_naive.yaml (static act tables) on the CLI's own
    calibration data, then `quant-generate-mp` from its checkpoint (the
    plan as written: the simulate backend): the act slot map of the
    checkpoint's meta reaches every range's forwards (the native backend's
    static MP: tests/test_torch_mp.py)."""
    cfg_path, common, calib = tiny20
    mp_cfgs = ["--time_mp_config_weight", MP_W, "--time_mp_config_act",
               MP_A]
    cli.main(["ptq", "--save_dir", str(tmp_path / "q"), "--calib_data",
              calib, "--ptq_config", NAIVE, *common])
    qck = str(tmp_path / "q" / "quant_ckpt.npz")
    assert ckpt.read_quant_ckpt(qck)[1]["act_slot_map"] is not None
    out = str(tmp_path / "mp")
    cli.main(["quant-generate-mp", "--save_dir", out, "--num_samples", "1",
              "--quant_ckpt", qck, "--ptq_config", NAIVE, *mp_cfgs,
              *common])
    want, run = _mp_in_process(cfg_path, NAIVE, stdit["params"], qck)
    assert isinstance(run, SegmentedMPSampler) and not run.native_repack
    assert run.act_slot_map is not None
    got = _samples(out)
    assert np.isfinite(got).all()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("override", [None, "ddim", "dpms", "dpm-solver"])
@pytest.mark.parametrize("config", [STDIT_CFG, PIXART_CFG])
def test_sampler_aliases_resolve_like_jax(config, override):
    jcfg = j_workload.load_py_config(config)
    js = j_workload.build_sampler(jcfg, override_type=override)
    ps = workload.build_sampler(workload.load_py_config(config),
                                override_type=override)
    assert type(ps).__name__ == type(js).__name__
    assert ps.cfg_scale == js.cfg_scale
    steps = (lambda s: getattr(s, "steps", None)
             or getattr(s, "num_sampling_steps", None) or s.schedule.n_steps)
    assert steps(ps) == steps(js)


@pytest.mark.parametrize("override", ["iddpm", "sa-solver", "lcm", "edm"])
def test_unported_samplers_raise(override, tmp_path):
    # these samplers raised NotImplementedError until they were ported:
    # each now samples, by its own loop, not DDIM's (the parity cases:
    # tests/test_torch_samplers.py, test_torch_cli_samplers.py); what
    # still raises is a name the JAX CLI's choices reject too
    outs = {}
    for st in ("ddim", override):
        out = cli.main(["inference", "--config", STDIT_CFG, "--save_dir",
                        str(tmp_path / st), "--device", "cpu",
                        "--num_samples", "1", "--sampler_type", st])
        outs[st] = _samples(out["out"].rpartition("/")[0],
                            "fp_samples.npz")
    assert np.isfinite(outs[override]).all()
    assert rel_err(outs[override], outs["ddim"]) > 1e-2
    with pytest.raises(ValueError):
        workload.build_sampler(workload.load_py_config(STDIT_CFG),
                               override_type="euler")


def test_text_embeds_file_of_jax_layout(tmp_path):
    """An embeds npz in the JAX `get-text-embeds` layout: the port's reader
    selects what the JAX one selects, and the CLI samples from it."""
    from viditq_tpu.models.text_encoder import PrecomputedTextEmbeds as JE
    from viditq_tpu_torch.models.text_encoder import PrecomputedTextEmbeds
    rng = np.random.default_rng(3)
    path = str(tmp_path / "embeds.npz")
    np.savez(path, y=rng.standard_normal((3, 2, 1, 8, 32)).astype(
        np.float32), mask=(rng.random((3, 8)) > 0.3).astype(np.int32))
    for ids in ([2, 0], [1]):
        want, got = JE(path).select(ids), PrecomputedTextEmbeds(path).select(
            ids)
        for k in ("y", "mask"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    out = cli.main(["inference", "--config", STDIT_CFG, "--save_dir",
                    str(tmp_path), "--device", "cpu", "--num_samples", "2",
                    "--text_embeds_path", path, "--batch_ids", "2,0"])
    assert np.load(out["out"])["samples"].shape == (2, 4, 4, 8, 8)


def _plan_fields(plan):
    d = plan.default_layer
    return (plan.fp_patterns, plan.resume_w_path,
            None if plan.weight_opt is None else vars(plan.weight_opt),
            None if plan.act_opt is None else vars(plan.act_opt),
            d.smooth_quant.alpha, d.act.n_timestep, d.act.timestep_wise,
            plan.calib_n_steps, plan.cfg_split)


@pytest.mark.parametrize("path", sorted(
    str(p) for d in ("opensora", "pixart", "pixart_sigma")
    for p in __import__("pathlib").Path("configs", d).glob("*.yaml")))
def test_load_quant_config_flags_like_jax(path):
    from viditq_tpu.utils.config import load_quant_config as j_load
    for kw in (dict(), dict(smooth_quant_alpha=0.3),
               dict(timestep_wise=True)):
        assert _plan_fields(load_quant_config(path, **kw)) == _plan_fields(
            j_load(path, **kw)), kw


def test_ptq_snapshot_takes_smooth_quant_alpha(tmp_path):
    cli.main(["ptq", "--config", STDIT_CFG, "--save_dir", str(tmp_path),
              "--device", "cpu", "--ptq_config", CB, "--calib_data",
              _tiny_calib(tmp_path), "--smooth_quant_alpha", "0.3"])
    with open(os.path.join(tmp_path, "quant_config_snapshot.yaml")) as f:
        snap = yaml.safe_load(f)
    with open(CB) as f:
        orig = yaml.safe_load(f)
    sq = orig["quant"]["activation"]["quantizer"]["smooth_quant"]
    sq["alpha"] = 0.3
    assert snap == orig
    meta = ckpt.read_quant_ckpt(os.path.join(tmp_path, "quant_ckpt.npz"))[1]
    assert meta["ptq_config"] == CB


def _tiny_calib(tmp_path):
    d = str(tmp_path / "cal")
    cli.main(["get-calib-data", "--config", STDIT_CFG, "--save_dir", d,
              "--device", "cpu", "--num_samples", "1"])
    return os.path.join(d, "calib_data.npz")
