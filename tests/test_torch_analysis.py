"""The port's analysis commands (`get-sensitivity`, `sweep-alpha`,
`smooth-quant-list`, `pipelines/analysis.py`) against the JAX package's,
through both CLIs on the tiny STDiT with the same weights and latent
(numpy draws from a seed; `tests/test_torch_cli.py` makes the files).

At the tiny workload's own size the JAX package runs its XLA f32
attention and the port its kernels' numerics (bf16 q.k), so the inputs
of the layers after an attention differ between the packages. With the
weights at 0.02 (the bench's scale) the logits are small and that gap
stays at f32 rounding: each layer's captured rows (as a set: the
layout-native STDiT orders some layers' rows otherwise) are held to 1e-6
before the first attention and 1e-3 after it, the swept alphas must be
equal (or the two candidates' losses within 1e-6 relative), the
smooth-quant picks equal (or a ratio within 1e-6 of the threshold).

The sensitivity scores measure how far a quantized generation moves from
the fp one. At 0.02 that move is below the packages' parity noise, so
those runs take 0.1 weights and 4-bit weights (`w8a8_dynamic.yaml` with
`n_bits: 4`, whose weight codes both packages compute alike), where the
quantization moves the samples by far more than the noise: mse scores
within 5e-2 relative with the same ranking (the int8 act codes still
flip at ties, PERF.md §2: 1e-2 does not hold), the flow vector's ranking
and the rank-combined vector equal, plain and block-group mode.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_cli import STDIT_CFG, _weights, port_noise
from torch_parity import rel_err
from viditq_tpu import cli as j_cli
from viditq_tpu.pipelines.analysis import capture_layer_inputs as j_capture
from viditq_tpu.quant import QuantCtx as JQuantCtx
from viditq_tpu.utils import ckpt as j_ckpt
from viditq_tpu.utils import workload as j_workload
from viditq_tpu.utils.config import load_quant_config as j_load
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines import analysis
from viditq_tpu_torch.utils import ckpt, workload
from viditq_tpu_torch.utils.config import load_quant_config

DYN = "configs/opensora/w8a8_dynamic.yaml"
WEIGHT_SCALE = 0.02
SENS_WEIGHT_SCALE = 0.1
SCORE_REL = 5e-2
# the native backend's scores against the simulate backend's, one package:
# the int8 model limit of a forward (PERF.md §2)
NATIVE_SCORE_REL = 1e-2
# the attention-numerics gap between the packages at this size (header)
AFTER_ATTN_REL = 1e-3
BEFORE_ATTN_REL = 1e-6
LOSS_REL = 1e-6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("analysis")
    jpath, ppath, z = _weights(STDIT_CFG, tmp, seed=4, scale=WEIGHT_SCALE)
    return {"tmp": tmp, "jax": jpath, "port": ppath, "z": z, "plan": DYN}


@pytest.fixture(scope="module")
def sens_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sensitivity")
    jpath, ppath, z = _weights(STDIT_CFG, tmp, seed=4,
                               scale=SENS_WEIGHT_SCALE)
    with open(DYN) as f:
        plan = yaml.safe_load(f)
    plan["quant"]["weight"]["quantizer"]["n_bits"] = 4
    path = str(tmp / "w4a8_dynamic.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(plan, f)
    return {"tmp": tmp, "jax": jpath, "port": ppath, "z": z, "plan": path}


def _both(files, cmd, name, *extra):
    """(JAX output dir, port output dir) of one analysis command."""
    out = {}
    for pkg, main in (("jax", j_cli.main), ("port", cli.main)):
        d = str(files["tmp"] / f"{name}_{pkg}")
        args = [cmd, "--config", STDIT_CFG, "--save_dir", d, "--ckpt_path",
                files[pkg], "--num_samples", "1", "--ptq_config",
                files["plan"], *extra]
        if pkg == "port":
            with port_noise(files["z"]):  # the JAX CLI's latent
                main(args + ["--device", "cpu"])
        else:
            main(args)
        out[pkg] = d
    return out


def _port_model(files, plan=DYN):
    cfg = workload.load_py_config(STDIT_CFG)
    m = workload.build_model(cfg, load_quant_config(plan).resolver(),
                             device="cpu")
    return ckpt.load_params_into(m, files["port"]), cfg


def _probe_inputs(cfg, z):
    """The analysis commands' probe forward inputs (`cli._probe`) on the
    latent z."""
    n = cfg["model"]
    rng = np.random.default_rng(0)
    y = rng.standard_normal((2, 1, n["model_max_length"],
                             n["caption_channels"])).astype(np.float32)
    return (z, np.full((1,), 500.0, np.float32), y[:1],
            np.ones((1, n["model_max_length"]), np.int32))


def _after_attention(name):
    return not (name.startswith(("x_embedder", "t_embedder", "y_embedder",
                                 "t_block"))
                or name.startswith(("blocks.0.attn.q", "blocks.0.attn.k",
                                    "blocks.0.attn.v")))


def test_hook_capture_gives_the_rows_of_jax_sow(files):
    model, cfg = _port_model(files)
    args = _probe_inputs(cfg, files["z"])
    got = analysis.capture_layer_inputs(
        model, tuple(torch.from_numpy(a) for a in args))
    jmodel = j_workload.build_model(cfg, resolver=j_load(DYN).resolver())
    # the variables' shapes only (no compile); the fp capture reads the
    # params, which come from the file
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args),
        qctx=JQuantCtx(mode="fp")))
    v = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype), dict(shapes))
    v["params"] = j_ckpt.load_params(files["jax"], v["params"])
    want = j_capture(jmodel, v, tuple(map(jnp.asarray, args)))
    assert set(got) == set(want) and len(got) > 20
    for name, x in want.items():
        x = np.asarray(x)
        g = got[name].numpy()
        assert g.size == x.size and g.shape[-1] == x.shape[-1], name
        # the same rows, in either order
        a = np.sort(g.reshape(-1, g.shape[-1]), axis=0)
        b = np.sort(x.reshape(-1, x.shape[-1]), axis=0)
        tol = AFTER_ATTN_REL if _after_attention(name) else BEFORE_ATTN_REL
        assert rel_err(a, b) <= tol, name


def test_sweep_alpha_matches_jax(files):
    d = _both(files, "sweep-alpha", "sweep")
    got, want = ({k: v for k, v in json.load(open(
        os.path.join(d[p], "best_alpha.json"))).items()}
        for p in ("port", "jax"))
    assert got.keys() == want.keys() and len(got) > 20
    model, cfg = _port_model(files)
    args = tuple(torch.from_numpy(a) for a in _probe_inputs(cfg, files["z"]))
    differ = [n for n in got if got[n] != want[n]]
    if differ:
        inputs = analysis.capture_layer_inputs(model, args)
        mods = dict(model.named_modules())
        for n in differ:
            _, losses = analysis.sweep_alpha_for_layer(
                inputs[n], mods[n].kernel, mods[n].lspec)
            a, b = losses[got[n]], losses[want[n]]
            assert abs(a - b) <= LOSS_REL * max(a, b), (n, a, b)


def test_smooth_quant_list_matches_jax(files):
    d = _both(files, "smooth-quant-list", "sq", "--threshold", "3.0")
    got, want = (set(open(os.path.join(d[p], "smooth_quant_list.txt"))
                     .read().split()) for p in ("port", "jax"))
    assert want, "no candidates at this threshold"
    model, cfg = _port_model(files)
    ratios = analysis.capture_layer_stats(
        model, tuple(torch.from_numpy(a) for a in _probe_inputs(cfg, files["z"])),
        lambda name, mod, x: analysis.act_range_ratio(x))
    for n in got ^ want:
        assert abs(ratios[n] - 3.0) <= LOSS_REL * 3.0, (n, ratios[n])


def _scores(d, name="sensitivity.json"):
    with open(os.path.join(d, name)) as f:
        return json.load(f)


def _same_scores(got, want, rel=SCORE_REL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) <= rel * abs(v), (k, got[k], v)
    _same_ranking(got, want)


def _same_ranking(got, want):
    assert sorted(got, key=got.get) == sorted(want, key=want.get)


def test_sensitivity_matches_jax(sens_files):
    files = sens_files
    d = _both(files, "get-sensitivity", "sens", "--targets",
              "attn,mlp", "--metric", "mse,flow")
    got, want = _scores(d["port"]), _scores(d["jax"])
    assert set(want["per_metric"]) == {"mse", "flow"}
    _same_scores(got["per_metric"]["mse"], want["per_metric"]["mse"])
    _same_ranking(got["per_metric"]["flow"], want["per_metric"]["flow"])
    assert got["combined"] == want["combined"]
    # the one-metric scan gives the multi scan's 'mse' vector
    one = str(files["tmp"] / "sens_one")
    with port_noise(files["z"]):
        cli.main(["get-sensitivity", "--config", STDIT_CFG, "--save_dir",
                  one, "--ckpt_path", files["port"], "--num_samples", "1",
                  "--ptq_config", files["plan"], "--targets",
                  "attn,mlp", "--device", "cpu"])
    assert _scores(one) == got["per_metric"]["mse"]


def test_native_sensitivity_matches_simulate(sens_files):
    """The native backend's scores (K7a/K7b, their plain versions on the
    CPU; the JAX command scores native on unpacked slabs, ROADMAP C14)
    against the simulate backend's, which the test above holds to JAX."""
    got = {}
    for backend in ("simulate", "native"):
        d = str(sens_files["tmp"] / f"sens_{backend}")
        with port_noise(sens_files["z"]):
            cli.main(["get-sensitivity", "--config", STDIT_CFG, "--save_dir",
                      d, "--ckpt_path", sens_files["port"], "--num_samples",
                      "1", "--ptq_config", sens_files["plan"], "--targets",
                      "attn,cross_attn,mlp", "--backend",
                      backend, "--device",
                      "cpu"])
        got[backend] = _scores(d)
    _same_scores(got["native"], got["simulate"], rel=NATIVE_SCORE_REL)


def test_block_group_sensitivity_matches_jax(sens_files):
    d = _both(sens_files, "get-sensitivity", "bg", "--targets", "mlp",
              "--block_group_wise_quant", "--split_timestep", "1",
              "--block_group_bits", "4")
    got, want = _scores(d["port"]), _scores(d["jax"])
    assert len(want) == 2  # blocks x groups, one window
    _same_scores(got, want)
    ranges = analysis.block_group_to_range_scores(got, bit=4)
    assert set(ranges) == {"2-0"}
    cfg = analysis.generate_mp_config(ranges, high_fraction=0.5)
    assert sorted(cfg["2-0"].values()) == [4, 8]


def test_sensitivity_metrics_and_windows():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, 3, 4, 4)).astype(np.float32))
    w = v * 0.5
    from viditq_tpu.utils import metrics as jm
    from viditq_tpu_torch.utils import metrics as pm
    for name in ("mse", "flow", "clip_temp"):
        a = pm.make_sensitivity_metric(name)(w, v)
        b = jm.make_sensitivity_metric(name)(w.numpy(), v.numpy())
        assert abs(a - b) <= 1e-6 * max(abs(b), 1e-6), name
    assert abs(pm.psnr(w, v) - jm.psnr(w.numpy(), v.numpy())) < 1e-4
    with pytest.raises(NotImplementedError, match="CLIP"):
        pm.make_sensitivity_metric("clip")
    from viditq_tpu.pipelines import analysis as ja
    for n, s in ((20, 4), (3, 3), (10, 3)):
        assert analysis.uniform_windows(n, s) == ja.uniform_windows(n, s)
    vec = {"mse": {"a": 1.0, "b": 3.0, "c": 2.0},
           "flow": {"a": 0.5, "b": 0.1, "c": 0.2}}
    assert analysis.combine_sensitivity(vec) == ja.combine_sensitivity(vec)


def test_resolvers_match_jax():
    from viditq_tpu.pipelines import analysis as ja
    jbase, pbase = (j_load(DYN).default_layer,
                    load_quant_config(DYN).default_layer)
    cfg = workload.load_py_config(STDIT_CFG)
    names = [n for n, m in workload.build_model(cfg, device="cpu")
             .named_modules() if hasattr(m, "kernel")]
    fp = ("t_embedder", "final_layer")

    def quantized(resolve, base):
        return [n for n in names if resolve(n) == base]
    for pick in (lambda a, b: (a.single_target_resolver(b, "mlp", fp),),
                 lambda a, b: (a.partial_quant_resolver(b, names, 0.4, 3,
                                                        fp),),
                 lambda a, b: (a.quantize_until_resolver(b, names, 7, fp),),
                 lambda a, b: (a.block_group_resolver(b, 1, "attn", fp),)):
        (jr,), (pr,) = pick(ja, jbase), pick(analysis, pbase)
        got = quantized(pr, pbase)
        assert got and got == quantized(jr, jbase)
        assert all(pr(n) == pbase.disabled() for n in names if n not in got)
    for b in (4, 6):
        js, ps = ja.spec_with_bits(jbase, b), analysis.spec_with_bits(pbase, b)
        assert (ps.weight.n_bits, ps.act.n_bits) == (
            js.weight.n_bits, js.act.n_bits) == (b, b)
    scores = {"19-15": {"a": 3.0, "b": 1.0, "c": 2.0, "d": 0.5},
              "14-0": {"a": 0.1, "b": 0.2, "c": 0.3, "d": 0.4}}
    assert analysis.generate_mp_config(
        scores, fp_fraction=0.25, high_fraction=0.5) == ja.generate_mp_config(
        scores, fp_fraction=0.25, high_fraction=0.5)


def test_timestep_windows_on_the_port(files):
    """The segmented generation: a window over every step is the quantized
    sample, a window whose 'quantized' model is the fp one scores 0."""
    cfg = workload.load_py_config(STDIT_CFG)
    model, _ = _port_model(files)
    fp_model = workload.build_model(cfg, device="cpu")
    ckpt.load_params_into(fp_model, files["port"])
    from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
    from viditq_tpu_torch.samplers.iddpm import default_qctx_factory
    calibrate_weight_tables(model)
    sampler = workload.build_sampler(cfg)
    z = torch.from_numpy(files["z"])
    y, mask = (torch.from_numpy(a) for a in _probe_inputs(cfg, files["z"])[2:])
    y = torch.cat([y, y])
    qf = default_qctx_factory("quant")

    def q_apply(x, t, yy, mm, qctx):
        return model(x, t, yy, mm, qctx=qctx)

    def fp_apply(x, t, yy, mm, qctx=None):
        return fp_model(x, t, yy, mm)
    with torch.no_grad():
        fp = sampler.sample(fp_apply, z, y, mask)
        q = sampler.sample(q_apply, z, y, mask, qctx_factory=qf)
        n = sampler.schedule.n_steps
        windows = analysis.uniform_windows(n, n)
        got = analysis.timestep_window_sensitivity(
            sampler, fp_apply, q_apply, z, y, mask, [(n - 1, 0)] + windows,
            qf, fp_reference=fp)
        same = analysis.timestep_window_sensitivity(
            sampler, fp_apply, fp_apply, z, y, mask, windows, qf,
            fp_reference=fp)
    assert got[f"{n - 1}-0"] == analysis.frame_mse(q, fp) > 0
    assert all(v > 0 for v in got.values())
    assert all(v == 0 for v in same.values())
