"""The port's command line with every `--sampler_type` (`python -m
viditq_tpu_torch.cli`, `--device cpu`) on the tiny workloads
(`configs/workload/{opensora,pixart}_tiny.py`).

Each choice runs in a fresh process; in this process, `inference`,
`get-calib-data` and `quant-generate` (`w8a8_dynamic.yaml` on the native
backend: K7a -> K7b's plain versions) write what the in-process
pipelines give for the same sampler, latent, prompts and generator
(`cli.sampler_generator`: --seed on --device, after the latent's draw).
No choice falls back to another loop: the ancestral sample differs from
the DDIM one, and a model without learned variance refuses it.
`get-sensitivity` samples by the choice too. `build_sampler` resolves
each choice as the JAX package's does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from viditq_tpu.utils import workload as j_workload
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines import inference as inf
from viditq_tpu_torch.quant.calibrate import calibrate_weight_tables
from viditq_tpu_torch.quant.native_pack import pack_native_weights
from viditq_tpu_torch.utils import workload
from viditq_tpu_torch.utils.config import load_quant_config

STDIT_CFG = "configs/workload/opensora_tiny.py"
PIXART_CFG = "configs/workload/pixart_tiny.py"
DYN = "configs/opensora/w8a8_dynamic.yaml"
# the choices on the workload whose scheduler they keep or replace
CHOICES = [(STDIT_CFG, "ddim"), (STDIT_CFG, "iddpm"), (PIXART_CFG, "dpms"),
           (PIXART_CFG, "dpm-solver"), (PIXART_CFG, "sa-solver"),
           (PIXART_CFG, "lcm"), (PIXART_CFG, "edm")]
SEED = 7


def _ids(choices):
    return [st for _, st in choices]


@pytest.mark.parametrize("config", [STDIT_CFG, PIXART_CFG])
@pytest.mark.parametrize("split", [False, True])
def test_build_sampler_resolves_like_jax(config, split):
    """JAX's rules (workload.py:70-95): every choice on both workloads
    gives the JAX sampler's class, steps, scale and cfg_split (the
    IDDPM and DPM-Solver samplers' only)."""
    for st in workload.SAMPLER_TYPES:
        js = j_workload.build_sampler(j_workload.load_py_config(config),
                                      cfg_split=split, override_type=st)
        ps = workload.build_sampler(workload.load_py_config(config),
                                    cfg_split=split, override_type=st)
        assert type(ps).__name__ == type(js).__name__, st
        assert ps.cfg_scale == js.cfg_scale
        assert getattr(ps, "cfg_split", None) == getattr(js, "cfg_split",
                                                         None)
        steps = (lambda s: getattr(s, "steps", None) or s.schedule.n_steps)
        assert steps(ps) == steps(js)


def _in_process(config, sampler_type, plan=None):
    """The CLI's set-up in this process: (model, sampler, z, y, mask,
    the samplers' generator)."""
    argv = ["inference", "--config", config, "--device", "cpu",
            "--num_samples", "1", "--seed", str(SEED), "--sampler_type",
            sampler_type]
    args = cli.build_parser().parse_args(argv)
    cfg = workload.load_py_config(config)
    resolver = plan.resolver() if plan else None
    model = workload.build_model(cfg, resolver, device="cpu")
    cli.init_params(model, args)
    sampler = workload.build_sampler(
        cfg, cfg_split=bool(plan.cfg_split) if plan else False,
        override_type=sampler_type)
    y, mask = cli._load_embeds(args, cfg, 1)
    shape = (1, 4, *workload.latent_size(cfg))
    return (model, sampler, cli.noise(shape, SEED, "cpu"), y, mask,
            cli.sampler_generator(shape, SEED, "cpu"))


def _run(cmd, config, save_dir, sampler_type, *extra):
    return cli.main([cmd, "--config", config, "--save_dir", str(save_dir),
                     "--device", "cpu", "--num_samples", "1", "--seed",
                     str(SEED), "--sampler_type", sampler_type, *extra])


def _samples(out):
    return np.load(out["out"])["samples"]


@pytest.mark.parametrize("config,sampler_type", CHOICES, ids=_ids(CHOICES))
def test_every_choice_runs_in_a_fresh_process(config, sampler_type,
                                              tmp_path):
    env = {**os.environ, "PYTHONPATH": os.getcwd()}
    r = subprocess.run(
        [sys.executable, "-m", "viditq_tpu_torch.cli", "inference",
         "--config", config, "--save_dir", str(tmp_path), "--device", "cpu",
         "--num_samples", "1", "--sampler_type", sampler_type],
        capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    got = np.load(tmp_path / "fp_samples.npz")["samples"]
    assert got.shape[0] == 1 and np.isfinite(got).all()


@pytest.mark.parametrize("config,sampler_type", CHOICES, ids=_ids(CHOICES))
def test_inference_equals_in_process_sampler(config, sampler_type,
                                            tmp_path):
    out = _run("inference", config, tmp_path, sampler_type)
    model, sampler, z, y, mask, gen = _in_process(config, sampler_type)
    want = inf.fp_sample(model, sampler, z, y, mask,
                         sampler_type=sampler_type, generator=gen)
    np.testing.assert_array_equal(_samples(out), want.numpy())
    assert out["steps"] == workload.load_py_config(config)["scheduler"][
        "num_sampling_steps"]


def test_no_choice_falls_back(tmp_path):
    """The ancestral loop is not DDIM (the latent moves by more than 1e-2
    relative), its draws follow --seed, and it refuses a model without
    the learned variance channels."""
    runs = {st: _samples(_run("inference", STDIT_CFG, tmp_path / st, st))
            for st in ("ddim", "iddpm")}
    diff = np.linalg.norm(runs["iddpm"] - runs["ddim"]) / np.linalg.norm(
        runs["ddim"])
    assert diff > 1e-2
    again = _samples(_run("inference", STDIT_CFG, tmp_path / "again",
                          "iddpm", "--seed", str(SEED + 1)))
    assert not np.array_equal(again, runs["iddpm"])
    src = open(STDIT_CFG).read().replace("model_max_length=8,",
                                         "model_max_length=8,\n"
                                         "    pred_sigma=False,")
    cfg = tmp_path / "no_sigma.py"
    cfg.write_text(src)
    with pytest.raises(ValueError, match="variance"):
        _run("inference", str(cfg), tmp_path / "no_sigma", "iddpm")
    _run("inference", str(cfg), tmp_path / "no_sigma", "ddim")
    with pytest.raises(SystemExit):  # argparse's choices, as in JAX
        _run("inference", STDIT_CFG, tmp_path, "euler")


@pytest.mark.parametrize("sampler_type", ["iddpm", "sa-solver", "lcm",
                                          "edm"])
def test_get_calib_data_equals_in_process(sampler_type, tmp_path):
    config = STDIT_CFG if sampler_type == "iddpm" else PIXART_CFG
    out = _run("get-calib-data", config, tmp_path, sampler_type)
    data = np.load(out["out"])
    model, sampler, z, y, mask, gen = _in_process(config, sampler_type)
    want = inf.get_calib_data(model, sampler, z, y, mask,
                              sampler_type=sampler_type, generator=gen)
    # one-batch trajectories (the solvers, LCM) doubled to [cond; null]
    assert data["xs"].shape[1] == 2
    np.testing.assert_array_equal(data["xs"], want["xs"].numpy())
    np.testing.assert_array_equal(data["ts"], want["ts"].numpy())


QUANT_CHOICES = [(STDIT_CFG, "iddpm"), (PIXART_CFG, "sa-solver"),
                 (PIXART_CFG, "lcm"), (PIXART_CFG, "edm")]


@pytest.mark.parametrize("config,sampler_type", QUANT_CHOICES,
                         ids=_ids(QUANT_CHOICES))
def test_quant_generate_equals_in_process(config, sampler_type, tmp_path):
    out = _run("quant-generate", config, tmp_path, sampler_type,
               "--ptq_config", DYN, "--backend", "native")
    plan = load_quant_config(DYN).with_backend("native")
    model, sampler, z, y, mask, gen = _in_process(config, sampler_type, plan)
    calibrate_weight_tables(model)
    pack_native_weights(model)
    want = inf.quant_sample(model, sampler, z, y, mask,
                            sampler_type=sampler_type, generator=gen)
    np.testing.assert_array_equal(_samples(out), want.numpy())
    fp = _samples(_run("inference", config, tmp_path / "fp", sampler_type))
    assert 0 < np.linalg.norm(_samples(out) - fp) / np.linalg.norm(fp) < 0.1


def test_get_sensitivity_samples_by_the_choice(tmp_path):
    common = ("--ptq_config", DYN, "--backend", "native", "--targets",
              "attn")
    scores = {st: _run("get-sensitivity", STDIT_CFG, tmp_path / st, st,
                       *common)["scores"]["attn"]
              for st in ("ddim", "iddpm")}
    assert all(np.isfinite(v) and v > 0 for v in scores.values())
    assert scores["iddpm"] != scores["ddim"]
