"""The port's `train` command (`python -m viditq_tpu_torch.cli train`, run
here with `--device cpu`) on the tiny STDiT workload
(`configs/workload/opensora_tiny.py`): its log, its checkpoints and
their meta, a resume that reproduces the uninterrupted run exactly,
gradient accumulation with warmup (whose first step is the identity),
a config's `grad_checkpoint`, training over a CSV dataset (`--data_path`,
the VAE encoding each batch), the refusals, and its flags against the JAX
CLI's.
"""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from viditq_tpu_torch import cli
from viditq_tpu_torch.utils import ckpt, workload

CFG = "configs/workload/opensora_tiny.py"
ROOT = Path(__file__).resolve().parent.parent


def _train(save_dir, *extra, config=CFG):
    return cli.main(["train", "--device", "cpu", "--config", config,
                     "--save_dir", str(save_dir), *extra])


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """4 steps, a checkpoint every 2, clipping at 1.0."""
    d = tmp_path_factory.mktemp("train_full")
    return d, _train(d, "--num_steps", "4", "--ckpt_every", "2",
                     "--grad_clip", "1.0")


def test_train_writes_its_log_and_checkpoints(full):
    d, out = full
    log = [json.loads(ln) for ln in open(d / "train_log.jsonl")]
    # one line at the last step (log_every 10), the average of 4 losses
    assert [r["step"] for r in log] == [4]
    assert np.isclose(log[0]["avg_loss"], np.mean(out["losses"]), rtol=1e-6)
    assert np.isclose(log[0]["loss"], out["losses"][-1], rtol=1e-6)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert out["out"] == str(d / "train_state_4.pt")
    assert out["seconds"] > 0 and out["ms_per_step"] > 0
    for step in (2, 4):
        path = d / f"train_state_{step}.pt"
        with open(str(path) + ".meta.json") as f:
            assert json.load(f) == {"epoch": 0, "step": step,
                                    "global_step": step}
        params, ema, opt, meta = ckpt.load_train_state(str(path))
        assert meta["step"] == step and opt["count"] == step
        assert params.keys() == ema.keys() == opt["mu"].keys()
    params, ema, _, _ = ckpt.load_train_state(str(d / "train_state_4.pt"))
    for n, p in out["params"].items():
        assert torch.equal(params[n], p.detach()), n
        assert torch.equal(ema[n], out["ema"][n]), n
        assert params[n].dtype == torch.float32


def test_resume_reproduces_the_uninterrupted_run(full, tmp_path):
    d, out = full
    res = _train(tmp_path, "--num_steps", "4", "--grad_clip", "1.0",
                 "--resume_from", str(d / "train_state_2.pt"))
    assert res["out"] is None  # no --ckpt_every: nothing written
    assert res["losses"] == out["losses"][2:]
    for k in ("params", "ema"):
        for n, v in out[k].items():
            assert torch.equal(v, res[k][n]), (k, n)


def test_grad_accum_with_warmup(tmp_path):
    """--grad_accum 2 (batch 4, two microbatches) under --warmup_steps 2:
    the first step's rate is 0, so the parameters are the initial draw;
    the second moves them."""
    cfg = workload.load_py_config(CFG)
    # the train command's draw: JAX's initialisers (ROADMAP C20)
    init = workload.jax_init_(workload.build_model(cfg, device="cpu"),
                              cli.INIT_SEED)
    one = _train(tmp_path / "a", "--num_steps", "1", "--grad_accum", "2",
                 "--warmup_steps", "2")
    two = _train(tmp_path / "b", "--num_steps", "2", "--grad_accum", "2",
                 "--warmup_steps", "2")
    assert one["losses"] == two["losses"][:1]
    for n, p in init.named_parameters():
        assert torch.equal(one["params"][n], p), n
    assert any(not torch.equal(two["params"][n], p)
               for n, p in init.named_parameters())
    assert one["ms_per_step"] is None


def test_config_grad_checkpoint_trains_the_same(full, tmp_path):
    """A config with model=dict(grad_checkpoint=True) builds a model that
    recomputes its blocks, and trains to the same parameters."""
    src = open(CFG).read()
    assert "depth=2," in src
    path = tmp_path / "tiny_gc.py"
    path.write_text(src.replace("depth=2,", "depth=2, grad_checkpoint=True,"))
    cfg = workload.load_py_config(str(path))
    assert workload.build_model(cfg, device="cpu").grad_checkpoint
    _, out = full
    gc = _train(tmp_path / "gc", "--num_steps", "4", "--grad_clip", "1.0",
                config=str(path))
    assert gc["losses"] == out["losses"]
    for n, v in out["params"].items():
        assert torch.equal(v, gc["params"][n]), n


# --dp/--sp/--tp above 1 outside torchrun: the world size (1) is not
# dp x sp x tp (parallel training itself: tests/test_torch_train_parallel.py)
@pytest.mark.parametrize("extra,error,match", [
    (("--dp", "2"), SystemExit, "world size 1 differs"),
    (("--sp", "2"), SystemExit, "world size 1 differs"),
    (("--tp", "2"), SystemExit, "world size 1 differs"),
    (("--no_vae",), ValueError, "--data_path"),
    (("--vae_ckpt", "vae.msgpack"), ValueError, "--data_path"),
], ids=["extra0-NotImplementedError-item 6",
        "extra1-NotImplementedError-item 6",
        "extra2-NotImplementedError-item 6",
        "extra4-ValueError---data_path", "extra5-ValueError---data_path"])
def test_train_refuses_what_is_not_ported(tmp_path, extra, error, match):
    with pytest.raises(error, match=match):
        _train(tmp_path, "--num_steps", "1", *extra)
    assert not os.path.exists(tmp_path / "train_log.jsonl")


def test_train_data_path_runs(tmp_path, capsys):
    """`--data_path` (it raised until the dataset and the VAE were ported):
    an epoch over a CSV of 6 clips at batch 2 is 3 steps, each batch's
    pixels encoded by the VAE drawn from JAX's initialisers (with the JAX
    CLI's warning); the checkpoint's meta holds the sampler's place, and a
    second epoch continues the step count (parity with the JAX command:
    tests/test_torch_cli_data.py)."""
    rows = []
    for i in range(6):
        p = tmp_path / f"clip{i}.npz"
        np.savez(p, video=np.random.default_rng(i).integers(
            0, 255, (4, 64, 64, 3), np.uint8))
        rows.append(f"{p},clip {i}")
    (tmp_path / "d.csv").write_text("\n".join(rows))
    out = _train(tmp_path / "run", "--data_path", str(tmp_path / "d.csv"),
                 "--epochs", "2", "--ckpt_every", "3")
    assert "RANDOM-weight VAE" in capsys.readouterr().err
    assert len(out["losses"]) == 6 and np.isfinite(out["losses"]).all()
    assert out["out"] == str(tmp_path / "run" / "train_state_6.pt")
    assert out["ms_per_step"] > 0
    with open(out["out"] + ".meta.json") as f:
        assert json.load(f) == {"epoch": 1, "step": 3, "global_step": 6,
                                "sampler": {"epoch": 1, "start_index": 6}}


def _jax_train_flags():
    """{flag: default} of the JAX CLI's train parser (viditq_tpu/cli.py
    main), read from its source."""
    tree = ast.parse((ROOT / "viditq_tpu/cli.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags, inside = {}, False
    for stmt in main.body:  # in source order
        node = getattr(stmt, "value", None)
        if not isinstance(node, ast.Call):
            continue
        name = getattr(node.func, "attr", None)
        if name == "add_parser":
            inside = getattr(node.args[0], "value", None) == "train"
        elif name == "add_argument" and inside:
            kw = {k.arg: k.value for k in node.keywords}
            default = kw.get("default")
            flags[node.args[0].value] = (
                ast.literal_eval(default) if default is not None else
                (False if "action" in kw else None))
    return flags


def test_train_flags_match_the_jax_cli():
    """Every JAX train flag with its default, but --ckpt_format (flax
    msgpack or orbax: the port writes one torch.save format), plus
    --device."""
    jax_flags = _jax_train_flags()
    assert "--ckpt_format" in jax_flags and len(jax_flags) > 15
    sub = next(a for a in cli.build_parser()._actions
               if a.dest == "cmd").choices["train"]
    port = {a.option_strings[0]: a.default for a in sub._actions
            if a.option_strings and a.dest != "help"}
    want = {k: v for k, v in jax_flags.items() if k != "--ckpt_format"}
    assert port == {**want, "--device": cli.DEFAULT_DEVICE}
