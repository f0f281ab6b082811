"""The port's data commands against the JAX CLI's on the same files and
the same VAE weights: `extract-features` (features.npz) and `train
--data_path` (the x0 each step trains on) with `--vae_ckpt`, and `train
--data_path --no_vae`.

The VAE's parameters are numpy draws at flax's shapes (conv and Dense
kernels N(0, 1 / fan_in), biases N(0, 0.1)), written as the JAX CLI's
msgpack and, through `utils/bridge.vae_state_dict_from_flax`, as the
port's params file. The JAX `train` is stopped where it hands its
dataset and encoder to `train_entry`: the test draws each step's batch
the way `train_entry` does (the resumable sampler, seed 0) and encodes
it with the JAX command's own encoder; training itself is held by
`tests/test_torch_train.py`. Tolerance: 2e-4 on the latents, the VAE
oracle tolerance (`tests/test_vae_oracle.py`); texts and the no-VAE x0
equal.
"""

import numpy as np
import pytest
import torch

from test_torch_vae import _params
from viditq_tpu import cli as jcli
from viditq_tpu.data.datasets import StatefulSampler as JSampler
from viditq_tpu.data.datasets import batch_iterator as j_batches
from viditq_tpu.models import vae as JV
from viditq_tpu.pipelines import train as jtrain
from viditq_tpu.utils import ckpt as jckpt
from viditq_tpu_torch import cli
from viditq_tpu_torch.pipelines import train as ptrain
from viditq_tpu_torch.utils import ckpt
from viditq_tpu_torch.utils.bridge import vae_state_dict_from_flax

TOL = 2e-4
CFG = "configs/workload/opensora_tiny.py"  # 4 frames of 64x64


@pytest.fixture(scope="module")
def vae_files(tmp_path_factory):
    """(JAX msgpack of the whole VideoAutoencoderKL, JAX msgpack of its
    encoder, the port's .pt of the whole VAE), the same numpy draws."""
    d = tmp_path_factory.mktemp("vae")
    params = _params(JV.VideoAutoencoderKL(),
                     np.zeros((1, 3, 1, 8, 8), np.float32), seed=12)
    encoder = {"module": {"encoder": params["module"]["encoder"]}}
    paths = [str(d / n) for n in ("vae.msgpack", "enc.msgpack", "vae.pt")]
    jckpt.save_params(paths[0], params)
    jckpt.save_params(paths[1], encoder)
    ckpt.save_params(paths[2], vae_state_dict_from_flax(params))
    return paths


def _clips(d, n, shape, channels=3):
    rows = []
    for i in range(n):
        p = d / f"c{i}.npz"
        np.savez(p, video=np.random.default_rng(30 + i).integers(
            0, 255, (*shape, channels), np.uint8))
        rows.append(f"{p},clip {i}")
    path = d / "data.csv"
    path.write_text("\n".join(rows))
    return str(path)


def test_extract_features_matches_jax(tmp_path, vae_files):
    csv = _clips(tmp_path, 5, (3, 24, 20))  # the last batch is dropped
    common = ["--csv", csv, "--num_frames", "2", "--image_size", "16",
              "--batch_size", "2"]
    jcli.main(["extract-features", *common, "--vae_ckpt", vae_files[0],
               "--save_dir", str(tmp_path / "jax")])
    out = cli.main(["extract-features", *common, "--vae_ckpt", vae_files[2],
                    "--device", "cpu", "--save_dir", str(tmp_path / "port")])
    want = np.load(tmp_path / "jax" / "features.npz", allow_pickle=True)
    got = np.load(out["out"], allow_pickle=True)
    assert sorted(got.files) == sorted(want.files) == ["latents", "texts"]
    assert got["latents"].shape == want["latents"].shape == (4, 4, 2, 2, 2)
    np.testing.assert_allclose(got["latents"], want["latents"], rtol=TOL,
                               atol=TOL)
    assert list(got["texts"]) == list(want["texts"]) == [
        f"clip {i}" for i in range(4)]
    assert out["n"] == 4 and out["seconds"] > 0


def _jax_x0(monkeypatch, argv):
    """The x0 of every step of the JAX `train --data_path` epoch, encoded by
    the command's own encode_batch (its train_entry stopped at entry)."""
    seen = {}

    def stop(model, dataset, *, encode_batch=None, batch_size=2, **kw):
        seen["x0"] = [encode_batch(raw, step)["x0"] for step, raw in
                      enumerate(j_batches(dataset, JSampler(len(dataset)),
                                          batch_size))]
        return None
    monkeypatch.setattr(jtrain, "train_entry", stop)
    jcli.main(["train", *argv])
    return [np.asarray(x) for x in seen["x0"]]


def _port_x0(monkeypatch, argv):
    """The port's `train --data_path` run and the x0 of each of its
    steps."""
    seen = []
    real = ptrain.make_encode_batch

    def spy(*a, **kw):
        encode = real(*a, **kw)

        def wrapped(batch, step):
            out = encode(batch, step)
            seen.append(out["x0"].detach().cpu().numpy())
            return out
        return wrapped
    monkeypatch.setattr(ptrain, "make_encode_batch", spy)
    return cli.main(["train", "--device", "cpu", *argv]), seen


@pytest.mark.parametrize("vae", ["vae_ckpt", "no_vae"])
def test_train_data_path_matches_jax(tmp_path, monkeypatch, vae_files, vae):
    """4 clips, batch 2: one epoch of 2 steps. With --vae_ckpt the pixels
    [3, 4, 64, 64] are encoded to [4, 4, 8, 8] latents; with --no_vae the
    items are 4-channel frames at the model's own latent size (a config
    copy whose image_size is that size, the model's input_size given),
    taken as x0 as they are."""
    config, shape, channels = CFG, (4, 64, 64), 3
    flags = ["--vae_ckpt", vae_files[1]]
    port_flags = ["--vae_ckpt", vae_files[2]]  # the whole VAE's file
    if vae == "no_vae":
        src = open(CFG).read()
        assert "image_size = (64, 64)" in src and "depth=2," in src
        config = str(tmp_path / "tiny_latent.py")
        open(config, "w").write(src.replace(
            "image_size = (64, 64)", "image_size = (8, 8)").replace(
            "depth=2,", "depth=2, input_size=(4, 8, 8),"))
        shape, channels = (4, 8, 8), 4
        flags = port_flags = ["--no_vae"]
    csv = _clips(tmp_path, 4, shape, channels)
    common = ["--config", config, "--data_path", csv, "--batch_size", "2"]
    want = _jax_x0(monkeypatch, [*common, *flags,
                                 "--save_dir", str(tmp_path / "jax")])
    out, got = _port_x0(monkeypatch, [*common, *port_flags, "--save_dir",
                                      str(tmp_path / "port"),
                                      "--ckpt_every", "2"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 4, 4, 8, 8)
        if vae == "no_vae":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert out["out"] == str(tmp_path / "port" / "train_state_2.pt")
    meta = ckpt.load_train_state(out["out"])[3]
    assert meta["sampler"] == {"epoch": 0, "start_index": 4}
    assert all(torch.isfinite(p).all() for p in out["params"].values())
