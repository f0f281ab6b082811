"""The port's VAE (`viditq_tpu_torch/models/vae.py`) against the JAX
package's (`viditq_tpu/models/vae.py`) on the same weights: the JAX
parameters are numpy draws from a seed at flax's shapes, carried to the
port by `utils/bridge.vae_state_dict_from_flax`; inputs are numpy draws.

Tolerances are the JAX package's own oracle tolerances
(`tests/test_vae_oracle.py`): 2e-4 for the spatial encoder, decoder and
autoencoder, 3e-4 for the temporal decoder (float32 convolutions and group
norms summed in another order by XLA and by PyTorch's CPU kernels). The
posterior draw cannot match threefry (C18): it is held to its formula,
mean + exp(logvar / 2) * noise, with the noise pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from viditq_tpu.models import vae as JV
from viditq_tpu_torch.models import vae as V
from viditq_tpu_torch.utils import workload
from viditq_tpu_torch.utils.bridge import vae_state_dict_from_flax

CH = (32, 32)  # tiny but GroupNorm(32)-compatible
TOL = 2e-4
TEMPORAL_TOL = 3e-4


def _params(module, *args, seed=0, method=None):
    """Numpy draws at the shapes of module's flax params: conv and Dense
    kernels N(0, 1 / fan_in) (flax's lecun scale), biases N(0, 0.1),
    GroupNorm scales 1 + N(0, 0.1), mix_factor 0.3 (the learned blend
    away from its init). Shapes only: `jax.eval_shape` runs no forward."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method))

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "mix_factor":
            return np.full(s.shape, 0.3, np.float32)
        a = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel":
            return a * np.float32(np.prod(s.shape[:-1]) ** -0.5)
        return (1.0 + 0.1 * a) if leaf == "scale" else 0.1 * a
    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _apply(module, method=None):
    """module.apply on {'params': p}, jitted: one compile, where eager flax
    compiles each primitive on its first call."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a,
                                              method=method))


def _load(port, params):
    port.load_state_dict(vae_state_dict_from_flax(params), strict=True)
    return port.eval()


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _draw(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("part", ["encoder", "decoder", "temporal"])
def test_vae_parts_match_jax(part):
    """Encoder / Decoder / TemporalDecoder at block_out_channels (32, 32),
    one layer a block (NHWC in JAX, NCHW here)."""
    T = 4
    if part == "encoder":
        jm = JV.Encoder(block_out_channels=CH, layers_per_block=1)
        pm = V.Encoder(block_out_channels=CH, layers_per_block=1)
        x = _draw((2, 16, 16, 3), 0)
    elif part == "decoder":
        jm = JV.Decoder(block_out_channels=CH, layers_per_block=1)
        pm = V.Decoder(block_out_channels=CH, layers_per_block=1)
        x = _draw((2, 4, 4, 4), 1)
    else:
        jm = JV.TemporalDecoder(block_out_channels=CH, layers_per_block=1,
                                num_frames=T)
        pm = V.TemporalDecoder(block_out_channels=CH, layers_per_block=1,
                               num_frames=T)
        x = _draw((2 * T, 4, 4, 4), 2)
    params = _params(jm, x, seed=3)
    want = np.asarray(_apply(jm)(params, x))
    with torch.no_grad():
        got = _load(pm, params)(_nchw(x))
    _close(got, want.transpose(0, 3, 1, 2),
           TEMPORAL_TOL if part == "temporal" else TOL)


@pytest.fixture(scope="module")
def full_kl():
    """The full-width AutoencoderKL (128/256/512/512) in both packages on
    the same drawn parameters."""
    jm = JV.AutoencoderKL()
    params = _params(jm, _draw((1, 3, 32, 32), 4), seed=4)
    return jm, params, _load(V.AutoencoderKL(), params)


def test_full_autoencoder_kl_matches_jax(full_kl):
    """One 32x32 image encoded to its posterior mean and decoded."""
    jm, params, port = full_kl
    x = _draw((1, 3, 32, 32), 5)
    want_z = np.asarray(_apply(jm, jm.encode)(params, x))
    want = np.asarray(_apply(jm, jm.decode)(params, want_z))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
        got = port.decode(torch.from_numpy(want_z.copy()))
    assert z.shape == (1, 4, 4, 4) and got.shape == (1, 3, 32, 32)
    _close(z, want_z, TOL)
    _close(got, want, TOL)


def test_posterior_draw_is_its_formula(full_kl):
    """encode(x, generator): (mean + exp(clip(logvar) / 2) * noise) *
    0.18215, the noise the generator's N(0, 1) draw; the JAX package's
    formula on its own encoder output with that noise pinned gives the
    same."""
    jm, params, port = full_kl
    x = _draw((1, 3, 32, 32), 6)
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x),
                          generator=torch.Generator().manual_seed(11))
        mean_only = port.encode(torch.from_numpy(x))
    noise = torch.randn((1, 4, 4, 4),
                        generator=torch.Generator().manual_seed(11)).numpy()
    h = np.asarray(_apply(jm, lambda m, a: m.encoder(a))(
        params, x.transpose(0, 2, 3, 1)))
    mean, logvar = np.split(h.transpose(0, 3, 1, 2), 2, axis=1)
    want = (mean + np.exp(0.5 * np.clip(logvar, -30.0, 20.0)) * noise) \
        * jm.scaling_factor
    _close(got, want, TOL)
    assert np.abs(got.numpy() - mean_only.numpy()).max() > 1e-3


def test_video_autoencoder_micro_batches_match_jax(full_kl):
    """VideoAutoencoderKL, 3 frames in micro-batches of 2: encode and
    decode frame-wise as JAX does, and as one batch would."""
    _, params, _ = full_kl
    jm = JV.VideoAutoencoderKL(micro_batch_size=2)
    wrapped = {"module": params}
    port = _load(V.VideoAutoencoderKL(micro_batch_size=2), wrapped)
    x = _draw((1, 3, 3, 16, 16), 7)
    want_z = np.asarray(_apply(jm, jm.encode)(wrapped, x))
    want = np.asarray(_apply(jm, jm.decode)(wrapped, want_z))
    with torch.no_grad():
        z = port.encode(torch.from_numpy(x))
        got = port.decode(torch.from_numpy(want_z.copy()))
        port.micro_batch_size = None
        whole = port.encode(torch.from_numpy(x))
    _close(z, want_z, TOL)
    torch.testing.assert_close(whole, z, rtol=1e-5, atol=1e-6)
    assert got.shape == (1, 3, 3, 16, 16)
    _close(got, want, TOL)
    assert port.get_latent_size([3, 16, 16]) == jm.get_latent_size(
        [3, 16, 16]) == [3, 2, 2]


def test_temporal_decoder_wrapper_matches_jax():
    jm = JV.VideoAutoencoderKLTemporalDecoder(
        num_frames=2, block_out_channels=CH, layers_per_block=1)
    z = _draw((1, 4, 2, 4, 4), 8)
    params = _params(jm, z, seed=9)
    port = _load(V.VideoAutoencoderKLTemporalDecoder(
        num_frames=2, block_out_channels=CH, layers_per_block=1), params)
    want = np.asarray(_apply(jm)(params, z))
    with torch.no_grad():
        got = port.decode(torch.from_numpy(z))
    assert got.shape == (1, 3, 2, 8, 8)
    _close(got, want, TEMPORAL_TOL)
    assert port.get_latent_size([2, 32, 32]) == [2, 4, 4]
    with pytest.raises(NotImplementedError):
        port.encode(torch.from_numpy(z))
    with pytest.raises(ValueError, match="frames"):
        port.decode(torch.from_numpy(z[:, :, :1]))


def test_build_vae_kinds():
    """The three kinds as JAX workload.build_vae picks them; the encoder
    alone with decoder=False; the card by default."""
    video = workload.build_vae({"vae": dict(type="VideoAutoencoderKL",
                                            micro_batch_size=128)},
                               device="cpu")
    assert isinstance(video, V.VideoAutoencoderKL)
    assert video.micro_batch_size == 128 and not video.training
    temporal = workload.build_vae(
        {"vae": dict(type="VideoAutoencoderKLTemporalDecoder",
                     from_pretrained="x"), "num_frames": 8}, device="cpu")
    assert isinstance(temporal, V.VideoAutoencoderKLTemporalDecoder)
    assert temporal.num_frames == 8
    frame = workload.build_vae({"vae": dict(type="AutoencoderKL")},
                               device="cpu", decoder=False)
    assert isinstance(frame, V.AutoencoderKL) and frame.decoder is None
    assert isinstance(workload.build_vae({}, device="cpu"),
                      V.VideoAutoencoderKL)
    enc = workload.build_vae({}, device="cpu", decoder=False)
    assert not any(n.startswith("module.decoder")
                   for n, _ in enc.named_parameters())
    with pytest.raises(RuntimeError, match="decoder"):
        enc.decode(torch.zeros(1, 4, 1, 2, 2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            workload.build_vae({})
