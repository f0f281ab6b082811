"""The port's data pipeline (`viditq_tpu_torch/data/`, `utils/media.py`)
against the JAX package's on the same inputs, made with numpy from a
seed: every transform, video decoding of y4m / MJPEG AVI / GIF files the
test writes, the datasets and their loaders, `save_sample`'s files, and
the native preprocessing library.

Both packages run the same numpy and Pillow code, so every comparison is
exact (`array_equal`, equal bytes) but two: the native library against
its plain version (PIL filters a downscale, the C kernel samples
bilinearly: compared by structure, as the JAX package's own test does),
and the stochastic transforms, which are equal because both sides draw
from numpy Generators of the same seed.
"""

import filecmp

import numpy as np
import pytest

from test_video_io import _frames, write_gif, write_mjpeg_avi, write_y4m
from viditq_tpu.data import datasets as JD
from viditq_tpu.data import native as JN
from viditq_tpu.data import transforms as JT
from viditq_tpu.data import video_io as JV
from viditq_tpu.utils import media as JM
from viditq_tpu_torch.data import datasets as D
from viditq_tpu_torch.data import native as N
from viditq_tpu_torch.data import transforms as T
from viditq_tpu_torch.data import video_io as V
from viditq_tpu_torch.utils import media as M


def _clip(shape=(3, 3, 19, 27), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _raw(shape=(5, 30, 22, 3), seed=1):
    return np.random.default_rng(seed).integers(0, 255, shape, np.uint8)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    np.testing.assert_array_equal(a, b)
    assert np.asarray(a).dtype == np.asarray(b).dtype


# (name, call(module, rng)) of every functional op and transform class,
# stochastic ones on a Generator of seed 7
TRANSFORMS = {
    "crop": lambda m, r: m.crop(_clip(), 2, 3, 9, 11),
    "resize_bilinear": lambda m, r: m.resize(_clip(), (13, 31)),
    "resize_nearest": lambda m, r: m.resize(_clip(), (7, 40), "nearest"),
    "resize_scale": lambda m, r: m.resize_scale(_clip(), (12, 12)),
    "resized_crop": lambda m, r: m.resized_crop(_clip(), 1, 2, 10, 12,
                                                (16, 8)),
    "center_crop": lambda m, r: m.center_crop(_clip(), (10, 8)),
    "center_crop_short_edge": lambda m, r: m.center_crop_using_short_edge(
        _clip()),
    "random_shift_crop": lambda m, r: m.random_shift_crop(_clip(), r),
    "to_tensor": lambda m, r: m.to_tensor(_raw()),
    "normalize_video": lambda m, r: m.normalize_video(
        m.to_tensor(_raw()), [0.5, 0.4, 0.3], [0.5, 0.2, 0.1]),
    "hflip": lambda m, r: m.hflip(_clip()),
    "RandomCropVideo": lambda m, r: m.RandomCropVideo((8, 9), rng=r)(
        _clip()),
    "CenterCropResizeVideo": lambda m, r: m.CenterCropResizeVideo(16)(
        _clip()),
    "UCFCenterCropVideo": lambda m, r: m.UCFCenterCropVideo(16)(_clip()),
    "KineticsRandomCropResizeVideo": lambda m, r:
        m.KineticsRandomCropResizeVideo(16, rng=r)(_clip()),
    "CenterCropVideo": lambda m, r: m.CenterCropVideo((12, 14))(_clip()),
    "NormalizeVideo": lambda m, r: m.NormalizeVideo([0.2] * 3, [0.7] * 3)(
        _clip()),
    "ToTensorVideo": lambda m, r: m.ToTensorVideo()(_raw()),
    "RandomHorizontalFlipVideo": lambda m, r: [
        m.RandomHorizontalFlipVideo(rng=r)(_clip()) for _ in range(4)][-1],
    "TemporalRandomCrop": lambda m, r: tuple(
        np.asarray(m.TemporalRandomCrop(8, rng=r)(n)) for n in (3, 10, 100)),
    "center_crop_arr": lambda m, r: m.center_crop_arr(_raw((137, 251, 3)),
                                                      32),
    "get_transforms_video": lambda m, r: m.get_transforms_video(16, rng=r)(
        _raw((5, 48, 36, 3))),
    "get_transforms_image": lambda m, r: m.get_transforms_image(16, rng=r)(
        _raw((40, 52, 3))),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_matches_jax(name):
    fn = TRANSFORMS[name]
    got = fn(T, np.random.default_rng(7))
    want = fn(JT, np.random.default_rng(7))
    _same(got, want)


def test_transform_errors_match_jax():
    for m in (T, JT):
        with pytest.raises(ValueError, match="4D"):
            m.crop(_clip()[0], 0, 0, 1, 1)
        with pytest.raises(TypeError, match="uint8"):
            m.to_tensor(_clip())
        with pytest.raises(ValueError, match="larger"):
            m.RandomCropVideo(64)(_clip())


WRITERS = {"y4m": write_y4m, "avi": write_mjpeg_avi, "gif": write_gif}


@pytest.mark.parametrize("ext", list(WRITERS))
def test_decode_video_matches_jax(tmp_path, ext):
    path = str(tmp_path / f"clip.{ext}")
    WRITERS[ext](path, _frames(t=5, h=16, w=24))
    got = V.decode_video(path)
    assert got.shape == (5, 16, 24, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, JV.decode_video(path))
    np.testing.assert_array_equal(V.decode_video(path, max_frames=2),
                                  JV.decode_video(path, max_frames=2))


def test_y4m_reads_without_pillow(tmp_path, monkeypatch):
    """Without Pillow, .y4m clips whose frames are already at the target
    size load through numpy alone (the card's runs depend on it)."""
    import builtins
    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real(name, *a, **kw)
    path = str(tmp_path / "clip.y4m")
    write_y4m(path, _frames(t=3, h=16, w=16))
    want = JD.load_video(path, 3, (16, 16))
    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = D.load_video(path, 3, (16, 16))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ImportError):
        D.load_video(path, 3, (8, 8))


@pytest.mark.parametrize("shape,size", [((16, 16, 3), (16, 16)),
                                        ((20, 16, 3), (16, 16)),
                                        ((16, 40, 3), (16, 24)),
                                        ((33, 47, 3), (16, 16))],
                         ids=["identity", "crop-rows", "crop-cols",
                              "resize"])
def test_center_crop_resize_matches_jax(shape, size):
    # the first three keep the frame's size, so the port skips Pillow,
    # whose resize to the same size returns a copy: equal all the same
    img = _raw(shape, seed=2)
    got = D.center_crop_resize(img, size)
    np.testing.assert_array_equal(got, JD.center_crop_resize(img, size))
    assert got.shape == (*size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(D.normalize(got), JD.normalize(got))


def _clips_csv(tmp_path, n=6, shape=(9, 24, 18, 3), fmt="npz"):
    rows = []
    for i in range(n):
        p = tmp_path / f"v{i}.{fmt}"
        frames = _raw(shape, seed=10 + i)
        if fmt == "npz":
            np.savez(p, video=frames)
        else:
            write_y4m(str(p), frames)
        rows.append(f"{p.name},clip {i}")
    path = tmp_path / "d.csv"
    path.write_text("\n".join(rows))
    return str(path)


@pytest.mark.parametrize("fmt", ["npz", "y4m"])
def test_load_video_matches_jax(tmp_path, fmt):
    _clips_csv(tmp_path, n=1, fmt=fmt)
    path = str(tmp_path / f"v0.{fmt}")
    for n, size, step in ((4, (8, 8), 1), (12, (16, 12), 2)):  # loop-pads
        np.testing.assert_array_equal(D.load_video(path, n, size, step),
                                      JD.load_video(path, n, size, step))


@pytest.mark.parametrize("mode", ["default", "transform", "image"])
def test_dataset_from_csv_matches_jax(tmp_path, mode):
    from PIL import Image
    csv = _clips_csv(tmp_path)
    kw = dict(root=str(tmp_path))
    if mode == "image":
        for i in range(2):
            Image.fromarray(_raw((40, 52, 3), seed=20 + i)).save(
                tmp_path / f"im{i}.png")
        (tmp_path / "i.csv").write_text("im0.png,a pic\nim1.png,b pic")
        csv = str(tmp_path / "i.csv")
    items = []
    for m, tm in ((D, T), (JD, JT)):
        if mode == "default":
            ds = m.DatasetFromCSV(csv, num_frames=4, image_size=(8, 8), **kw)
        elif mode == "transform":
            ds = m.DatasetFromCSV(
                csv, num_frames=4, transform=tm.get_transforms_video(
                    8, rng=np.random.default_rng(3)),
                temporal_sample=tm.TemporalRandomCrop(
                    4, rng=np.random.default_rng(4)), **kw)
        else:
            ds = m.DatasetFromCSV(csv, image_size=(16, 16), **kw)
        items.append([ds[i] for i in range(len(ds))])
    for got, want in zip(*items):
        assert got["text"] == want["text"]
        np.testing.assert_array_equal(got["video"], want["video"])


def test_quant_calib_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "calib.npz")
    np.savez(path, xs=rng.standard_normal((3, 2, 4, 2, 4, 4)),
             ts=np.arange(3), y=rng.standard_normal((2, 1, 8, 32)))
    got, want = D.QuantCalibDataset(path), JD.QuantCalibDataset(path)
    assert len(got) == len(want) == 3
    for i in range(3):
        for k in ("xs", "ts", "y"):
            np.testing.assert_array_equal(got[i][k], want[i][k])


@pytest.mark.parametrize("workers", [0, 3])
def test_prepare_dataloader_order_matches_jax(tmp_path, workers):
    csv = _clips_csv(tmp_path)
    ds = D.DatasetFromCSV(csv, num_frames=2, image_size=(8, 8),
                          root=str(tmp_path))
    jds = JD.DatasetFromCSV(csv, num_frames=2, image_size=(8, 8),
                            root=str(tmp_path))
    got = list(D.prepare_dataloader(
        ds, D.StatefulSampler(len(ds), seed=2), 2, num_workers=workers))
    want = list(JD.batch_iterator(
        jds, JD.StatefulSampler(len(jds), seed=2), 2))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a["text"] == b["text"]
        np.testing.assert_array_equal(a["video"], b["video"])


def test_prepare_dataloader_propagates_errors():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("decode failed")
    with pytest.raises(RuntimeError, match="decode failed"):
        list(D.prepare_dataloader(Bad(), D.StatefulSampler(4, shuffle=False),
                                  2, num_workers=2))


@pytest.mark.parametrize("shape", [(3, 12, 10), (3, 4, 12, 10)],
                         ids=["image", "video"])
def test_save_sample_writes_jax_files(tmp_path, shape):
    x = np.clip(np.random.default_rng(6).standard_normal(shape), -1.2, 1.2)
    got = M.save_sample(x, str(tmp_path / "port" / "s"))
    want = JM.save_sample(x, str(tmp_path / "jax" / "s"))
    assert got.endswith(want[-4:])
    exts = (".png",) if len(shape) == 3 else (".gif", ".npz")
    for ext in exts:
        a, b = tmp_path / "port" / f"s{ext}", tmp_path / "jax" / f"s{ext}"
        if ext == ".npz":  # zip entries carry their write time
            np.testing.assert_array_equal(np.load(a)["video"],
                                          np.load(b)["video"])
        else:
            assert filecmp.cmp(a, b, shallow=False), ext


def test_native_library_matches_jax_and_its_plain_version():
    assert N.native_available()
    assert N.library_path().parent.name == "native"
    frames = _raw((3, 40, 60, 3), seed=8)
    got = N.preprocess_frames(frames, (32, 32))
    assert got.shape == (3, 3, 32, 32) and got.dtype == np.float32
    # the same C source as the JAX package's library: equal
    np.testing.assert_array_equal(got, JN.preprocess_frames(frames, (32, 32)))
    # the plain version is the JAX package's numpy/PIL fallback
    want = JD.normalize(np.stack([JD.center_crop_resize(f, (32, 32))
                                  for f in frames])).transpose(3, 0, 1, 2)
    np.testing.assert_array_equal(N.preprocess_frames_plain(frames, (32, 32)),
                                  want)
    # kernel vs plain: PIL filters a downscale, the C kernel samples
    # bilinearly; on a smooth image they agree in structure
    yy, xx = np.mgrid[0:33, 0:47]
    img = np.stack([(yy * 5) % 256, (xx * 4) % 256, (yy + xx) % 256],
                   axis=-1).astype(np.uint8)
    clip = np.stack([img, img[::-1]])
    a = N.preprocess_frames(clip, (16, 16))
    b = N.preprocess_frames_plain(clip, (16, 16))
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.9
    assert abs(a.mean() - b.mean()) < 0.05 and abs(a.std() - b.std()) < 0.1
