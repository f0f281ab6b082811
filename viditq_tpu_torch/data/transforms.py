"""Video/image transform zoo (a copy of `viditq_tpu/data/transforms.py`;
reference `t2v/opensora/datasets/video_transforms.py` + `datasets.py:14-35`
factories), numpy only but `center_crop_arr` (PIL): the port does not
import the JAX package.

Clips are numpy arrays: raw decode is [T, H, W, C] uint8; ToTensorVideo
converts to [T, C, H, W] float32 in [0, 1] (the reference's TCHW layout,
video_transforms.py:143-157); everything downstream keeps that layout.
`resize` matches torch.nn.functional.interpolate(mode='bilinear',
align_corners=False) exactly, so the pipeline is numerically
interchangeable with the reference's.

Randomness is explicit: stochastic transforms take a numpy Generator
(the reference uses global torch RNG, video_transforms.py:219,139)."""

from __future__ import annotations

import numbers
from typing import Optional, Sequence, Tuple

import numpy as np


def _check_clip(clip: np.ndarray):
    if clip.ndim != 4:
        raise ValueError(f"clip should be a 4D array, got {clip.shape}")


def _size2(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return (int(size), int(size))
    if len(size) != 2:
        raise ValueError(f"size should be (height, width), got {size}")
    return (int(size[0]), int(size[1]))


# ---------------- functional ops (video_transforms.py:51-188) ------------

def crop(clip: np.ndarray, i: int, j: int, h: int, w: int) -> np.ndarray:
    """[T, C, H, W] spatial crop (video_transforms.py:51-58)."""
    _check_clip(clip)
    return clip[..., i:i + h, j:j + w]


def resize(clip: np.ndarray, target_size: Tuple[int, int],
           interpolation_mode: str = "bilinear",
           _inv_scales: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """torch F.interpolate(align_corners=False) equivalent over the last
    two axes (video_transforms.py:61-64). _inv_scales overrides the
    in/out coordinate ratio (torch's scale_factor path keeps the given
    float scale instead of recomputing out/in)."""
    if len(target_size) != 2:
        raise ValueError(f"target size should be (height, width), "
                         f"got {target_size}")
    th, tw = int(target_size[0]), int(target_size[1])
    x = np.asarray(clip, np.float32)
    H, W = x.shape[-2:]
    if (H, W) == (th, tw) and _inv_scales is None:
        return x
    if interpolation_mode == "nearest":
        yi = np.minimum((np.arange(th) * H / th).astype(np.int64), H - 1)
        xi = np.minimum((np.arange(tw) * W / tw).astype(np.int64), W - 1)
        return x[..., yi[:, None], xi[None, :]]
    if interpolation_mode != "bilinear":
        raise ValueError(f"unsupported interpolation {interpolation_mode}")

    inv_y, inv_x = _inv_scales or (H / th, W / tw)

    def axis_weights(out_n, in_n, inv):
        src = (np.arange(out_n, dtype=np.float64) + 0.5) * inv - 0.5
        i0f = np.floor(src)
        w1 = (src - i0f).astype(np.float32)
        i0 = np.clip(i0f, 0, in_n - 1).astype(np.int64)
        i1 = np.clip(i0f + 1, 0, in_n - 1).astype(np.int64)
        return i0, i1, w1

    y0, y1, wy = axis_weights(th, H, inv_y)
    x0, x1, wx = axis_weights(tw, W, inv_x)
    top = x[..., y0, :] * (1 - wy)[:, None] + x[..., y1, :] * wy[:, None]
    return top[..., x0] * (1 - wx) + top[..., x1] * wx


def resize_scale(clip: np.ndarray, target_size: Tuple[int, int],
                 interpolation_mode: str = "bilinear") -> np.ndarray:
    """Scale so the SHORT edge reaches target_size[0]
    (video_transforms.py:67-72: scale_factor = target[0]/min(H, W))."""
    if len(target_size) != 2:
        raise ValueError(f"target size should be (height, width), "
                         f"got {target_size}")
    H, W = clip.shape[-2:]
    scale = target_size[0] / min(H, W)
    # torch interpolate(scale_factor=s) floors the output size and keeps
    # the GIVEN scale for the coordinate transform
    return resize(clip, (int(H * scale), int(W * scale)),
                  interpolation_mode, _inv_scales=(1 / scale, 1 / scale))


def resized_crop(clip: np.ndarray, i: int, j: int, h: int, w: int,
                 size: Tuple[int, int],
                 interpolation_mode: str = "bilinear") -> np.ndarray:
    """Crop then resize (video_transforms.py:75-92)."""
    _check_clip(clip)
    return resize(crop(clip, i, j, h, w), size, interpolation_mode)


def center_crop(clip: np.ndarray, crop_size: Tuple[int, int]) -> np.ndarray:
    """video_transforms.py:95-105."""
    _check_clip(clip)
    h, w = clip.shape[-2:]
    th, tw = crop_size
    if h < th or w < tw:
        raise ValueError("height and width must be no smaller than "
                         "crop_size")
    i = int(round((h - th) / 2.0))
    j = int(round((w - tw) / 2.0))
    return crop(clip, i, j, th, tw)


def center_crop_using_short_edge(clip: np.ndarray) -> np.ndarray:
    """Square center crop at the short edge (video_transforms.py:108-120)."""
    _check_clip(clip)
    h, w = clip.shape[-2:]
    if h < w:
        th, tw, i, j = h, h, 0, int(round((w - h) / 2.0))
    else:
        th, tw, i, j = w, w, int(round((h - w) / 2.0)), 0
    return crop(clip, i, j, th, tw)


def random_shift_crop(clip: np.ndarray,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """Square crop of short-edge size, slid randomly along the long edge
    (video_transforms.py:123-140)."""
    _check_clip(clip)
    rng = rng or np.random.default_rng()
    h, w = clip.shape[-2:]
    short = min(h, w)
    i = int(rng.integers(0, h - short + 1))
    j = int(rng.integers(0, w - short + 1))
    return crop(clip, i, j, short, short)


def to_tensor(clip: np.ndarray) -> np.ndarray:
    """[T, H, W, C] uint8 -> [T, C, H, W] float32 / 255
    (video_transforms.py:143-157; the reference additionally permutes —
    our raw decode is already THWC)."""
    if clip.dtype != np.uint8:
        raise TypeError(f"clip should be uint8, got {clip.dtype}")
    return clip.transpose(0, 3, 1, 2).astype(np.float32) / 255.0


def normalize_video(clip: np.ndarray, mean: Sequence[float],
                    std: Sequence[float]) -> np.ndarray:
    """Per-channel normalize of a [T, C, H, W] float clip
    (video_transforms.py:159-176)."""
    _check_clip(clip)
    if not np.issubdtype(clip.dtype, np.floating):
        raise TypeError("clip should be float for normalize")
    mean = np.asarray(mean, clip.dtype)[:, None, None]
    std = np.asarray(std, clip.dtype)[:, None, None]
    return (clip - mean) / std


def hflip(clip: np.ndarray) -> np.ndarray:
    """video_transforms.py:179-188."""
    _check_clip(clip)
    return clip[..., ::-1]


# ---------------- transform classes (video_transforms.py:191-446) --------

class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip


class RandomCropVideo:
    """video_transforms.py:191-225."""

    def __init__(self, size, rng: Optional[np.random.Generator] = None):
        self.size = _size2(size)
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        i, j, h, w = self.get_params(clip)
        return crop(clip, i, j, h, w)

    def get_params(self, clip):
        h, w = clip.shape[-2:]
        th, tw = self.size
        if h < th or w < tw:
            raise ValueError(f"Required crop size {(th, tw)} is larger "
                             f"than input image size {(h, w)}")
        if (h, w) == (th, tw):
            return 0, 0, h, w
        return (int(self.rng.integers(0, h - th + 1)),
                int(self.rng.integers(0, w - tw + 1)), th, tw)


class CenterCropResizeVideo:
    """Short-edge square center crop, then resize to size
    (video_transforms.py:228-263)."""

    def __init__(self, size, interpolation_mode: str = "bilinear"):
        self.size = _size2(size)
        self.interpolation_mode = interpolation_mode

    def __call__(self, clip):
        return resize(center_crop_using_short_edge(clip), self.size,
                      self.interpolation_mode)


class UCFCenterCropVideo:
    """Short-edge scale to size, then center crop
    (video_transforms.py:266-300)."""

    def __init__(self, size, interpolation_mode: str = "bilinear"):
        self.size = _size2(size)
        self.interpolation_mode = interpolation_mode

    def __call__(self, clip):
        return center_crop(
            resize_scale(clip, self.size, self.interpolation_mode),
            self.size)


class KineticsRandomCropResizeVideo:
    """Random short-edge square crop, resize to size
    (video_transforms.py:302-324)."""

    def __init__(self, size, interpolation_mode: str = "bilinear",
                 rng: Optional[np.random.Generator] = None):
        self.size = _size2(size)
        self.interpolation_mode = interpolation_mode
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        return resize(random_shift_crop(clip, self.rng), self.size,
                      self.interpolation_mode)


class CenterCropVideo:
    """Plain center crop (video_transforms.py:327-354)."""

    def __init__(self, size):
        self.size = _size2(size)

    def __call__(self, clip):
        return center_crop(clip, self.size)


class NormalizeVideo:
    """video_transforms.py:357-379."""

    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, clip):
        return normalize_video(clip, self.mean, self.std)


class ToTensorVideo:
    """video_transforms.py:382-401."""

    def __call__(self, clip):
        return to_tensor(clip)


class RandomHorizontalFlipVideo:
    """video_transforms.py:404-429."""

    def __init__(self, p: float = 0.5,
                 rng: Optional[np.random.Generator] = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, clip):
        if self.rng.random() < self.p:
            return hflip(clip)
        return clip


class TemporalRandomCrop:
    """Random temporal window: total_frames -> (begin, end)
    (video_transforms.py:432-446)."""

    def __init__(self, size: int,
                 rng: Optional[np.random.Generator] = None):
        self.size = size
        self.rng = rng or np.random.default_rng()

    def __call__(self, total_frames: int) -> Tuple[int, int]:
        rand_end = max(0, total_frames - self.size - 1)
        begin = int(self.rng.integers(0, rand_end + 1))
        return begin, min(begin + self.size, total_frames)


# ---------------- factories (reference datasets.py:14-35) ----------------

def center_crop_arr(img: np.ndarray, image_size: int) -> np.ndarray:
    """Iterative-downscale center crop for images ([H, W, C] uint8;
    reference datasets/utils.py center_crop_arr, ADM preprocessing)."""
    from PIL import Image
    pil = Image.fromarray(img)
    while min(*pil.size) >= 2 * image_size:
        pil = pil.resize(tuple(x // 2 for x in pil.size),
                         resample=Image.BOX)
    scale = image_size / min(*pil.size)
    pil = pil.resize(tuple(round(x * scale) for x in pil.size),
                     resample=Image.BICUBIC)
    arr = np.asarray(pil)
    y = (arr.shape[0] - image_size) // 2
    x = (arr.shape[1] - image_size) // 2
    return arr[y:y + image_size, x:x + image_size]


def get_transforms_video(resolution: int = 256,
                         rng: Optional[np.random.Generator] = None
                         ) -> Compose:
    """ToTensor -> RandomHFlip -> UCFCenterCrop -> Normalize(.5, .5)
    (reference datasets.py:14-23). In: [T, H, W, C] uint8;
    out: [T, C, res, res] float32 in [-1, 1]."""
    return Compose([
        ToTensorVideo(),
        RandomHorizontalFlipVideo(rng=rng),
        UCFCenterCropVideo(resolution),
        NormalizeVideo(mean=[0.5, 0.5, 0.5], std=[0.5, 0.5, 0.5]),
    ])


def get_transforms_image(image_size: int = 256,
                         rng: Optional[np.random.Generator] = None
                         ) -> Compose:
    """center_crop_arr -> RandomHFlip -> ToTensor -> Normalize
    (reference datasets.py:26-35). In: [H, W, C] uint8;
    out: [1, C, size, size] float32 in [-1, 1] (T=1 clip layout)."""
    def _img_pipeline(img):
        arr = center_crop_arr(img, image_size)[None]  # [1, H, W, C]
        clip = to_tensor(arr)
        r = rng or np.random.default_rng()
        if r.random() < 0.5:
            clip = hflip(clip)
        return normalize_video(clip, [0.5] * 3, [0.5] * 3)
    return Compose([_img_pipeline])
