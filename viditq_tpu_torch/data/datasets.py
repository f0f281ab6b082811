"""Datasets and loading (a copy of `viditq_tpu/data/datasets.py`; the
reference's `t2v/opensora/datasets/`), numpy and PIL: the port does not
import the JAX package. Items stay numpy arrays, as in JAX; the train
loop moves a batch to its device (`pipelines/train.py`). Covers:
  * DatasetFromCSV (datasets.py:38) — csv rows of (path, caption[, class]):
    .npz clips (key 'video'), frame directories, and video files through
    `video_io.decode_video` (.y4m is read with numpy alone);
  * transforms (video_transforms.py) — resize-crop / center-crop / UCF crop
    (`data/transforms.py`);
  * QuantCalibDataset (datasets.py:118) — calib trajectory slices;
  * StatefulSampler (utils.py:38 StatefulDistributedSampler) — resumable,
    dp-shardable index stream; the same (n, seed, epoch, rank, world)
    gives the JAX sampler's order exactly;
  * batch_iterator / prepare_dataloader (utils.py:64) — serial, or thread
    workers with prefetch.

`center_crop_resize` skips Pillow when the resize keeps the frame's size
(Pillow's resize to the same size returns a copy, so skipping it is
exact): frames already at the target size load without Pillow.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def center_crop_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize preserving aspect then center-crop (reference
    video_transforms.py resize_crop semantics). img: [H, W, C] uint8.
    A resize to the frame's own size is skipped (no Pillow): Pillow's
    returns a copy."""
    h, w = img.shape[:2]
    th, tw = size
    scale = max(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) == (h, w):
        arr = img
    else:
        from PIL import Image
        arr = np.asarray(Image.fromarray(img).resize((nw, nh),
                                                     Image.BILINEAR))
    top, left = (nh - th) // 2, (nw - tw) // 2
    return arr[top:top + th, left:left + tw]


def normalize(x: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1, 1] (reference ToTensor + Normalize)."""
    return (np.asarray(x, np.float32) / 127.5) - 1.0


def load_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"))
    return normalize(center_crop_resize(img, size)).transpose(2, 0, 1)


def load_raw_frames(path: str) -> np.ndarray:
    """-> [T, H, W, C] uint8. Accepts a .npz (key 'video'), a directory
    of frame images (the formats `save_sample` writes), or a video FILE —
    decoded natively for .y4m / MJPEG .avi / PIL multiframe formats, or
    through an ffmpeg subprocess for general codecs when the binary
    exists (`data/video_io.py`; reference route is torchvision.io,
    datasets.py:38-116)."""
    if path.endswith(".npz"):
        return np.load(path)["video"]
    if os.path.isdir(path):
        from PIL import Image
        names = sorted(os.listdir(path))
        return np.stack([np.asarray(Image.open(os.path.join(path, n))
                                    .convert("RGB")) for n in names])
    from viditq_tpu_torch.data.video_io import decode_video
    return decode_video(path)


def load_video(path: str, num_frames: int, size: Tuple[int, int],
               frame_interval: int = 1) -> np.ndarray:
    """-> [C, T, H, W]."""
    frames = load_raw_frames(path)
    idx = np.arange(0, len(frames), frame_interval)[:num_frames]
    if len(idx) < num_frames:  # loop-pad short clips
        idx = np.resize(idx, num_frames)
    frames = np.stack([center_crop_resize(frames[i], size) for i in idx])
    return normalize(frames).transpose(3, 0, 1, 2)


class DatasetFromCSV:
    """CSV of `path,text[,label]` rows (reference datasets.py:38-115).

    transform=None keeps the built-in center-crop-resize + normalize
    path; passing a transform (e.g. transforms.get_transforms_video)
    reproduces the reference getitem: TemporalRandomCrop window ->
    linspace frame indices -> transform([T, H, W, C] raw) -> [T, C, H, W]
    -> CTHW (datasets.py:74-102)."""

    def __init__(self, csv_path: str, num_frames: Optional[int] = None,
                 image_size: Tuple[int, int] = (256, 256),
                 frame_interval: int = 1, root: str = "",
                 transform=None, temporal_sample=None):
        with open(csv_path) as f:
            self.rows = [r for r in csv.reader(f) if r]
        self.num_frames = num_frames
        self.image_size = image_size
        self.frame_interval = frame_interval
        self.root = root
        self.transform = transform
        if transform is not None and num_frames and temporal_sample is None:
            from viditq_tpu_torch.data.transforms import TemporalRandomCrop
            temporal_sample = TemporalRandomCrop(num_frames * frame_interval)
        self.temporal_sample = temporal_sample

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        row = self.rows[i]
        path = os.path.join(self.root, row[0])
        text = row[1] if len(row) > 1 else ""
        if self.transform is not None:
            if self.num_frames:
                raw = load_raw_frames(path)
                begin, end = (self.temporal_sample(len(raw))
                              if self.temporal_sample else (0, len(raw)))
                assert end - begin >= self.num_frames, \
                    f"{path} has not enough frames"
                idx = np.linspace(begin, end - 1, self.num_frames, dtype=int)
                clip = self.transform(raw[idx])          # [T, C, H, W]
            else:
                from PIL import Image
                img = np.asarray(Image.open(path).convert("RGB"))
                clip = self.transform(img)               # [1, C, H, W]
            return {"video": clip.transpose(1, 0, 2, 3), "text": text}
        if self.num_frames is None:
            x = load_image(path, self.image_size)
        else:
            x = load_video(path, self.num_frames, self.image_size,
                           self.frame_interval)
        return {"video": x, "text": text}


class QuantCalibDataset:
    """Calib trajectory slices as samples (reference datasets.py:118-139)."""

    def __init__(self, calib_npz: str):
        data = np.load(calib_npz)
        self.xs, self.ts, self.y = data["xs"], data["ts"], data["y"]

    def __len__(self):
        return self.xs.shape[0]

    def __getitem__(self, i):
        return {"xs": self.xs[i], "ts": self.ts[i], "y": self.y}


class StatefulSampler:
    """Resumable (optionally dp-sharded) index sampler — the reference's
    StatefulDistributedSampler (datasets/utils.py:38-63) without torch
    distributed: shard by (rank, world) explicitly."""

    def __init__(self, n: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world: int = 1):
        self.n = n
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world = world
        self.epoch = 0
        self.start_index = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_index(self, idx: int):
        self.start_index = idx

    def state_dict(self, consumed: int):
        return {"epoch": self.epoch, "start_index": consumed}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.start_index = state["start_index"]

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        if self.shuffle:
            order = np.random.default_rng(
                self.seed + self.epoch).permutation(self.n)
        order = order[self.rank::self.world]
        yield from order[self.start_index:]
        self.start_index = 0


def _collate(batch):
    return {k: np.stack([b[k] for b in batch])
            if not isinstance(batch[0][k], str)
            else [b[k] for b in batch] for k in batch[0]}


def batch_iterator(dataset, sampler: StatefulSampler, batch_size: int):
    """Minimal prepare_dataloader (datasets/utils.py:64) replacement."""
    batch = []
    for idx in sampler:
        batch.append(dataset[int(idx)])
        if len(batch) == batch_size:
            yield _collate(batch)
            batch = []


def prepare_dataloader(dataset, sampler: StatefulSampler, batch_size: int,
                       num_workers: int = 0, prefetch: int = 2):
    """Worker-parallel, prefetching loader (reference prepare_dataloader,
    datasets/utils.py:64-85: torch DataLoader with num_workers + pinned
    memory). TPU idiom: item loads run in a thread pool and `prefetch`
    collated batches are staged ahead by a producer thread, overlapping
    host-side decode/transform with device compute. num_workers=0 falls
    back to the serial batch_iterator.

    Prefetching draws AHEAD of consumption, so `sampler`-based resume
    state can overcount by up to prefetch*batch_size items — use the
    serial batch_iterator where exact mid-epoch resume matters (the
    train_entry path does).
    """
    if num_workers <= 0:
        yield from batch_iterator(dataset, sampler, batch_size)
        return
    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with ThreadPoolExecutor(num_workers) as pool:
                batch_idx = []
                for idx in sampler:
                    if stop.is_set():
                        return
                    batch_idx.append(int(idx))
                    if len(batch_idx) == batch_size:
                        items = list(pool.map(dataset.__getitem__,
                                              batch_idx))
                        if not put(_collate(items)):
                            return
                        batch_idx = []
            put(_END)
        except BaseException as e:  # surface loader errors to the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            out = q.get()
            if out is _END:
                break
            if isinstance(out, BaseException):
                raise out
            yield out
    finally:
        # consumer abandoned or finished: unblock and retire the producer
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
