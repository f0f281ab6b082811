"""Video-file decoding (a copy of `viditq_tpu/data/video_io.py`; the
reference loads videos through torchvision.io,
`t2v/opensora/datasets/datasets.py:38-116`, `datasets/utils.py:15`).
Decodes what it can natively and shells out to ffmpeg only when the binary
exists.

Decode order for an arbitrary video path:
  1. container-native pure-python decoders:
       .y4m           — YUV4MPEG2 (uncompressed 420/422/444 planar), numpy
                        only: no Pillow
       .avi           — RIFF walk extracting MJPEG ('00dc'/'00db') frames,
                        each decoded by PIL's JPEG codec
       .gif/.webp/... — PIL multi-frame images
  2. `ffmpeg` subprocess (rawvideo rgb24 pipe) when the binary is on PATH
  3. raise with a clear message listing the supported routes

All decoders return [T, H, W, 3] uint8. Pillow is imported only by the
decoders that use it.
"""

from __future__ import annotations

import io
import os
import shutil
import struct
import subprocess
from typing import List, Optional

import numpy as np

__all__ = ["decode_video", "read_y4m", "read_mjpeg_avi", "read_pil_frames",
           "ffmpeg_available", "read_ffmpeg"]


# ---------------------------------------------------------------- Y4M ----

def _yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """BT.601 limited-range YCbCr -> RGB uint8; u/v already upsampled."""
    yf = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    uf = u.astype(np.float32) - 128.0
    vf = v.astype(np.float32) - 128.0
    r = yf + 1.402 * (255.0 / 224.0) * vf
    g = yf - 0.344136 * (255.0 / 224.0) * uf - 0.714136 * (255.0 / 224.0) * vf
    b = yf + 1.772 * (255.0 / 224.0) * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _upsample2(p: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbor chroma upsample to (h, w)."""
    rh = h // p.shape[0]
    rw = w // p.shape[1]
    return np.repeat(np.repeat(p, rh, axis=0), rw, axis=1)


def read_y4m(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """YUV4MPEG2 (the format `ffmpeg -f yuv4mpegpipe` and many raw tools
    write): stream header 'YUV4MPEG2 W.. H.. [C420|C422|C444]', then per
    frame a 'FRAME...\\n' marker followed by the planar YUV payload."""
    with open(path, "rb") as f:
        header = bytearray()
        while not header.endswith(b"\n"):
            b = f.read(1)
            if not b:
                raise ValueError(f"{path}: truncated y4m header")
            header += b
        parts = header.decode("ascii", "replace").split()
        if not parts or parts[0] != "YUV4MPEG2":
            raise ValueError(f"{path}: not a YUV4MPEG2 stream")
        w = h = None
        fmt = "420"
        for p in parts[1:]:
            if p.startswith("W"):
                w = int(p[1:])
            elif p.startswith("H"):
                h = int(p[1:])
            elif p.startswith("C"):
                fmt = p[1:].rstrip("jpaledmpeg2")  # C420jpeg/C420paldv...
                fmt = "".join(ch for ch in p[1:] if ch.isdigit()) or "420"
        if not (w and h):
            raise ValueError(f"{path}: y4m header missing W/H: {parts}")
        if fmt.startswith("444"):
            cw, ch_ = w, h
        elif fmt.startswith("422"):
            cw, ch_ = w // 2, h
        else:  # 420 variants
            cw, ch_ = w // 2, h // 2
        ysz, csz = w * h, cw * ch_
        frames: List[np.ndarray] = []
        while True:
            line = bytearray()
            b = f.read(1)
            if not b:
                break
            while b and b != b"\n":
                line += b
                b = f.read(1)
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad frame marker {bytes(line)!r}")
            payload = f.read(ysz + 2 * csz)
            if len(payload) < ysz + 2 * csz:
                break  # truncated tail frame
            y = np.frombuffer(payload, np.uint8, ysz).reshape(h, w)
            u = np.frombuffer(payload, np.uint8, csz, ysz).reshape(ch_, cw)
            v = np.frombuffer(payload, np.uint8, csz, ysz + csz
                              ).reshape(ch_, cw)
            frames.append(_yuv_to_rgb(y, _upsample2(u, h, w),
                                      _upsample2(v, h, w)))
            if max_frames and len(frames) >= max_frames:
                break
    if not frames:
        raise ValueError(f"{path}: no frames decoded")
    return np.stack(frames)


# --------------------------------------------------------- MJPEG AVI ----

def read_mjpeg_avi(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Walk the RIFF/AVI chunk tree and decode every video-stream chunk
    ('00dc'/'00db' — compressed/uncompressed frame of stream 0) as a JPEG
    via PIL. Covers MJPEG .avi, the one self-contained video container
    decodable without inter-frame codec state."""
    from PIL import Image

    frames: List[np.ndarray] = []
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"AVI ":
            raise ValueError(f"{path}: not a RIFF/AVI file")

        def walk(end: int):
            while f.tell() < end - 7:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                start = f.tell()
                if fourcc in (b"LIST", b"RIFF"):
                    f.read(4)  # list type
                    walk(start + size)
                elif fourcc[2:] in (b"dc", b"db") and size > 2:
                    data = f.read(size)
                    try:
                        img = Image.open(io.BytesIO(data)).convert("RGB")
                        frames.append(np.asarray(img))
                    except Exception:
                        pass  # non-JPEG payload (e.g. DIB) — skip
                    if max_frames and len(frames) >= max_frames:
                        return
                f.seek(start + size + (size & 1))  # chunks are word-aligned

        f.seek(0, os.SEEK_END)
        file_end = f.tell()
        f.seek(12)
        walk(file_end)
    if not frames:
        raise ValueError(f"{path}: no decodable MJPEG frames found "
                         "(inter-frame codecs need ffmpeg)")
    return np.stack(frames)


# ------------------------------------------------------ PIL multiframe ----

def read_pil_frames(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Multi-frame PIL formats (GIF, animated WebP, multipage TIFF)."""
    from PIL import Image, ImageSequence

    frames = []
    with Image.open(path) as im:
        for fr in ImageSequence.Iterator(im):
            frames.append(np.asarray(fr.convert("RGB")))
            if max_frames and len(frames) >= max_frames:
                break
    if not frames:
        raise ValueError(f"{path}: no frames")
    return np.stack(frames)


# ----------------------------------------------------------- ffmpeg ----

def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def read_ffmpeg(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Decode via an `ffmpeg` subprocess to a raw rgb24 pipe — the general
    route (h264/h265/vp9 mp4/webm/mkv) whenever the binary exists."""
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True)
    w, h = (int(x) for x in probe.stdout.strip().split(",")[:2])
    cmd = ["ffmpeg", "-v", "error", "-i", path]
    if max_frames:
        cmd += ["-frames:v", str(max_frames)]
    cmd += ["-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:1"]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    n = len(raw) // (w * h * 3)
    if n == 0:
        raise ValueError(f"{path}: ffmpeg produced no frames")
    return np.frombuffer(raw, np.uint8, n * w * h * 3).reshape(n, h, w, 3)


# ------------------------------------------------------------ dispatch ----

_PIL_MULTI = (".gif", ".webp", ".tif", ".tiff", ".apng", ".png")


def decode_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """[T, H, W, 3] uint8 from a video FILE; see module docstring for the
    decode order. Frame dirs/.npz stay on datasets.load_raw_frames."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".y4m":
        return read_y4m(path, max_frames)
    if ext == ".avi":
        try:
            return read_mjpeg_avi(path, max_frames)
        except ValueError:
            if ffmpeg_available():
                return read_ffmpeg(path, max_frames)
            raise
    if ext in _PIL_MULTI:
        return read_pil_frames(path, max_frames)
    if ffmpeg_available():
        return read_ffmpeg(path, max_frames)
    raise ValueError(
        f"unsupported video source {path!r}: native decoders cover "
        ".y4m / MJPEG .avi / PIL multiframe (gif, webp, tiff); other "
        "codecs (mp4/webm/mkv) need an ffmpeg binary on PATH")
