"""ctypes binding of the native preprocessing library (port of
`viditq_tpu/data/native.py`): resize -> center crop -> normalize + CHW
pack of a clip in one C call, from the same source, `native/viditq_data.cc`.

The library is compiled with `g++` (the flags of `native/Makefile`) into
`build/native/` at the root of the checkout on first use, never at import,
and cached by a hash of the source and the flags; `native/` itself is
never written. `preprocess_frames` raises if the library does not build
or load. `preprocess_frames_plain` is its plain version, the JAX
package's numpy/PIL fallback (`center_crop_resize` + `normalize`); the
two agree in structure, not bit for bit (PIL filters a downscale, the C
kernel samples bilinearly).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "viditq_data.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-fopenmp-simd", "-Wall",
             "-shared"]


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libviditq_data_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an identical build exists; returns its
    path (written under a temporary name first, so a cut build never
    leaves a library that looks finished)."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data library cannot "
                           "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    handle = ctypes.CDLL(str(build()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    handle.viditq_preprocess_frames.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_int, u8p]
    handle.viditq_preprocess_frames.restype = None
    return handle


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        lib()
    except (OSError, RuntimeError):
        return False
    return True


def preprocess_frames_plain(frames: np.ndarray, size: Tuple[int, int]
                            ) -> np.ndarray:
    """The numpy/PIL version: each frame center-crop-resized, then
    normalized and packed [C, T, th, tw]."""
    from viditq_tpu_torch.data.datasets import center_crop_resize, normalize
    out = np.stack([center_crop_resize(f, size) for f in frames])
    return normalize(out).transpose(3, 0, 1, 2).copy()


def preprocess_frames(frames: np.ndarray, size: Tuple[int, int]
                      ) -> np.ndarray:
    """frames: uint8 [T, H, W, C] -> float32 [C, T, th, tw] in [-1, 1],
    through the native library (scale so the short side covers the target,
    bilinear resize, center crop, normalize + pack)."""
    t, sh, sw, c = frames.shape
    th, tw = size
    frames = np.ascontiguousarray(frames)
    scale = max(th / sh, tw / sw)
    rh, rw = int(sh * scale + 0.5), int(sw * scale + 0.5)
    scratch = np.empty(2 * rh * rw * c, np.uint8)
    dst = np.empty((c, t, th, tw), np.float32)
    lib().viditq_preprocess_frames(frames, t, sh, sw, c, dst, th, tw,
                                   scratch)
    return dst
