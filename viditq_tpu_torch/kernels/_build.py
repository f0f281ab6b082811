"""Build and load the hand-written CUDA kernels (`viditq_tpu_torch/csrc`).

All `.cu` sources are compiled by `nvcc` into one shared library with a
plain C interface, loaded with ctypes. The build runs on first use (never
at import, so the package imports on machines without `nvcc`), lands in
`build/kernels/` at the root of the checkout, and is cached by a hash of
the sources and the compiler flags. Each C entry point returns
`cudaGetLastError()`; `check` raises on a non-zero code.
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

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (every pointer and the stream
# are c_void_p, every size an int)
SIGNATURES = {
    "vq_ln_mod_quant": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "vq_quant_rows": [_P, _P, _P, _I, _I, _I, _P],
    "vq_int8_gemm": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vq_group_quant": [_P, _P, _P, _I, _I, _I, _P],
    "vq_attention": [_P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _F, _I, _P],
    "vq_attn_vquant": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vq_attn_row_quant": [_P, _P, _P, _I, _I, _P],
}


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libviditq_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an identical build exists; returns its
    path. Writes to a temporary name first so a cut build never leaves a
    library that looks finished."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
