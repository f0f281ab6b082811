"""Build and load the hand-written CUDA kernels (`viditq_tpu_torch/csrc`).

Each `.cu` source is compiled by its own `nvcc` process, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes. The build runs on first use (never at
import, so the package imports on machines without `nvcc`), lands in
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
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-lineinfo"]

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
    "vq_attn_vquant_t": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vq_attn_row_quant": [_P, _P, _P, _I, _I, _P],
    "vq_attention_stream": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _I, _P],
    "vq_dyn_quant_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vq_int8_matmul": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                       _I, _P],
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
    path. One `nvcc -c` per source runs in parallel, then one link; the
    library is written under a temporary name first so a cut build never
    leaves a library that looks finished."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj),
                   str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        errors = []
        for cmd, _, proc in jobs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = work / out.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
