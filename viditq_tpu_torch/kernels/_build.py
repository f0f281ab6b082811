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
    "vq_ln_mod_quant": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I,
                        _P],
    "vq_quant_rows": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vq_int8_gemm": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                     _I, _P],
    "vq_int8_gemm_zp": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _P, _P, _I, _P],
    "vq_group_quant": [_P, _P, _P, _P, _I, _I, _I, _P],
    "vq_dynq_gemm": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _P, _P, _I, _P],
    "vq_qk_headwise_quant": [_P, _P, _P, _P, _I, _I, _I, _P],
    "vq_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                     _I, _P],
    "vq_attention_seg": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _F, _I, _I, _P],
    "vq_attention_seg_rows": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "vq_attn_vquant": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vq_attn_vquant_tiles": [_P, _P, _P, _I, _I, _I, _I, _P],
    "vq_attn_vquant_t": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vq_attn_row_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
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


def _compile(work: Path, extra=()) -> list:
    """One `nvcc -c` per source into work/, all started together; returns
    (object path, compiler output) pairs, or raises with every failure."""
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in sources() if s.suffix == ".cu"):
        obj = work / f"{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", "-I", str(CSRC), "-o",
               str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors, done = [], []
    for cmd, obj, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{output}")
        done.append((obj, output))
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def build() -> Path:
    """Compile the library unless an identical build exists; returns its
    path. One `nvcc -c` per source runs in parallel, then one link; the
    library is written under a temporary name first so a cut build never
    leaves a library that looks finished."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [obj for obj, _ in _compile(work)]
        tmp = work / out.name
        cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for obj in objs)]
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


def ptxas_report() -> str:
    """Registers, spills and shared memory of every kernel of every source,
    as ptxas reports them (`-Xptxas -v`; the library's own flags)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        lines = []
        for obj, output in _compile(work, ["-Xptxas", "-v"]):
            lines.append(f"== {obj.stem}.cu")
            lines += [ln.strip() for ln in output.splitlines()
                      if "Compiling entry" in ln or "Used" in ln
                      or "spill" in ln]
        return "\n".join(lines)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device, as a raw pointer: the query
    PyTorch's generated kernel launchers use. `torch.cuda.current_stream()`
    builds a Stream object on every call, a cost every kernel wrapper paid
    once a launch."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


if __name__ == "__main__":
    # python3 -m viditq_tpu_torch.kernels._build: the ptxas report (needs
    # nvcc; on the machine with the card)
    print(ptxas_report())
