"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``.cu`` files are compiled by ``nvcc`` for Hopper (``sm_90a``) into ONE
shared library with a plain C interface, loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a cold build takes seconds. The library lands
in ``build/kernels/<hash>/`` beside the package (``build/`` is git-ignored),
keyed by a hash of the sources and the compiler flags, so an edited kernel
is rebuilt and an unchanged one is reused.

The build happens at the first kernel launch, never at import: the package
and its CPU tests import without ``nvcc`` or a card. A failed build raises;
there is no fallback.

Every C entry point takes raw device pointers and the CUDA stream as
integers, launches on that stream, and returns ``cudaGetLastError()``;
``launch`` turns a nonzero code into an exception.
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

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmojosplat_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
# name -> argument types of the C entry point (pointers, ints, floats, and
# the stream last); every entry point returns an int error code. A null
# pointer is passed as None.
_SIGNATURES = {
    "expand_offsets_launch": (_P, _I, _I, _P, _I, _P),
    "slice_gather_launch": (_P, _I, _P, _I, _I, _P, _P),
    "raster_fwd_launch": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P),
    "raster_bwd_launch": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P),
    "segsum_launch": (_P, _I, _L, _P, _I, _P, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> tuple[Path, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, the compiler's output: ptxas register and
    shared-memory report). The library is written to a temporary name and
    renamed, so a concurrent process never loads a half-written file.
    """
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    ``device`` (made the current device for the call); raise if the launch
    status is not 0."""
    with torch.cuda.device(device):
        code = getattr(library(), name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
