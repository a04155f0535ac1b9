"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` file is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects are linked into ONE
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libmojosplat_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argument types of the C entry point (pointers, ints, floats, and
# the stream last); every entry point returns an int error code. A null
# pointer is passed as None. The ``*_info`` entry points launch nothing and
# take no stream: they report a kernel's launch shape (B2, B3, B6/B7, B8) into a
# host int array (``launch_shape``).
_SIGNATURES = {
    "expand_offsets_launch": (_P, _I, _I, _P, _I, _P),
    "slice_gather_launch": (_P, _I, _P, _I, _I, _P, _P),
    "raster_fwd_launch": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P),
    "raster_bwd_launch": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P),
    "raster_bwd_info": (_I, _I, _P),
    "raster_probe_launch": (_I, _I, _P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P),
    "segsum_launch": (_P, _I, _I, _P, _P, _I, _P, _P),
    "segsum_info": (_P,),
    "surfel_fwd_launch": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P),
    "surfel_fwd_info": (_I, _I, _I, _P),
    "surfel_fwd_check_launch": (_I, _P, _I, _I, _I, _P, _I, _I, _F, _F, _F, _P, _P, _P, _P, _P),
    "surfel_bwd_launch": (_P, _I, _I, _I, _P, _I, _I, _F, _F, _P, _P, _P, _P, _P),
    "surfel_bwd_info": (_I, _I, _P),
}
SHAPE_KEYS = ("registers", "shared_bytes", "local_bytes", "threads", "cluster",
              "blocks_per_sm", "clusters")
# This process's nvcc builds of the library and its loads
# (``utils.metrics.compilation_count``).
compiles = 0
loads = 0


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
    shared-memory report). One ``nvcc -c`` per source runs in parallel,
    then one ``nvcc -shared`` links. The library is written to a temporary
    name and renamed, so a concurrent process never loads a half-written
    file.
    """
    global compiles
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        jobs = []
        for src in sources():
            obj = Path(tmp_dir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            report.append(text)
            if proc.returncode != 0:
                for *_, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        tmp = Path(tmp_dir) / LIB_NAME
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        text = "".join(report)
        log.write_text(text)
        os.replace(tmp, lib)
    compiles += 1
    return lib, text


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global loads
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    loads += 1
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _entry(name: str):
    """The C entry point ``name`` of the loaded library."""
    return getattr(library(), name)


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    ``device``; raise if the launch status is not 0. ``device`` is made the
    current device for the call only where another one is current."""
    fn = _entry(name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    # The stream's handle without building a torch.cuda.Stream object.
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        code = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            code = fn(*args, stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def launch_shape(name: str, *args: int) -> dict:
    """A kernel's launch shape from the CUDA runtime, by the info entry
    point ``name`` (builds the kernels): registers and local (spill) bytes a
    thread, static shared bytes and threads a block, the cluster width (1
    without clusters), resident blocks per SM and resident clusters on the
    card (blocks, without clusters)."""
    out = (ctypes.c_int * len(SHAPE_KEYS))()
    code = _entry(name)(*args, ctypes.cast(out, ctypes.c_void_p))
    if code != 0:
        raise RuntimeError(f"{name} failed with error {code}")
    return dict(zip(SHAPE_KEYS, list(out)))


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
