"""Native (C) IO runtime: the PLY reader and writer, the PNG writer and the
COLMAP readers of ``io_native.c``, built on first use.

``get_native()`` compiles ``io_native.c`` with the system C compiler (a
few hundred ms) into ``build/native/<hash>/`` beside the package
(``build/`` is git-ignored), keyed by a hash of the source and the
interpreter's extension suffix, and loads it. The package directory is
never written. Where no toolchain is found or the build fails it returns
None, logging why at warning level, and callers use the pure-Python
readers and writers (``utils/ply.py``, ``utils/image.py``,
``utils/colmap.py``), which give the same arrays and files.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

logger = logging.getLogger("mojosplat_tpu_torch")

SOURCE = Path(__file__).resolve().parent / "io_native.c"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"
MODULE = "mojosplat_tpu_torch.native._io_native"

_lock = threading.Lock()
_native = None
_tried = False


def _library_path() -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(suffix.encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / ("_io_native" + suffix)


def _build(out: Path) -> bool:
    """Compile the extension to ``out`` (a temporary name, then a rename,
    so a concurrent process never loads a half-written file)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CC", "cc"), "-O2", "-shared", "-fPIC",
        "-I", sysconfig.get_paths()["include"], str(SOURCE), "-o", str(tmp),
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        logger.warning("native IO build unavailable (%s); using the Python IO", e)
        return False
    if proc.returncode != 0:
        logger.warning("native IO build failed; using the Python IO:\n%s",
                       proc.stderr[-2000:])
        return False
    os.replace(tmp, out)
    return True


def _load(path: Path):
    loader = importlib.machinery.ExtensionFileLoader(MODULE, str(path))
    spec = importlib.util.spec_from_file_location(MODULE, str(path), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def get_native():
    """The compiled ``_io_native`` module, or None if it cannot be built."""
    global _native, _tried
    with _lock:
        if _tried:
            return _native
        _tried = True
        path = _library_path()
        if path.exists() or _build(path):
            try:
                _native = _load(path)
            except ImportError as e:
                logger.warning("built the native IO but its import failed: %s", e)
        return _native
