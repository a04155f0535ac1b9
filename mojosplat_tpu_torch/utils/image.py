"""Image output: float images to 8-bit, PNG encoding and writing.

Port of ``mojosplat_tpu.utils.image`` (numpy and the standard library).
``save_png`` writes through the native C encoder (``native/io_native.c``,
stored deflate) when it builds, else through ``encode_png`` (zlib). Images
are read with PIL, as the reference reads them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(image) -> np.ndarray:
    """(H, W, C) float image in [0, 1] -> uint8, clipped (truncating, as
    the reference does)."""
    arr = np.asarray(image)
    return (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    out = struct.pack(">I", len(data)) + tag + data
    return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W, C) image, C in (1, 3, 4) -> PNG bytes (zlib level 6,
    filter type 0 on every row)."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + np.ascontiguousarray(arr[i]).tobytes() for i in range(h))
    return (
        _PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def save_png(image, path: str) -> None:
    """Save a float (H, W, C) image in [0, 1] as an 8-bit PNG."""
    from ..native import get_native

    arr = to_uint8(image)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    native = get_native()
    if native is not None:
        h, w, c = arr.shape
        native.write_png(path, h, w, c, np.ascontiguousarray(arr).tobytes())
        return
    with open(path, "wb") as f:
        f.write(encode_png(arr))
