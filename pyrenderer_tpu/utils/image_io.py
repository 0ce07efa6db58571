"""Image output: PNG (LDR) and EXR/NPY (HDR).

Reference wrote PNG via ti.imwrite / skimage (reference main_taichi.py:125,
main.py:59) and HDR state via np.save (main_taichi.py:120-123).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, ldr: np.ndarray) -> None:
    """ldr in [0, 1], (H, W, 3) -> 8-bit RGB PNG (NumPy + zlib, no image
    library needed)."""
    arr = (np.clip(np.asarray(ldr), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    h, w = arr.shape[:2]
    # every scanline gets filter byte 0 (None) ahead of its RGB bytes
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr[:, :, :3].reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def write_hdr(path: str, hdr: np.ndarray) -> str:
    """Write float radiance. `.exr` goes through the bundled pure-Python
    OpenEXR writer (utils/exr.py — scanline FLOAT, ZIP; this environment
    ships no EXR backend, and the old imageio attempt silently fell back
    to a stray `.npy` in CWD, the origin of the recurring cornell-box.npy
    artifact). Anything else is saved as `.npy`. Returns the path
    actually written."""
    hdr = np.asarray(hdr, np.float32)
    if path.endswith(".exr"):
        from pyrenderer_tpu.utils.exr import write_exr

        return write_exr(path, hdr)
    if not path.endswith(".npy"):
        path = path + ".npy"
    np.save(path, hdr)
    return path
