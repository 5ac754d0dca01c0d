"""PNG grids and images (JAX counterpart: ``infodiffusion_tpu/imaging.py``).

``save_image`` follows torchvision's ``save_image`` as the JAX package does:
images are normalized first (``value_range`` or their own min/max), then
laid out ``nrow`` to a row with 2 px of padding, so the padding lands in
output space. The PNG itself is written with the standard library
(``zlib``, ``struct``, ``binascii.crc32``): 8-bit grayscale, RGB or RGBA,
filter 0 on every row. Arrays are NHWC numpy arrays (or CPU tensors).
"""

from __future__ import annotations

import binascii
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_ZLIB_LEVEL = 6  # zlib's default
_WRITERS = 4  # threads of write_png_batch


def _normalize01(img: np.ndarray, normalize: bool, value_range) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    if normalize:
        lo, hi = value_range if value_range else (img.min(), img.max())
        img = (img - lo) / max(hi - lo, 1e-12)
    return np.clip(img, 0.0, 1.0)


def _to_uint8(img01: np.ndarray) -> np.ndarray:
    return (img01 * 255.0 + 0.5).astype(np.uint8)


def make_grid(batch: np.ndarray, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """[N, H, W, C] -> [H', W', C]: ``nrow`` images a row, ``padding`` px
    around each (torchvision's layout)."""
    n, h, w, c = batch.shape
    if n == 0:
        raise ValueError("make_grid: empty batch")
    ncol = min(nrow, n)
    nrows = (n + ncol - 1) // ncol
    gh = nrows * (h + padding) + padding
    gw = ncol * (w + padding) + padding
    grid = np.full((gh, gw, c), pad_value, dtype=batch.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = batch[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(u8: np.ndarray) -> bytes:
    """The PNG file of ``u8``: [H, W] or [H, W, C] uint8, C in (1, 3, 4)."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {u8.dtype}")
    if u8.ndim == 2:
        u8 = u8[..., None]
    h, w, c = u8.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png: {c} channels (1, 3 or 4 are written)")
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 on each row
    rows[:, 1:] = np.ascontiguousarray(u8).reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, u8: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(u8))


def write_png_batch(paths: Sequence[str], u8: np.ndarray) -> None:
    """One PNG per image of ``u8`` [N, H, W, C] to ``paths[i]``, on a few
    threads (zlib releases the GIL)."""
    u8 = np.asarray(u8)
    if len(paths) != len(u8):
        raise ValueError(f"{len(paths)} paths for {len(u8)} images")
    with ThreadPoolExecutor(max_workers=max(1, min(_WRITERS, len(paths)))) as ex:
        list(ex.map(write_png, paths, u8))


def save_image(img, path: str, *, nrow: int = 8, normalize: bool = False,
               value_range: Optional[Tuple[float, float]] = None) -> None:
    """Save [N, H, W, C] as a grid PNG, or [H, W, C] / [H, W] as one PNG."""
    img = np.asarray(img)
    if img.ndim == 4:
        # normalize the images first, then assemble: the padding is black
        # in output space and never enters the min/max
        u8 = _to_uint8(make_grid(_normalize01(img, normalize, value_range),
                                 nrow=nrow))
    else:
        u8 = _to_uint8(_normalize01(img, normalize, value_range))
    if u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    write_png(path, u8)
