"""PNG grids and images (JAX counterpart: ``infodiffusion_tpu/imaging.py``).

``save_image`` follows torchvision's ``save_image`` as the JAX package does:
images are normalized first (``value_range`` or their own min/max), then
laid out ``nrow`` to a row with 2 px of padding, so the padding lands in
output space. The PNG itself is written with the standard library
(``zlib``, ``struct``, ``binascii.crc32``): 8-bit grayscale, RGB or RGBA,
filter 0 on every row. Arrays are NHWC numpy arrays (or CPU tensors).

``decode_png`` and ``read_image_rgb`` read images back with the standard
library too (the card's machine has no PIL): every 8-bit, non-interlaced
PNG, which covers what this module and PIL write.
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


_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples


def _unfilter_sequential(kind: int, row: np.ndarray, prev: np.ndarray,
                         bpp: int) -> np.ndarray:
    """Filters 3 (Average) and 4 (Paeth), byte by byte along the row: each
    byte needs the one ``bpp`` to its left already reconstructed."""
    out = row.tolist()
    up = prev.tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines -> [H, stride] bytes. Filters 0-2
    are numpy per row; a file whose rows are all filter 0 (this module's
    writer) is one reshape."""
    kinds, data = rows[:, 0], rows[:, 1:]
    if not kinds.any():
        return data.copy()
    if int(kinds.max()) > 4:
        raise ValueError(f"PNG row filter {int(kinds.max())} (0-4 exist)")
    out = np.empty_like(data)
    prev = np.zeros(data.shape[1], np.uint8)
    for r, kind in enumerate(kinds.tolist()):
        row = data[r]
        if kind == 0:
            out[r] = row
        elif kind == 1:  # Sub: a wrapping cumulative sum per channel
            out[r] = (row.reshape(-1, bpp).astype(np.int64).cumsum(axis=0)
                      & 0xFF).reshape(-1)
        elif kind == 2:  # Up
            out[r] = row + prev
        else:
            out[r] = _unfilter_sequential(kind, row, prev, bpp)
        prev = out[r]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG file, [H, W, C] uint8: C = 1 (grey), 2 (grey and
    alpha), 3 (RGB, and a palette image looked up in its PLTE) or 4 (RGBA),
    as PIL decodes them. Takes bit depth 8 without interlace, with any of
    the five row filters; anything else raises."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(
            f"unsupported PNG (width {w}, height {h}, bit depth {depth}, "
            f"colour type {ctype}, interlace {interlace}): only bit depth "
            f"8, colour types 0/2/3/4/6, no interlace are read")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"PNG pixel data of {raw.size} bytes, want "
                         f"{h * (1 + w * c)} for {h}x{w}x{c}")
    pixels = _unfilter(raw.reshape(h, 1 + w * c), c).reshape(h, w, c)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        table = np.zeros((256, 3), np.uint8)  # indices past PLTE are black
        table[:len(palette)] = palette[:256]
        return table[pixels[..., 0]]
    return pixels


def _format_of(head: bytes) -> str:
    if head[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if head[:2] == b"BM":
        return "BMP"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WEBP"
    return "unknown"


def read_image_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``, [H, W, 3] uint8:
    grey replicated, alpha dropped, a palette looked up. A PNG is decoded
    here; any other format goes through PIL, imported when needed."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _SIGNATURE:
        px = decode_png(data)
        if px.shape[-1] in (1, 2):  # grey (and alpha)
            return np.repeat(px[..., :1], 3, axis=-1)
        return np.ascontiguousarray(px[..., :3])
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"{path}: a {_format_of(data[:12])} file needs PIL, which is not "
            f"installed (PNG files are read without it)") from exc
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


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
