"""Make the CelebA-shaped JPEG fixtures of this folder and their expected
decodes (PIL is needed here, not where they are read).

    python tests/fixtures/celeba_jpeg/make_fixtures.py

Writes ``000001.jpg`` .. ``000008.jpg`` (178x218, CelebA's aligned size:
smooth colour fields from a numpy seed, quality 95), ``cmyk.jpg`` (a CMYK
JPEG, which the native decoder fails and PIL converts), ``truncated.jpg``
(the first 60% of ``000001.jpg``) and ``expected_u8.npz``: PIL's uint8
decode [8, 64, 64, 3] of the eight good files in each mode of the image
folders (``center_crop``, ``d2c``, ``plain``), with the file names under
``files``. Each decode is stored as its differences along the rows, mod 256
(``row_deltas``), which compress to a third; ``np.cumsum(d, axis=2,
dtype=np.uint8)`` restores it (``load_expected``). ``expected_arrays``
recomputes the decodes from the JPEGs on disk.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 178, 218
N_GOOD = 8
SIZE = 64
SEED = 0
# the image folders' three transforms: (center_crop, d2c)
MODES = {"center_crop": (True, False), "d2c": (False, True),
         "plain": (False, False)}


def good_files():
    return [os.path.join(HERE, f"{i:06d}.jpg") for i in range(1, N_GOOD + 1)]


def smooth_image(rng: np.random.RandomState) -> np.ndarray:
    """[HEIGHT, WIDTH, 3] uint8: a few Gaussian blobs of colour on a
    gradient, no edges sharper than ~10 px."""
    yy, xx = np.mgrid[0:HEIGHT, 0:WIDTH].astype(np.float64)
    img = (rng.uniform(40, 200, 3)[None, None]
           + rng.uniform(-0.3, 0.3, 3)[None, None] * yy[..., None]
           + rng.uniform(-0.3, 0.3, 3)[None, None] * xx[..., None])
    for _ in range(5):
        cy, cx = rng.uniform(0, HEIGHT), rng.uniform(0, WIDTH)
        r = rng.uniform(15, 45)
        g = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
        img += g[..., None] * rng.uniform(-70, 70, 3)[None, None]
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def pil_decode(path: str, size: int, center_crop: bool,
               d2c: bool) -> np.ndarray:
    """PIL's decode and transform of one file, as the image folders' PIL
    path computes it."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if d2c:
        cx, cy = 89, 121
        img = img.crop((cx - 64, cy - 64, cx + 64, cy + 64))
        img = img.resize((size, size), Image.BILINEAR)
    elif center_crop:
        w, h = img.size
        scale = size / min(w, h)
        nw, nh = round(w * scale), round(h * scale)
        img = img.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - size) // 2, (nh - size) // 2
        img = img.crop((left, top, left + size, top + size))
    else:
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


def expected_arrays() -> dict:
    files = good_files()
    out = {mode: np.stack([pil_decode(f, SIZE, *flags) for f in files])
           for mode, flags in MODES.items()}
    out["files"] = np.array([os.path.basename(f) for f in files])
    return out


def row_deltas(x: np.ndarray) -> np.ndarray:
    """[N, H, W, C] uint8 -> its differences along W, mod 256."""
    d = x.copy()
    d[:, :, 1:] -= x[:, :, :-1]
    return d


def load_expected(path: str = os.path.join(HERE, "expected_u8.npz")) -> dict:
    """The npz's decodes, restored, and the file names."""
    with np.load(path) as z:
        out = {mode: np.cumsum(z[mode], axis=2, dtype=np.uint8)
               for mode in MODES}
        out["files"] = z["files"]
    return out


def main() -> None:
    from PIL import Image

    rng = np.random.RandomState(SEED)
    for path in good_files():
        Image.fromarray(smooth_image(rng)).save(path, quality=95)
    Image.fromarray(smooth_image(rng)).convert("CMYK").save(
        os.path.join(HERE, "cmyk.jpg"), quality=95)
    with open(good_files()[0], "rb") as f:
        data = f.read()
    with open(os.path.join(HERE, "truncated.jpg"), "wb") as f:
        f.write(data[:int(len(data) * 0.6)])
    want = expected_arrays()
    np.savez_compressed(os.path.join(HERE, "expected_u8.npz"),
                        files=want.pop("files"),
                        **{mode: row_deltas(x) for mode, x in want.items()})


if __name__ == "__main__":
    main()
