"""Datasets (JAX counterpart: ``infodiffusion_tpu/data/datasets.py``).

The seven datasets read from the same on-disk layouts as the JAX package
(no download): mnist / fmnist idx files, the cifar10 pickles, the dsprites
npz and the celeba / chairs / ffhq image folders, and the same
deterministic synthetic sets (``data_dir='synthetic'`` or
``INFODIFF_SYNTHETIC_DATA=1``; ``INFODIFF_SYNTHETIC_N`` images), so a
synthetic set is byte for byte the JAX package's. The transform table
(resize, flip, normalize, shuffle) is the JAX package's; see
``dataset_flags``. The image folders decode with the native batcher
(``data/native.py``: JPEG through libjpeg, or nvJPEG where libjpeg is
absent, PNG through zlib, on a thread pool with the transforms fused in;
with libjpeg, bit for bit the JAX package's); a slot it fails (a CMYK
JPEG, a truncated or unreadable file) is retried through PIL, imported
then, which converts the former and raises on the latter. Where PIL is absent (the
card's machine) a failed slot raises an IOError naming the file. Without
the native library every image goes through PIL, as in the JAX package,
except where a card is visible: there a library that did not build raises
(``INFODIFF_DISABLE_NATIVE=1`` asks for PIL). Every image PIL decodes is
counted in ``tracing.counts["pil"]``.
``drop_last`` everywhere (``loader.py``).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from infodiffusion_tpu_torch import tracing
from infodiffusion_tpu_torch.data import native

# images are held as uint8 (or dsprites' 0/1) and normalized per-batch in
# the loader — CelebA at f32 would be ~10 GB host RAM.


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset: images [N, H, W, C] uint8 (or float for
    latents), optional attrs [N, ...]."""

    images: np.ndarray
    attrs: Optional[np.ndarray] = None
    normalize: str = "pm1"  # 'pm1' | 'raw'

    def __len__(self):
        return len(self.images)

    def get_batch(self, idx: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        x = self.images[idx]
        if self.normalize == "pm1":
            x = x.astype(np.float32) / 255.0 * 2.0 - 1.0
        else:
            x = x.astype(np.float32)
        a = self.attrs[idx] if self.attrs is not None else None
        return x, a

    def u8_transfer_ok(self) -> bool:
        """True when pixels follow the plain u8/pm1 contract, so the
        loader may ship uint8 and normalize on device (4x fewer H2D
        bytes); False for float latents and dsprites' raw 0/1."""
        return self.normalize == "pm1" and self.images.dtype == np.uint8

    def get_batch_u8(self, idx: np.ndarray):
        """Raw uint8 rows (the same pixels get_batch normalizes)."""
        a = self.attrs[idx] if self.attrs is not None else None
        return self.images[idx], a


@dataclasses.dataclass
class ImageFolderDataset:
    """Lazy JPEG/PNG folder dataset: decodes and transforms per batch
    (CelebA is ~200k JPEGs; decoding lazily keeps host RAM flat), with the
    native batcher and PIL for the slots it fails (see the module
    docstring)."""

    files: List[str]
    size: int
    center_crop: bool = False
    d2c: bool = False
    attrs: Optional[np.ndarray] = None
    normalize: str = "pm1"

    def __post_init__(self):
        self._native = None
        self._native_tried = False

    def __len__(self):
        return len(self.files)

    def _native_batcher(self):
        if not self._native_tried:
            self._native_tried = True
            if native.native_available():
                self._native = native.NativeImageBatcher(
                    self.files, self.size, self.center_crop, self.d2c)
            elif torch.cuda.is_available() \
                    and not os.environ.get("INFODIFF_DISABLE_NATIVE"):
                # no quiet single-threaded PIL decode beside a card
                raise RuntimeError(
                    f"the native image library is unavailable:\n"
                    f"{native.build_error()}\n(INFODIFF_DISABLE_NATIVE=1 "
                    f"decodes every image through PIL instead)")
        return self._native

    def _load_one(self, path: str) -> np.ndarray:
        try:
            from PIL import Image
        except ImportError as exc:
            raise IOError(
                f"{path}: the native decoder could not decode this file and "
                f"PIL, which would retry it, is not installed") from exc

        img = Image.open(path).convert("RGB")
        if self.d2c:
            # D2C crop for CelebA: a 128px window centred at (89, 121),
            # then resize
            cx, cy = 89, 121
            img = img.crop((cx - 64, cy - 64, cx + 64, cy + 64))
            img = img.resize((self.size, self.size), Image.BILINEAR)
        elif self.center_crop:
            # torchvision Resize(size) (smaller edge -> size), then
            # CenterCrop(size)
            w, h = img.size
            scale = self.size / min(w, h)
            nw, nh = round(w * scale), round(h * scale)
            img = img.resize((nw, nh), Image.BILINEAR)
            left = (nw - self.size) // 2
            top = (nh - self.size) // 2
            img = img.crop((left, top, left + self.size, top + self.size))
        else:
            img = img.resize((self.size, self.size), Image.BILINEAR)
        tracing.count("pil")
        return np.asarray(img, dtype=np.uint8)

    def _decode_u8(self, idx: np.ndarray) -> np.ndarray:
        idx = np.asarray(idx)
        nat = self._native_batcher()
        if nat is None:
            return np.stack([self._load_one(self.files[i]) for i in idx])
        x, failed = nat.decode_with_failures(idx)
        for pos in failed:
            x[pos] = self._load_one(self.files[int(idx[pos])])
        return x

    def get_batch(self, idx: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        x = self._decode_u8(idx).astype(np.float32) / 255.0 * 2.0 - 1.0
        a = self.attrs[idx] if self.attrs is not None else None
        return x, a

    def u8_transfer_ok(self) -> bool:
        return self.normalize == "pm1"

    def get_batch_u8(self, idx: np.ndarray):
        """Raw decoded uint8 (the same pixels get_batch normalizes)."""
        a = self.attrs[idx] if self.attrs is not None else None
        return self._decode_u8(idx), a


class LatentDataset(ArrayDataset):
    """Saved-latents dataset for train_latent_ddim
    (reference: utils.py:163-171): loads ``all_a`` from the npz written by
    save_latent mode."""

    def __init__(self, npz_path: str):
        data = np.load(npz_path, allow_pickle=True)
        super().__init__(
            images=data["all_a"].astype(np.float32), attrs=None, normalize="raw"
        )


# ---------------------------------------------------------------------------
# file-format readers
# ---------------------------------------------------------------------------


def _read_idx(path: str) -> np.ndarray:
    """MNIST idx format (supports .gz)."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find_first(paths: Sequence[str]) -> Optional[str]:
    for p in paths:
        if os.path.exists(p):
            return p
    return None


def _load_mnist_like(data_dir: str, name: str, size: int) -> ArrayDataset:
    """MNIST / FashionMNIST from the standard idx layout torchvision
    leaves under {data_dir}/{MNIST|FashionMNIST}/raw/."""
    sub = {"mnist": "MNIST", "fmnist": "FashionMNIST"}[name]
    raw = os.path.join(data_dir, sub, "raw")
    img_path = _find_first(
        [
            os.path.join(raw, "train-images-idx3-ubyte"),
            os.path.join(raw, "train-images-idx3-ubyte.gz"),
        ]
    )
    lbl_path = _find_first(
        [
            os.path.join(raw, "train-labels-idx1-ubyte"),
            os.path.join(raw, "train-labels-idx1-ubyte.gz"),
        ]
    )
    if img_path is None or lbl_path is None:
        raise FileNotFoundError(
            f"{name}: expected idx files under {raw} (no network egress — "
            f"place the standard torchvision raw/ layout there, or use "
            f"data_dir='synthetic')"
        )
    imgs = _read_idx(img_path)  # [N, 28, 28]
    labels = _read_idx(lbl_path).astype(np.int32)
    if size != imgs.shape[1]:
        from PIL import Image

        imgs = np.stack(
            [
                np.asarray(
                    Image.fromarray(im).resize((size, size), Image.BILINEAR),
                    dtype=np.uint8,
                )
                for im in imgs
            ]
        )
    return ArrayDataset(images=imgs[..., None], attrs=labels)


def _load_cifar10(data_dir: str) -> ArrayDataset:
    root = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"cifar10: expected {root} (pickled python batches)"
        )
    xs, ys = [], []
    for i in range(1, 6):
        with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(images=x, attrs=np.asarray(ys, np.int32))


def _load_dsprites(data_dir: str, size: int) -> ArrayDataset:
    path = os.path.join(
        data_dir,
        "dsprites-dataset",
        "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz",
    )
    if not os.path.exists(path):
        raise FileNotFoundError(f"dsprites: expected {path}")
    f = np.load(path, encoding="latin1", allow_pickle=True)
    imgs = f["imgs"]  # [N, 64, 64] uint8 in {0, 1}
    if size != imgs.shape[1]:
        # nearest-neighbor resize to input_size (PARITY.md D3) — for ANY
        # size, not just the ::2 halving case; silently returning 64px
        # images would contradict every input_size-derived setting
        # (latent pseudo-shape, attn token counts, --sp threshold)
        sel = (np.arange(size) * imgs.shape[1] // size).astype(np.int64)
        # one advanced index (not imgs[:, sel][:, :, sel]): the chained
        # form materializes a [N, size, 64] intermediate — an extra
        # ~1.5 GB transient on the real 737k-image dsprites
        imgs = imgs[:, sel[:, None], sel[None, :]]
    # raw 0/1 floats like the reference (data.py:42: .float(), no scaling);
    # latents_values + latents_classes ride along as attrs
    attrs = np.concatenate(
        [f["latents_values"], f["latents_classes"].astype(np.float64)], axis=1
    )
    return ArrayDataset(
        images=imgs[..., None].astype(np.uint8), attrs=attrs, normalize="raw"
    )


def _list_images(root: str) -> List[str]:
    exts = (".jpg", ".jpeg", ".png", ".bmp", ".webp")
    out = []
    for dirpath, _dirnames, filenames in sorted(os.walk(root)):
        for fn in sorted(filenames):
            if fn.lower().endswith(exts):
                out.append(os.path.join(dirpath, fn))
    return out


def _load_celeba(cfg) -> ImageFolderDataset:
    """CelebA from the standard torchvision layout:
    {data_dir}/celeba/img_align_celeba/*.jpg, list_attr_celeba.txt,
    list_eval_partition.txt (reference: data.py:149-186)."""
    root = os.path.join(cfg.data_dir, "celeba")
    img_root = os.path.join(root, "img_align_celeba")
    files = _list_images(img_root)
    if not files:
        raise FileNotFoundError(f"celeba: expected JPEGs under {img_root}")
    # attrs: header line (count), header line (names), rows "file v1..v40"
    attr_path = os.path.join(root, "list_attr_celeba.txt")
    attrs = None
    if os.path.exists(attr_path):
        with open(attr_path) as f:
            lines = f.read().strip().split("\n")
        table = {}
        for ln in lines[2:]:
            parts = ln.split()
            table[parts[0]] = [(1 if int(v) > 0 else 0) for v in parts[1:]]
        attrs = np.asarray(
            [table[os.path.basename(p)] for p in files], np.int32
        )
    # splits (0 train / 1 valid / 2 test)
    part_path = os.path.join(root, "list_eval_partition.txt")
    split = np.zeros(len(files), np.int32)
    if os.path.exists(part_path):
        with open(part_path) as f:
            table = dict(
                ln.split() for ln in f.read().strip().split("\n") if ln
            )
        split = np.asarray(
            [int(table.get(os.path.basename(p), 0)) for p in files], np.int32
        )
    keep = split == 0  # train split (reference always trains on 'train')
    files = [p for p, k in zip(files, keep) if k]
    if attrs is not None:
        attrs = attrs[keep]
    return ImageFolderDataset(
        files=files, size=cfg.input_size, center_crop=True, attrs=attrs
    )


def _render_dsprites(n: int, size: int, rng) -> ArrayDataset:
    """Factor-DEPENDENT synthetic dsprites: binary images of a square /
    ellipse / diamond whose scale and position are the ground-truth
    factors, with the real dataset's 12-wide attr contract
    (6 latents_values + 6 latents_classes; orientation is drawn but not
    rendered — a nuisance factor). Unlike pure-noise fakes this makes
    representation-learning validation meaningful: an encoder trained on
    these CAN capture the factors (tools/repr_learning_demo.py; contract
    test in tests/test_data.py)."""
    shape_c = rng.randint(0, 3, n)
    scale_c = rng.randint(0, 6, n)
    orient_c = rng.randint(0, 40, n)
    posx_c = rng.randint(0, 32, n)
    posy_c = rng.randint(0, 32, n)
    scale = 0.5 + scale_c / 5.0 * 0.5          # [0.5, 1], 6 steps
    orient = orient_c / 39.0 * 2 * np.pi
    posx = posx_c / 31.0
    posy = posy_c / 31.0
    g = (np.arange(size) + 0.5) / size
    yy, xx = np.meshgrid(g, g, indexing="ij")
    cx = (0.2 + 0.6 * posx)[:, None, None]
    cy = (0.2 + 0.6 * posy)[:, None, None]
    h = (0.14 * scale)[:, None, None]
    dx = np.abs(xx[None] - cx)
    dy = np.abs(yy[None] - cy)
    masks = np.stack(
        [
            np.maximum(dx, dy) <= h,                 # square
            dx * dx + dy * dy <= h * h,              # ellipse
            dx + dy <= h,                            # diamond
        ]
    )
    imgs = masks[shape_c, np.arange(n)].astype(np.uint8)[..., None]
    vals = np.stack(
        [np.ones(n), shape_c + 1.0, scale, orient, posx, posy], axis=1
    )
    classes = np.stack(
        [np.zeros(n), shape_c, scale_c, orient_c, posx_c, posy_c], axis=1
    ).astype(np.float64)
    return ArrayDataset(
        images=imgs,
        attrs=np.concatenate([vals, classes], axis=1),
        normalize="raw",  # same contract as the real loader (Q31)
    )


def _render_celeba(n: int, size: int, rng) -> ArrayDataset:
    """Factor-DEPENDENT synthetic celeba: RGB images of one shape whose
    type / vertical position / size / color / background brightness are
    controlled by the first five of the 40 binary attrs; the remaining
    35 are random nuisance bits. All five rendered factors are
    horizontal-flip-invariant (the celeba train pipeline random-flips),
    which makes the TAD / attr-probe validation meaningful the same way
    :func:`_render_dsprites` does for DCI."""
    attrs = rng.randint(0, 2, size=(n, 40)).astype(np.int32)
    shape_t = attrs[:, 0]                      # 0 ellipse / 1 rectangle
    posy = 0.32 + 0.36 * attrs[:, 1]           # top / bottom
    half = 0.10 + 0.08 * attrs[:, 2]           # small / large
    red = attrs[:, 3]                          # blue-ish / red-ish object
    bg = (0.15 + 0.55 * attrs[:, 4]).astype(np.float32)  # dark / light bg
    g = (np.arange(size) + 0.5) / size
    yy, xx = np.meshgrid(g, g, indexing="ij")
    dx = np.abs(xx[None] - 0.5)
    dy = np.abs(yy[None] - posy[:, None, None])
    h = half[:, None, None]
    rect = np.maximum(dx, dy) <= h
    ell = (dx / h) ** 2 + (dy / h) ** 2 <= 1.0
    mask = np.where(shape_t[:, None, None] == 1, rect, ell)
    img = np.broadcast_to(
        bg[:, None, None, None], (n, size, size, 3)
    ).copy()
    color = np.where(
        red[:, None].astype(bool),
        np.array([[0.85, 0.20, 0.20]], np.float32),
        np.array([[0.20, 0.30, 0.85]], np.float32),
    )  # [n, 3]
    img[mask] = color[np.nonzero(mask)[0]]
    imgs = (img * 255.0).astype(np.uint8)
    return ArrayDataset(images=imgs, attrs=attrs)


def _synthetic(cfg) -> ArrayDataset:
    """Deterministic fake data with the dataset's exact shape/attr
    contract — for tests, benches and dry runs (no reference analog).
    dsprites and celeba get factor-dependent rendered images (see
    :func:`_render_dsprites` / :func:`_render_celeba`); the others use
    noise images."""
    n = int(os.environ.get("INFODIFF_SYNTHETIC_N", "512"))
    rng = np.random.RandomState(0)
    if cfg.dataset == "dsprites":
        return _render_dsprites(n, cfg.input_size, rng)
    if cfg.dataset == "celeba":
        return _render_celeba(n, cfg.input_size, rng)
    imgs = rng.randint(
        0, 256, size=(n, cfg.input_size, cfg.input_size, cfg.input_channels)
    ).astype(np.uint8)
    attrs = rng.randint(0, 10, size=(n,)).astype(np.int32)
    return ArrayDataset(images=imgs, attrs=attrs)


# ---------------------------------------------------------------------------


_FLIP = {"fmnist", "celeba", "cifar10", "chairs", "ffhq"}
# shuffle contract incl. the celeba/ffhq shuffle=False quirk for latent
# order reproducibility (reference: data.py:130,144,184,197,214,230,243)
_SHUFFLE = {"cifar10", "dsprites", "chairs"}


def dataset_flags(name: str) -> Tuple[bool, bool]:
    """(flip, shuffle) per the reference transform table."""
    return name in _FLIP, name in _SHUFFLE


def get_dataset(cfg):
    """Build the dataset for cfg (after with_dataset_config()).

    The reference's celeba 3-way train/valid/test split branch
    (data.py:172-181, modes attr_classification/eval_fid/reconstruction)
    is DEAD code there: eval_fid only generates (run.py:265-309, no
    dataloader), 'reconstruction' is not an accepted mode, and
    attr_classification never reaches a dataloader. So every living
    reference path iterates the deterministic train split, which is what
    this returns; shuffling is the DataLoader's job (dataset_flags
    table). PARITY.md D17.
    """
    if cfg.data_dir == "synthetic" or os.environ.get("INFODIFF_SYNTHETIC_DATA"):
        return _synthetic(cfg)
    name = cfg.dataset
    if name in ("mnist", "fmnist"):
        return _load_mnist_like(cfg.data_dir, name, cfg.input_size)
    if name == "cifar10":
        return _load_cifar10(cfg.data_dir)
    if name == "dsprites":
        return _load_dsprites(cfg.data_dir, cfg.input_size)
    if name == "celeba":
        return _load_celeba(cfg)
    if name in ("chairs", "ffhq"):
        sub = {"chairs": "3DChairs", "ffhq": "ffhq"}[name]
        root = os.path.join(cfg.data_dir, sub)
        files = _list_images(root)
        if not files:
            raise FileNotFoundError(f"{name}: expected images under {root}")
        return ImageFolderDataset(files=files, size=cfg.input_size)
    raise ValueError(name)
