"""The port's datasets, loader and PNG writer against the JAX package's.

- The synthetic set of each of the seven datasets equals JAX's byte for
  byte, and so do the on-disk readers on fixtures built as
  ``tests/test_dataset_formats.py`` builds them.
- The loader yields JAX's batches over 3 epochs for each (shuffle, flip)
  combination, with and without ``fast_forward(2)``: the same rows in the
  same order with the same flips, pm1 values within 2e-7 (JAX's device
  normalize may take a reciprocal multiply: one ulp of the pre-shift
  value); ``INFODIFF_HOST_NORMALIZE=1`` is exact.
- A PNG from the port, read back with PIL, has exactly the JAX writer's
  pixels (grayscale, RGB, grids, single images), and the scatter of
  plot_latent equals the JAX runner's ``_scatter_png``.
"""

import gzip
import inspect
import pickle
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from infodiffusion_tpu import imaging as jimg
from infodiffusion_tpu import runner as jrunner
from infodiffusion_tpu.config import Config as JConfig
from infodiffusion_tpu.data import datasets as jds
from infodiffusion_tpu.data.loader import DataLoader as JLoader
from infodiffusion_tpu_torch import imaging as pimg
from infodiffusion_tpu_torch import runner as prunner
from infodiffusion_tpu_torch.config import DATASETS, Config
from infodiffusion_tpu_torch.data import datasets as pds
from infodiffusion_tpu_torch.data.loader import (
    DataLoader,
    h2d_bytes_per_batch,
    pm1_on_device,
)

PM1_TOL = 2e-7


def _both(dataset, **kw):
    return (Config(dataset=dataset, **kw).with_dataset_config(),
            JConfig(dataset=dataset, **kw).with_dataset_config())


@pytest.mark.parametrize("dataset", DATASETS)
def test_synthetic_sets_equal_jax(dataset, monkeypatch):
    monkeypatch.setenv("INFODIFF_SYNTHETIC_N", "24")
    pcfg, jcfg = _both(dataset, data_dir="synthetic")
    got, want = pds.get_dataset(pcfg), jds.get_dataset(jcfg)
    assert got.images.dtype == want.images.dtype
    assert got.images.tobytes() == want.images.tobytes()
    assert got.images.shape == want.images.shape
    np.testing.assert_array_equal(got.attrs, want.attrs)
    assert got.normalize == want.normalize
    assert pds.dataset_flags(dataset) == jds.dataset_flags(dataset)


def _ordered_dataset(n=40, size=6, channels=2, seed=0):
    """Random uint8 images with attrs = their row index, so a batch's
    attrs name the rows it took."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, size, size, channels)).astype(np.uint8)
    return (pds.ArrayDataset(images=imgs, attrs=np.arange(n)),
            jds.ArrayDataset(images=imgs.copy(), attrs=np.arange(n)))


def _epochs(loader, n):
    return [[(np.asarray(x), np.asarray(a)) for x, a in loader]
            for _ in range(n)]


@pytest.mark.parametrize("skip", [0, 2])
@pytest.mark.parametrize("shuffle,flip", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_loader_batches_equal_jax(shuffle, flip, skip):
    pds_, jds_ = _ordered_dataset()
    kw = dict(shuffle=shuffle, flip=flip, seed=5, with_attrs=True)
    port = DataLoader(pds_, 8, device="cpu", **kw)
    ref = JLoader(jds_, 8, **kw)
    if skip:
        port.fast_forward(skip)
        ref.fast_forward(skip)
    got, want = _epochs(port, 3), _epochs(ref, 3)
    assert len(got) == len(want) == 3
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == 5  # drop_last
        for (gx, ga), (wx, wa) in zip(g_epoch, w_epoch):
            np.testing.assert_array_equal(ga, wa)  # the same rows
            assert gx.dtype == np.float32 and gx.shape == wx.shape
            assert np.abs(gx - wx).max() <= PM1_TOL
            assert gx.min() >= -1.0 and gx.max() <= 1.0


def test_host_normalize_ships_f32_and_is_exact(monkeypatch):
    pds_, jds_ = _ordered_dataset(n=16)
    monkeypatch.setenv("INFODIFF_HOST_NORMALIZE", "1")
    port = DataLoader(pds_, 8, device="cpu", flip=True, seed=3)
    assert not port.u8_transfer()
    assert h2d_bytes_per_batch(port) == 8 * 6 * 6 * 2 * 4
    want = [np.asarray(x) for x in JLoader(jds_, 8, flip=True, seed=3)]
    got = [x.numpy() for x in port]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.delenv("INFODIFF_HOST_NORMALIZE")
    assert DataLoader(pds_, 8, device="cpu").u8_transfer()
    assert h2d_bytes_per_batch(DataLoader(pds_, 8, device="cpu")) == 8 * 72


def test_pm1_on_device_every_code():
    u8 = torch.arange(256, dtype=torch.uint8)
    got = pm1_on_device(u8).numpy()
    want = np.arange(256).astype(np.float32) / 255.0 * 2.0 - 1.0
    assert np.abs(got - np.clip(want, -1, 1)).max() <= PM1_TOL
    assert got[0] == -1.0 and got[255] == 1.0


def test_latent_dataset_ships_raw_f32(tmp_path):
    a = np.random.RandomState(0).randn(20, 8).astype(np.float32)
    np.savez(tmp_path / "lat", all_a=a, all_attr=np.zeros(20))
    ds = pds.LatentDataset(str(tmp_path / "lat.npz"))
    loader = DataLoader(ds, 5, device="cpu")
    assert not loader.u8_transfer()
    got = np.concatenate([x.numpy() for x in loader])
    np.testing.assert_array_equal(got, a)


def test_abandoned_iteration_keeps_the_stream():
    pds_, _ = _ordered_dataset()
    a = DataLoader(pds_, 8, device="cpu", shuffle=True, flip=True, seed=9,
                   with_attrs=True)
    b = DataLoader(pds_, 8, device="cpu", shuffle=True, flip=True, seed=9,
                   with_attrs=True)
    next(iter(a))  # abandoned after one batch
    list(b)
    np.testing.assert_array_equal(
        np.concatenate([x[1] for x in a]), np.concatenate([x[1] for x in b]))


def test_producer_exception_reaches_the_consumer():
    class Broken(pds.ArrayDataset):
        def get_batch_u8(self, idx):
            raise OSError("decode failed")

    ds = Broken(images=np.zeros((8, 2, 2, 1), np.uint8))
    with pytest.raises(OSError, match="decode failed"):
        list(DataLoader(ds, 4, device="cpu"))


# ------------------------------------------------- on-disk readers


def _write_idx(path, arr, magic, gz=False):
    op = gzip.open if gz else open
    with op(path, "wb") as f:
        f.write(struct.pack(">I", magic))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


@pytest.mark.parametrize("name,sub", [("mnist", "MNIST"),
                                      ("fmnist", "FashionMNIST")])
def test_idx_reader_equals_jax(tmp_path, name, sub):
    raw = tmp_path / sub / "raw"
    raw.mkdir(parents=True)
    rng = np.random.RandomState(0)
    _write_idx(raw / "train-images-idx3-ubyte",
               rng.randint(0, 255, (10, 28, 28), dtype=np.uint8), 0x803)
    _write_idx(raw / "train-labels-idx1-ubyte.gz",
               rng.randint(0, 10, (10,)).astype(np.uint8), 0x801, gz=True)
    got = pds._load_mnist_like(str(tmp_path), name, 32)
    want = jds._load_mnist_like(str(tmp_path), name, 32)
    assert got.images.shape == (10, 32, 32, 1)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.attrs, want.attrs)


def test_cifar10_reader_equals_jax(tmp_path):
    root = tmp_path / "cifar-10-batches-py"
    root.mkdir()
    rng = np.random.RandomState(1)
    for i in range(1, 6):
        with open(root / f"data_batch_{i}", "wb") as f:
            pickle.dump({b"data": rng.randint(0, 255, (4, 3072),
                                              dtype=np.uint8),
                         b"labels": [0, 1, 2, 3]}, f)
    got, want = (m._load_cifar10(str(tmp_path)) for m in (pds, jds))
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.attrs, want.attrs)


@pytest.mark.parametrize("size", [32, 64])
def test_dsprites_reader_equals_jax(tmp_path, size):
    root = tmp_path / "dsprites-dataset"
    root.mkdir()
    rng = np.random.RandomState(2)
    np.savez(root / "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz",
             imgs=(rng.rand(10, 64, 64) > 0.5).astype(np.uint8),
             latents_values=rng.rand(10, 6),
             latents_classes=rng.randint(0, 3, (10, 6)))
    got, want = (m._load_dsprites(str(tmp_path), size) for m in (pds, jds))
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.attrs, want.attrs)
    assert got.normalize == want.normalize == "raw"
    np.testing.assert_array_equal(got.get_batch(np.arange(3))[0],
                                  want.get_batch(np.arange(3))[0])


def test_image_folders_equal_jax(tmp_path, monkeypatch):
    """celeba (attrs, the train split, resize and centre crop) and the
    plain folders (chairs, ffhq), decoded with PIL on both sides (the JAX
    native decoder switched off)."""
    monkeypatch.setattr(jds.ImageFolderDataset, "_native_batcher",
                        lambda self: None)
    rng = np.random.RandomState(3)
    root = tmp_path / "celeba"
    imdir = root / "img_align_celeba"
    imdir.mkdir(parents=True)
    names = [f"{i:06d}.jpg" for i in range(1, 7)]
    for n in names:
        Image.fromarray(rng.randint(0, 255, (218, 178, 3), dtype=np.uint8)
                        ).save(imdir / n)
    with open(root / "list_attr_celeba.txt", "w") as f:
        f.write("6\n" + " ".join(f"A{i}" for i in range(40)) + "\n")
        for j, n in enumerate(names):
            f.write(n + " " + " ".join("1" if (i + j) % 2 == 0 else "-1"
                                       for i in range(40)) + "\n")
    with open(root / "list_eval_partition.txt", "w") as f:
        for j, n in enumerate(names):
            f.write(f"{n} {0 if j < 4 else (1 if j == 4 else 2)}\n")
    for sub in ("3DChairs", "ffhq"):
        d = tmp_path / sub / "a"
        d.mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.randint(0, 255, (80, 70, 3), dtype=np.uint8)
                            ).save(d / f"{i}.png")
    for dataset in ("celeba", "chairs", "ffhq"):
        pcfg, jcfg = _both(dataset, data_dir=str(tmp_path))
        got, want = pds.get_dataset(pcfg), jds.get_dataset(jcfg)
        assert len(got) == len(want) == (4 if dataset == "celeba" else 3)
        idx = np.arange(len(got))
        gx, ga = got.get_batch_u8(idx)
        wx, wa = want.get_batch_u8(idx)
        np.testing.assert_array_equal(gx, wx)
        if dataset == "celeba":
            np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(got.get_batch(idx)[0],
                                      want.get_batch(idx)[0])


# ------------------------------------------------- PNG


def _read(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("shape,kw", [
    ((9, 7), {}),
    ((9, 7, 1), {}),
    ((9, 7, 3), {}),
    ((5, 9, 7, 1), {"nrow": 2, "normalize": True, "value_range": (-1, 1)}),
    ((10, 8, 6, 3), {"normalize": True, "value_range": (-1, 1)}),
    ((3, 8, 6, 3), {"nrow": 3, "normalize": True}),
    ((4, 8, 6, 3), {"nrow": 4}),
])
def test_png_pixels_equal_jax(tmp_path, shape, kw):
    x = np.random.RandomState(len(shape) + shape[-1]).uniform(
        -1.2, 1.2, shape).astype(np.float32)
    if not kw.get("normalize"):
        x = (x + 1.0) / 2.0
    pimg.save_image(x, str(tmp_path / "port.png"), **kw)
    jimg.save_image(x, str(tmp_path / "jax.png"), **kw)
    got, want = _read(tmp_path / "port.png"), _read(tmp_path / "jax.png")
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_png_batch_writer(tmp_path):
    u8 = np.random.RandomState(4).randint(0, 256, (5, 6, 7, 3)).astype(
        np.uint8)
    paths = [str(tmp_path / f"sample-{i:06d}.png") for i in range(5)]
    pimg.write_png_batch(paths, u8)
    for p, want in zip(paths, u8):
        np.testing.assert_array_equal(_read(p), want)
    gray = u8[..., :1]
    pimg.write_png(str(tmp_path / "g.png"), gray[0])
    np.testing.assert_array_equal(_read(tmp_path / "g.png"), gray[0, ..., 0])


def _jax_scatter():
    """The JAX runner's ``_scatter_png`` as written, with ``x.ptp()`` read
    as ``np.ptp(x)`` (numpy 2 dropped the method)."""
    src = inspect.getsource(jrunner._scatter_png)
    src = src.replace("x.ptp()", "np.ptp(x)").replace("y.ptp()", "np.ptp(y)")
    scope = {"np": np}
    exec(src, scope)
    return scope["_scatter_png"]


def test_scatter_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    x, y = rng.randn(300), rng.randn(300) * 3 + 1
    c = rng.randint(0, 13, 300).astype(float)
    _jax_scatter()(x, y, c, str(tmp_path / "jax.png"))
    got = prunner.scatter_image(x, y, c)
    np.testing.assert_array_equal(got, _read(tmp_path / "jax.png"))
    pimg.write_png(str(tmp_path / "port.png"), got)
    np.testing.assert_array_equal(_read(tmp_path / "port.png"), got)
