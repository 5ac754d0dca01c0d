"""The port's native image batcher (``data/native.py`` over
``native/image_loader.cpp``), its PNG writer and the image folders held
against the JAX package: the same JPEG and PNG files through the port's
``NativeImageBatcher`` and the JAX one, bit for bit (both decode JPEG with
libjpeg here), and against PIL within the JAX package's bars (mean < 0.5,
max <= 2 a pixel: the resampling's rounding). The committed CelebA-shaped
fixtures (``tests/fixtures/celeba_jpeg``) and their expected decodes are
re-made here with PIL."""

import builtins
import importlib.util
import os
import sys

import numpy as np
import pytest

from infodiffusion_tpu.data import native as jnative
from infodiffusion_tpu.data.datasets import ImageFolderDataset as JFolder
from infodiffusion_tpu_torch import imaging, tracing
from infodiffusion_tpu_torch.data import native
from infodiffusion_tpu_torch.data.datasets import ImageFolderDataset

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "celeba_jpeg")
MODES = {"center_crop": (True, False), "d2c": (False, True),
         "plain": (False, False)}
PIL_MEAN, PIL_MAX = 0.5, 2.0  # the JAX package's bars against PIL


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _images(tmp_path, n=6):
    """CelebA-sized JPEGs (noise and smooth fields) and one PNG."""
    from PIL import Image

    rng = np.random.RandomState(0)
    mf = _fixture_module()
    files = []
    for i in range(n):
        arr = (rng.randint(0, 256, (218, 178, 3), dtype=np.uint8) if i % 2
               else mf.smooth_image(rng))
        p = tmp_path / f"{i:03d}.jpg"
        Image.fromarray(arr).save(p, quality=95)
        files.append(str(p))
    p = tmp_path / "z.png"
    Image.fromarray(rng.randint(0, 256, (218, 178, 3), dtype=np.uint8)).save(p)
    files.append(str(p))
    return files


def _pil(files, size, center_crop, d2c):
    mf = _fixture_module()
    return np.stack([mf.pil_decode(f, size, center_crop, d2c) for f in files])


def test_library_builds_into_the_build_tree():
    assert native.native_available(), native.build_error()
    assert native.backend() == "libjpeg"  # libjpeg's headers are here
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))))
    built = [os.path.relpath(str(p), root) for p in
             native.BUILD_ROOT.glob("*/libimage_loader.so")]
    assert built and all(p.startswith(os.path.join("build", "image_loader"))
                         for p in built)


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("mode", list(MODES))
def test_batcher_bitwise_jax_and_near_pil(tmp_path, mode, size):
    files = _images(tmp_path)
    idx = np.arange(len(files))
    got = native.NativeImageBatcher(files, size, *MODES[mode]).decode(idx)
    want = jnative.NativeImageBatcher(files, size, *MODES[mode]).decode(idx)
    assert got.shape == (len(files), size, size, 3)
    np.testing.assert_array_equal(got, want)
    d = np.abs(got.astype(np.float64) - _pil(files, size, *MODES[mode]))
    assert d.mean() < PIL_MEAN and d.max() <= PIL_MAX


def test_folder_get_batch_u8_bitwise_jax(tmp_path):
    files = _images(tmp_path)
    attrs = np.arange(len(files) * 2).reshape(len(files), 2)
    idx = np.array([3, 0, 6, 6, 1])
    for center_crop, d2c in MODES.values():
        kw = dict(files=files, size=64, center_crop=center_crop, d2c=d2c,
                  attrs=attrs)
        got, ga = ImageFolderDataset(**kw).get_batch_u8(idx)
        want, wa = JFolder(**kw).get_batch_u8(idx)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ga, wa)
        xg, _ = ImageFolderDataset(**kw).get_batch(idx)
        xw, _ = JFolder(**kw).get_batch(idx)
        np.testing.assert_array_equal(xg, xw)


def test_fixtures_match_pil():
    """The committed expected decodes equal PIL's decode of the committed
    JPEGs, and the native batcher lands within the bars of them."""
    mf = _fixture_module()
    want = mf.expected_arrays()
    have = mf.load_expected()
    np.testing.assert_array_equal(have["files"], want["files"])
    for mode, flags in MODES.items():
        np.testing.assert_array_equal(have[mode], want[mode])
        got = native.NativeImageBatcher(mf.good_files(), 64, *flags).decode(
            np.arange(mf.N_GOOD))
        d = np.abs(got.astype(np.float64) - have[mode])
        assert d.mean() < PIL_MEAN and d.max() <= PIL_MAX
    size = sum(os.path.getsize(os.path.join(FIXTURES, f))
               for f in os.listdir(FIXTURES) if not f.startswith("__"))
    assert size < 200 * 1024


def test_fixture_failures():
    """The CMYK and truncated fixtures fail their slots; the good ones
    beside them decode."""
    files = [os.path.join(FIXTURES, f)
             for f in ("cmyk.jpg", "000002.jpg", "truncated.jpg")]
    out, failed = native.NativeImageBatcher(files, 64, True, False) \
        .decode_with_failures(np.arange(3))
    assert list(failed) == [0, 2]
    assert not out[0].any() and not out[2].any() and out[1].std() > 1.0


def test_png_modes_bitwise_pil(tmp_path):
    """8-bit PNGs of every colour type (and PIL's adaptive row filters)
    read as PIL's convert('RGB') reads them: grey replicated, a palette
    looked up, alpha dropped. A square image resized to its own size in
    the plain mode is its pixels."""
    from PIL import Image

    rng = np.random.RandomState(3)
    base = rng.randint(0, 256, (32, 32, 4), dtype=np.uint8)
    smooth = np.cumsum(rng.randint(0, 3, (32, 32, 3)), axis=1).astype(np.uint8)
    imgs = {"RGB": Image.fromarray(base[..., :3]),
            "RGBA": Image.fromarray(base, "RGBA"),
            "L": Image.fromarray(base[..., 0]),
            "LA": Image.fromarray(base[..., :2], "LA"),
            "smooth": Image.fromarray(smooth),
            "P": Image.fromarray(base[..., :3]).quantize(17)}
    files = []
    for name, img in imgs.items():
        files.append(str(tmp_path / f"{name}.png"))
        img.save(files[-1])
    got = native.NativeImageBatcher(files, 32, False, False).decode(
        np.arange(len(files)))
    for g, (name, img) in zip(got, imgs.items()):
        np.testing.assert_array_equal(g, np.asarray(img.convert("RGB")),
                                      err_msg=name)


def test_png_writer_roundtrip(tmp_path):
    """RGB and grey batches, read back by PIL and by the port's own PNG
    reader; the writes are counted."""
    from PIL import Image

    rng = np.random.RandomState(0)
    before = tracing.counts["written"]
    rgb = rng.randint(0, 256, (6, 16, 12, 3), dtype=np.uint8)
    paths = [str(tmp_path / f"w{i}.png") for i in range(6)]
    assert native.write_png_batch(paths, rgb)
    grey = rng.randint(0, 256, (2, 8, 8, 1), dtype=np.uint8)
    gpaths = [str(tmp_path / f"g{i}.png") for i in range(2)]
    assert native.write_png_batch(gpaths, grey)
    assert tracing.counts["written"] == before + 8
    for p, want in zip(paths, rgb):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), want)
        np.testing.assert_array_equal(imaging.read_image_rgb(p), want)
    for p, want in zip(gpaths, grey):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), want[..., 0])
    # what it does not write, it declines: the caller writes it another way
    assert not native.write_png_batch(paths[:1], rgb[:1, ..., :2])
    assert not native.write_png_batch(paths[:2], rgb[:1])


def test_cmyk_retried_through_pil(tmp_path):
    """A CMYK JPEG fails the native slot; the folder retries it through
    PIL, as the JAX package does, and gets its pixels."""
    from PIL import Image

    rgb = np.random.RandomState(1).randint(0, 256, (96, 96, 3), np.uint8)
    p = str(tmp_path / "cmyk.jpg")
    Image.fromarray(rgb).convert("CMYK").save(p, quality=95)
    good = os.path.join(FIXTURES, "000003.jpg")
    kw = dict(files=[good, p], size=64, center_crop=False)
    before = tracing.counts["pil"]
    got, _ = ImageFolderDataset(**kw).get_batch_u8(np.arange(2))
    assert tracing.counts["pil"] == before + 1  # the retried slot only
    want, _ = JFolder(**kw).get_batch_u8(np.arange(2))
    np.testing.assert_array_equal(got, want)
    assert got[1].mean() > 10  # real pixels, not a zero-filled slot


def test_failed_slot_without_pil_names_the_file(monkeypatch):
    """Where PIL is absent (the card's machine) a slot the native decoder
    fails raises an IOError naming the file and PIL; never zeros."""
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    cmyk = os.path.join(FIXTURES, "cmyk.jpg")
    ds = ImageFolderDataset(files=[os.path.join(FIXTURES, "000001.jpg"),
                                   cmyk], size=64, center_crop=True)
    np.testing.assert_equal(ds.get_batch_u8(np.arange(1))[0].shape,
                            (1, 64, 64, 3))  # good files need no PIL
    with pytest.raises(IOError, match="cmyk.jpg.*PIL"):
        ds.get_batch_u8(np.arange(2))


def test_corrupt_files_raise_and_the_batcher_survives(tmp_path):
    """Truncated, garbage and empty files and a missing one fail their
    slots (decode raises IOError); the folder raises too, through PIL;
    the same batcher then decodes clean batches."""
    good = [os.path.join(FIXTURES, f"00000{i}.jpg") for i in (1, 2)]
    trunc = tmp_path / "trunc.jpg"
    trunc.write_bytes(open(good[0], "rb").read()[:700])
    garbage = tmp_path / "garbage.png"
    garbage.write_bytes(b"\x89PNG\r\n\x1a\nnotanimage" * 64)
    empty = tmp_path / "empty.jpg"
    empty.write_bytes(b"")
    bad = good + [str(trunc), str(garbage), str(empty),
                  str(tmp_path / "missing.jpg")]
    nat = native.NativeImageBatcher(bad, 32, True, False)
    out, failed = nat.decode_with_failures(np.arange(len(bad)))
    assert list(failed) == [2, 3, 4, 5]
    assert not out[2:].any()
    with pytest.raises(IOError, match="4/6 images failed to decode"):
        nat.decode(np.arange(len(bad)))
    assert nat.decode(np.arange(2)).std() > 1.0
    with pytest.raises(OSError):
        ImageFolderDataset(files=bad, size=32,
                           center_crop=True).get_batch_u8(np.arange(4))


def test_bad_index_raises():
    nat = native.NativeImageBatcher(
        [os.path.join(FIXTURES, "000001.jpg")], 32, True, False)
    with pytest.raises(IOError):
        nat.decode(np.asarray([0, 99]))
    with pytest.raises(IOError):
        nat.decode(np.asarray([-1]))


def test_center_crop_half_boundary_matches_jax(tmp_path):
    """At an exact .5 resize boundary (129x128 at 64: scale 0.5) the crop
    rounds half to even, as Python's round() in the PIL path."""
    from PIL import Image

    p = str(tmp_path / "hb.png")
    Image.fromarray(np.random.RandomState(2).randint(
        0, 256, (129, 128, 3), dtype=np.uint8)).save(p)
    got = native.NativeImageBatcher([p], 64, True, False).decode(np.arange(1))
    want = jnative.NativeImageBatcher([p], 64, True, False).decode(
        np.arange(1))
    np.testing.assert_array_equal(got, want)
    d = np.abs(got.astype(np.float64) - _pil([p], 64, True, False))
    assert d.mean() < PIL_MEAN and d.max() <= PIL_MAX


def test_disabled_library_takes_pil(tmp_path, monkeypatch):
    """INFODIFF_DISABLE_NATIVE=1: no library, the folder decodes every
    image through PIL (the JAX package's fallback), within the bars."""
    files = _images(tmp_path, n=2)
    monkeypatch.setenv("INFODIFF_DISABLE_NATIVE", "1")
    assert not native.native_available()
    assert "INFODIFF_DISABLE_NATIVE" in native.build_error()
    assert not native.write_png_batch([str(tmp_path / "x.png")],
                                      np.zeros((1, 4, 4, 3), np.uint8))
    before = tracing.counts["pil"]
    got, _ = ImageFolderDataset(files=files, size=64,
                                center_crop=True).get_batch_u8(np.arange(3))
    np.testing.assert_array_equal(got, _pil(files, 64, True, False))
    assert tracing.counts["pil"] == before + 3


def test_unbuilt_library_beside_a_card_raises(tmp_path, monkeypatch):
    """Where a card is visible, a library that did not build raises,
    naming the build's error, instead of decoding through PIL;
    INFODIFF_DISABLE_NATIVE=1 asks for PIL explicitly."""
    import torch

    files = _images(tmp_path, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(native, "native_available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "g++: not found")
    ds = ImageFolderDataset(files=files, size=32, center_crop=True)
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        ds.get_batch_u8(np.arange(2))
    monkeypatch.setenv("INFODIFF_DISABLE_NATIVE", "1")
    got, _ = ImageFolderDataset(files=files, size=32,
                                center_crop=True).get_batch_u8(np.arange(2))
    np.testing.assert_array_equal(got, _pil(files, 32, True, False))


def test_plane_output_stage_bitwise_libjpeg(tmp_path):
    """The nvJPEG build's output stage (libjpeg's fancy chroma upsampling
    and its fixed-point YCbCr -> RGB, applied to decoded planes) against
    libjpeg's own RGB, bit for bit, at 4:2:0, 4:2:2 and 4:4:4 and odd sizes
    (tests/native_ycc_check.cpp, compiled here against libjpeg)."""
    import shutil
    import subprocess

    from PIL import Image

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    exe = str(tmp_path / "ycc_check")
    src = os.path.join(os.path.dirname(__file__), "native_ycc_check.cpp")
    subprocess.run(["g++", "-O1", "-std=c++17", src, "-o", exe, "-ljpeg",
                    "-lz", "-pthread"], check=True, capture_output=True)
    rng = np.random.RandomState(5)
    files = [os.path.join(FIXTURES, "000004.jpg")]
    for i, (w, h, sub) in enumerate([(178, 218, 2), (179, 217, 2),
                                     (97, 33, 1), (64, 64, 0), (5, 7, 2),
                                     (3, 9, 1), (2, 6, 2)]):
        files.append(str(tmp_path / f"s{i}.jpg"))
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            files[-1], quality=90, subsampling=sub)
    out = subprocess.run([exe, *files], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count(": 0 of") == len(files), out.stdout
