"""The port's FID path against the JAX package's, on the CPU:

- ``imaging.decode_png`` / ``read_image_rgb`` equal PIL's decode, exactly,
  on PNGs the port writes, PNGs PIL writes (colour types 0, 2, 3, 4, 6)
  and hand-built PNGs that use each of the five row filters; an
  interlaced or 16-bit file raises;
- the random-conv ``features`` given JAX's kernels (drawn here as
  ``infodiffusion_tpu/metrics/fid.py`` draws them) equal JAX's within
  1e-5 relative (SAME padding at stride 2 included);
- ``feature_stats`` / ``frechet_distance`` within 1e-8 relative (the eps
  retry and the imaginary refusal included), ``kid_score`` exactly, the
  stats npz with the same keys;
- ``make_custom_stats`` -> ``compute_fid`` / ``compute_kid`` through a
  fixture checkpoint give JAX's scores on the same two folders within
  1e-3 relative;
- ``get_extractor``'s errors, the folder batching and the two entry
  points (the root shims' lines; no card and no INFODIFF_FORCE_CPU
  raises).
"""

import io
import os
import runpy
import struct
import sys
import zlib

import jax.random as jr
import numpy as np
import pytest
import torch
from PIL import Image

from infodiffusion_tpu.metrics import fid as jfid
from infodiffusion_tpu.metrics import inception as jinc
from infodiffusion_tpu_torch import imaging
from infodiffusion_tpu_torch.metrics import fid as pfid
from infodiffusion_tpu_torch.metrics import inception as pinc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_TOL = 1e-5
FID_TOL = 1e-8
PIPELINE_TOL = 1e-3


# ---------------------------------------------------------------- PNG


def _smooth(h, w, c, seed):
    """Gradients with a little noise: PIL's adaptive filtering then picks
    Sub, Up and Paeth rows as well as None."""
    rng = np.random.RandomState(seed)
    g = np.add.outer(np.linspace(0, 200, h), np.linspace(0, 55, w))
    img = g[..., None] + np.arange(c) * 17 + rng.randint(0, 3, (h, w, c))
    return (img % 256).astype(np.uint8)


def _pil_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _pil_decode_rgb_or_raw(data: bytes, mode: str) -> np.ndarray:
    img = Image.open(io.BytesIO(data))
    arr = np.asarray(img.convert("RGB") if mode == "P" else img)
    return arr[..., None] if arr.ndim == 2 else arr


@pytest.mark.parametrize("c", [1, 3, 4])
def test_decode_png_reads_the_port_writer(c):
    img = np.random.RandomState(c).randint(0, 256, (19, 23, c)).astype(
        np.uint8)
    data = imaging.encode_png(img)
    want = np.asarray(Image.open(io.BytesIO(data)))
    got = imaging.decode_png(data)
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_decode_png_reads_pil_files(mode):
    c = {"L": 1, "RGB": 3, "P": 1, "LA": 2, "RGBA": 4}[mode]
    arr = _smooth(33, 41, c, seed=len(mode))
    img = Image.fromarray(arr[..., 0] if c == 1 else arr, mode)
    if mode == "P":  # a full 256-entry palette: PIL writes bit depth 8
        img.putpalette(np.random.RandomState(1).randint(
            0, 256, 768).astype(np.uint8).tobytes())
    data = _pil_png(img)
    np.testing.assert_array_equal(imaging.decode_png(data),
                                  _pil_decode_rgb_or_raw(data, mode))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img: np.ndarray, kind: int) -> bytes:
    """A PNG of ``img`` [H, W, C] whose every row uses row filter ``kind``,
    filtered here byte by byte from the PNG specification."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for r in range(h):
        up = rows[r - 1] if r else np.zeros(w * c, np.int64)
        line = [kind]
        for i in range(w * c):
            a = rows[r, i - c] if i >= c else 0
            b, cc = up[i], (up[i - c] if i >= c else 0)
            pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2,
                    4: _paeth(a, b, cc)}[kind]
            line.append((rows[r, i] - pred) % 256)
        out.append(bytes(line))
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (imaging._SIGNATURE
            + imaging._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                  0, 0, 0))
            + imaging._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + imaging._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_decode_png_each_row_filter(kind):
    img = np.random.RandomState(kind).randint(0, 256, (9, 13, 3)).astype(
        np.uint8)
    data = _filtered_png(img, kind)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)  # PIL reads the file as written
    np.testing.assert_array_equal(imaging.decode_png(data), img)


@pytest.mark.parametrize("depth,interlace", [(8, 1), (16, 0)])
def test_decode_png_refuses_other_layouts(depth, interlace):
    data = (imaging._SIGNATURE
            + imaging._chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, depth, 2,
                                                  0, 0, interlace))
            + imaging._chunk(b"IDAT", zlib.compress(b"\0" * 64))
            + imaging._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=f"bit depth {depth}, colour type "
                                         f"2, interlace {interlace}"):
        imaging.decode_png(data)


@pytest.mark.parametrize("mode,ext", [("L", "png"), ("LA", "png"),
                                      ("P", "png"), ("RGBA", "png"),
                                      ("RGB", "jpg")])
def test_read_image_rgb_is_pil_convert_rgb(mode, ext, tmp_path):
    c = {"L": 1, "LA": 2, "P": 1, "RGBA": 4, "RGB": 3}[mode]
    arr = _smooth(21, 17, c, seed=3)
    img = Image.fromarray(arr[..., 0] if c == 1 else arr, mode)
    if mode == "P":
        img.putpalette(np.random.RandomState(2).randint(
            0, 256, 768).astype(np.uint8).tobytes())
    path = str(tmp_path / f"x.{ext}")
    img.save(path)
    got = imaging.read_image_rgb(path)
    assert got.shape == (21, 17, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, np.asarray(Image.open(path).convert("RGB")))


def test_read_image_rgb_names_the_format_without_pil(tmp_path):
    import subprocess

    path = str(tmp_path / "x.jpg")
    Image.fromarray(_smooth(8, 8, 3, 0)).save(path)
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from infodiffusion_tpu_torch.imaging import read_image_rgb\n"
            f"read_image_rgb({path!r})\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert "a JPEG file needs PIL" in out.stderr, out.stderr


# ---------------------------------------------------------- random conv


def _jax_kernels(seed=0):
    ks = jr.split(jr.PRNGKey(seed), 4)
    chans = [(3, 64), (64, 128), (128, 192), (192, 384)]
    return [np.array(jr.normal(k, (3, 3, ci, co)) * np.sqrt(2.0 / (9 * ci)))
            for k, (ci, co) in zip(ks, chans)]


@pytest.mark.parametrize("size", [64, 37])
def test_random_conv_features_match_jax(size):
    batch = np.random.RandomState(size).randint(
        0, 256, (3, size, size, 3)).astype(np.uint8)
    want = jfid._random_conv_extractor(0)[0](batch)
    kernels = [torch.from_numpy(k).permute(3, 2, 0, 1).contiguous()
               for k in _jax_kernels()]
    got = pfid.features(torch.from_numpy(batch).float() / 255.0,
                        kernels).numpy()
    assert got.shape == want.shape == (3, 768)
    assert np.abs(got - want).max() <= FEATURE_TOL * np.abs(want).max()


def test_random_conv_extractor_tag_and_seed():
    extract, tag = pfid.get_extractor("random", device="cpu")
    assert tag == "random-conv-torch-v1" != jfid._random_conv_extractor()[1]
    batch = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3)).astype(
        np.uint8)
    np.testing.assert_array_equal(extract(batch),
                                  pfid._random_conv_extractor(0)[0](batch))
    assert not np.array_equal(extract(batch),
                              pfid._random_conv_extractor(1)[0](batch))


# ------------------------------------------------------------ statistics


def _feats(seed, n=300, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) @ rng.randn(d, d) * 0.3 + seed).astype(np.float32)


def test_stats_and_scores_match_jax():
    f1, f2 = _feats(0), _feats(1)
    for got, want in zip(pfid.feature_stats(f1), jfid.feature_stats(f1)):
        np.testing.assert_array_equal(got, want)
    mu1, s1 = jfid.feature_stats(f1)
    mu2, s2 = jfid.feature_stats(f2)
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    got = pfid.frechet_distance(mu1, s1, mu2, s2)
    assert want > 0 and abs(got - want) <= FID_TOL * want
    assert pfid.kid_score(f1, f2) == jfid.kid_score(f1, f2)
    assert pfid.kid_score(f1, f2, n_subsets=7, max_subset_size=50, seed=3) \
        == jfid.kid_score(f1, f2, n_subsets=7, max_subset_size=50, seed=3)


def test_frechet_distance_eps_retry_and_imaginary_refusal(monkeypatch):
    import scipy.linalg

    real = scipy.linalg.sqrtm
    calls = []

    def flaky(m):
        calls.append(1)
        return np.full(np.asarray(m).shape, np.nan) if len(calls) == 1 \
            else real(m)

    monkeypatch.setattr(scipy.linalg, "sqrtm", flaky)
    mu, sigma = np.zeros(4), np.eye(4)
    assert pfid.frechet_distance(mu, sigma, mu, sigma) == pytest.approx(
        0.0, abs=1e-4)
    assert len(calls) == 2
    monkeypatch.setattr(scipy.linalg, "sqrtm",
                        lambda m: np.eye(len(m)) * (1 + 0.5j))
    for mod in (pfid, jfid):
        with pytest.raises(ValueError, match="sqrtm failed"):
            mod.frechet_distance(mu, sigma, mu, sigma)


def _write_folder(path, imgs):
    path.mkdir()
    imaging.write_png_batch([str(path / f"sample-{i:06d}.png")
                             for i in range(len(imgs))], imgs)
    return str(path)


def test_stats_file_schema_matches_jax(tmp_path, monkeypatch):
    folder = _write_folder(tmp_path / "real", np.random.RandomState(0)
                           .randint(0, 256, (6, 32, 32, 3)).astype(np.uint8))
    monkeypatch.setenv("INFODIFF_FID_STATS_DIR", str(tmp_path / "stats"))
    got = np.load(pfid.make_custom_stats("s", folder, res=32,
                                         extractor="random", device="cpu"),
                  allow_pickle=True)
    want = np.load(jfid.make_custom_stats("s", folder, res=32,
                                          extractor="random"),
                   allow_pickle=True)
    assert sorted(got.files) == sorted(want.files) == sorted(
        ["mu", "sigma", "feats", "extractor", "res"])
    for key in got.files:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype.kind == want[key].dtype.kind, key
    assert str(got["extractor"]) == "random-conv-torch-v1"
    assert int(got["res"]) == 32


def test_fid_pipeline_matches_jax(tmp_path, monkeypatch):
    """make_custom_stats -> compute_fid / compute_kid through the same
    fixture checkpoint and the same two folders (smooth 'real' images,
    noise 'generated' ones, written by the port's PNG writer): the port's
    scores equal the JAX package's within 1e-3 relative, and the JAX
    package scores against the port's stats file (the shared tag)."""
    ckpt = tmp_path / "pt_inception-fixture.pth"
    torch.save(pinc.random_state_dict(2), ckpt)
    monkeypatch.setenv("INFODIFF_INCEPTION_WEIGHTS", str(ckpt))
    rng = np.random.RandomState(5)
    g = np.linspace(0, 255, 64, dtype=np.float32)
    real = np.stack([np.stack([np.outer(g, g[::-1]) / 255.0 + rng.rand() * 40]
                              * 3, -1).clip(0, 255) for _ in range(10)])
    real = _write_folder(tmp_path / "real", real.astype(np.uint8))
    gen = _write_folder(tmp_path / "gen", rng.randint(
        0, 256, (10, 64, 64, 3)).astype(np.uint8))
    scores = {}
    jinc._cached_extractor.cache_clear()
    pinc._cached_extractor.cache_clear()
    try:
        for side, mod, dev in (("jax", jfid, {}),
                               ("torch", pfid, {"device": "cpu"})):
            monkeypatch.setenv("INFODIFF_FID_STATS_DIR",
                               str(tmp_path / f"stats_{side}"))
            mod.make_custom_stats("fixture_set", real, extractor="inception",
                                  **dev)
            scores[side] = [f(gen, "fixture_set", extractor="inception", **dev)
                            for f in (mod.compute_fid, mod.compute_kid)]
        # the port's stats file (the shared tag) read by the JAX package
        shared = jfid.compute_kid(gen, "fixture_set", extractor="inception")
    finally:
        jinc._cached_extractor.cache_clear()
        pinc._cached_extractor.cache_clear()
    (fid_j, kid_j), (fid_p, kid_p) = scores["jax"], scores["torch"]
    assert fid_j > 0 and np.isfinite(kid_j)
    assert abs(fid_p - fid_j) <= PIPELINE_TOL * fid_j
    assert abs(kid_p - kid_j) <= PIPELINE_TOL * abs(kid_j)
    assert abs(shared - kid_j) <= PIPELINE_TOL * abs(kid_j)


# ----------------------------------------------------- extractor choice


def test_get_extractor_errors_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("INFODIFF_INCEPTION_WEIGHTS", raising=False)
    errors = {}
    for side, call in (("jax", jfid.get_extractor),
                       ("torch", lambda n: pfid.get_extractor(n, "cpu"))):
        for name, exc in (("inceptionv4", ValueError),
                          ("inception", RuntimeError)):
            with pytest.raises(exc) as info:
                call(name)
            errors[side, name] = str(info.value)
    for name in ("inceptionv4", "inception"):
        assert errors["torch", name] == errors["jax", name]
    assert pfid.get_extractor("auto", "cpu")[1] == "random-conv-torch-v1"


def test_no_card_and_no_force_cpu_raises(tmp_path, monkeypatch):
    from infodiffusion_tpu_torch import calc_fid, gen_fid_stats

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("INFODIFF_FORCE_CPU", raising=False)
    folder = _write_folder(tmp_path / "f", np.zeros((2, 8, 8, 3), np.uint8))
    for main in (gen_fid_stats.main, calc_fid.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["name", folder])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfid.get_extractor("random")


def test_iter_folder_batches_as_jax(tmp_path):
    """Native sizes with a flush on each change of size (res=None), a
    pre-resize to res otherwise, the batch size kept: the same batches as
    the JAX package's reader, pixel for pixel."""
    rng = np.random.RandomState(0)
    for i, size in enumerate([32, 32, 48, 48, 48, 32, 64]):
        Image.fromarray(rng.randint(0, 256, (size, size, 3)).astype(
            np.uint8)).save(tmp_path / f"{i}.png")
    for res, batch in ((None, 2), (None, 8), (64, 8), (32, 3)):
        got = list(pfid._iter_folder(str(tmp_path), res, batch=batch))
        want = list(jfid._iter_folder(str(tmp_path), res, batch=batch))
        assert [b.shape for b in got] == [b.shape for b in want]
        for b_got, b_want in zip(got, want):
            np.testing.assert_array_equal(b_got, b_want)


def test_entry_points_print_the_root_shims_lines(tmp_path, monkeypatch,
                                                 capsys):
    """python -m infodiffusion_tpu_torch.gen_fid_stats / .calc_fid print
    what the root gen_fid_stats.py / calc_fid.py print (the random-conv
    extractor, no weights): the same lines, the stats path and the scores
    aside, and a stats file each can read back."""
    from infodiffusion_tpu_torch import calc_fid, gen_fid_stats

    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("INFODIFF_FORCE_CPU", "1")
    monkeypatch.delenv("INFODIFF_INCEPTION_WEIGHTS", raising=False)
    rng = np.random.RandomState(1)
    real = _write_folder(tmp_path / "real", rng.randint(
        0, 256, (12, 64, 64, 3)).astype(np.uint8))
    gen = _write_folder(tmp_path / "gen", rng.randint(
        0, 128, (12, 64, 64, 3)).astype(np.uint8))
    lines = {}
    for side in ("jax", "torch"):
        monkeypatch.setenv("INFODIFF_FID_STATS_DIR", str(tmp_path / side))
        for script, args in (("gen_fid_stats", ["fx", real]),
                             ("calc_fid", ["fx", gen])):
            if side == "jax":
                monkeypatch.setattr(sys, "argv", [script, *args])
                runpy.run_path(os.path.join(REPO, f"{script}.py"),
                               run_name="__main__")
            else:
                {"gen_fid_stats": gen_fid_stats,
                 "calc_fid": calc_fid}[script].main(args)
        lines[side] = capsys.readouterr().out.strip().splitlines()

    def shape(line):
        head, _, tail = line.rpartition(" ")
        return head if line.startswith(("Saved", "fid:", "kid:")) else line

    assert [shape(x) for x in lines["torch"]] == [shape(x) for x in
                                                  lines["jax"]]
    assert lines["torch"][0] == (f"Generating fid stats for dataset fx "
                                 f"located at {real}")
    assert lines["torch"][1].endswith("fx_random-conv-torch-v1.npz")
    fid = float(lines["torch"][2].split()[-1])
    kid = float(lines["torch"][3].split()[-1])
    assert fid > 0 and np.isfinite(kid)
