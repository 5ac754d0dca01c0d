"""FID / KID pipeline (JAX counterpart: ``infodiffusion_tpu/metrics/fid.py``;
reference: gen_fid_stats.py, calc_fid.py via clean-fid).

The same three-stage contract: (1) ``make_custom_stats`` over a real-image
dump -> cached stats, (2) generate images, (3) ``compute_fid`` /
``compute_kid`` of a folder against the named stats. The statistics are
clean-fid's definitions, computed on the host in numpy / scipy exactly as
the JAX package computes them (Frechet distance over the features' mean
and covariance; KID's unbiased polynomial-kernel MMD over subsets).

Feature extractors, on the run's device (``runner.resolve_device``: the
card, the CPU only under ``INFODIFF_FORCE_CPU=1``):

- ``inception`` (preferred): the port's InceptionV3 (metrics/inception.py)
  whenever a local ``pt_inception`` checkpoint is found, else clean-fid's
  extractor when it is importable. Its tag, "inception-jax", is the JAX
  package's: the same network gives the same features, so stats files
  are shared.
- ``random`` (fallback): a fixed seeded random-conv feature network.
  Scores are internally comparable across runs of the port but NOT
  comparable to published Inception-FID numbers, nor to the JAX package's
  random-conv scores: its kernels come from a ``torch.Generator``, which
  cannot reproduce ``jax.random``'s, so its tag is "random-conv-torch-v1"
  and the two never share a stats file.

Images are read with ``imaging.read_image_rgb`` (PNG without PIL) on a few
threads, one batch ahead of the extractor.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from infodiffusion_tpu_torch.data.datasets import _list_images
from infodiffusion_tpu_torch.imaging import read_image_rgb
from infodiffusion_tpu_torch.metrics.inception import (
    clean_resize,
    full_f32,
    inception_extractor,
)

_READERS = 4  # decode threads of _iter_folder (zlib releases the GIL)


def stats_dir() -> str:
    """Resolved per call so INFODIFF_FID_STATS_DIR set after import (or
    monkeypatched in tests) is honored."""
    return os.environ.get("INFODIFF_FID_STATS_DIR", "./fid_stats")


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------


def _try_inception_extractor(device):
    try:
        from cleanfid.features import build_feature_extractor  # type: ignore

        model = build_feature_extractor(mode="clean", device=device)

        def extract(batch_u8):  # [B, H, W, 3] uint8
            # clean-mode extractors expect PRE-resized 299x299 float
            # 0..255 input (resize_inside=False asserts the size): the
            # antialiased resize is ours, the port's clean_resize
            x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(device)
            with torch.no_grad():
                return model(clean_resize(x) * 255.0).cpu().numpy()

        return extract, "inception-clean"
    except ImportError:
        return None
    except Exception as e:  # importable but unusable (e.g. weight
        # download blocked): say so instead of silently degrading
        import warnings

        warnings.warn(
            f"clean-fid extractor unavailable ({type(e).__name__}: {e}); "
            "falling back"
        )
        return None


_RANDOM_CHANNELS = ((3, 64), (64, 128), (128, 192), (192, 384))


def _same_pad(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """XLA's padding="SAME" for a k x k window at stride s: the total pad
    of each spatial dim split with the smaller half first ((0, 1) for 3x3
    at stride 2 on an even size, (1, 1) on an odd one)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last dim first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def features(x: torch.Tensor, kernels) -> torch.Tensor:
    """The random-conv features: [B, H, W, 3] float in [0, 1] and four OIHW
    kernels -> [B, 768] (the global mean, then the global max, of the last
    layer). Each layer a 3x3 stride-2 SAME conv and LeakyReLU 0.2."""
    h = x.permute(0, 3, 1, 2) * 2.0 - 1.0
    for w in kernels:
        h = F.leaky_relu(F.conv2d(_same_pad(h), w, stride=2), 0.2)
    return torch.cat([h.mean(dim=(2, 3)), h.amax(dim=(2, 3))], dim=-1)


def _random_conv_extractor(seed: int = 0, device=None):
    """Seeded 4-layer random conv net -> global avg+max pooled features, the
    kernels drawn from a ``torch.Generator`` at the JAX package's He scale
    (HWIO draws, as JAX draws them, then OIHW)."""
    device = torch.device("cpu" if device is None else device)
    gen = torch.Generator().manual_seed(seed)
    kernels = [
        (torch.randn((3, 3, ci, co), generator=gen) * np.sqrt(2.0 / (9 * ci)))
        .permute(3, 2, 0, 1).contiguous().to(device)
        for ci, co in _RANDOM_CHANNELS
    ]

    def extract(batch_u8):
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(device)
        with torch.no_grad(), full_f32():
            return features(x.to(torch.float32) / 255.0, kernels).cpu().numpy()

    return extract, "random-conv-torch-v1"


def get_extractor(name: str = "auto", device=None):
    """(extract, tag): ``extract`` maps [B, H, W, 3] uint8 to [B, D] float32
    features on ``device`` (by default the run's device)."""
    if name not in ("auto", "inception", "random"):
        raise ValueError(
            f"unknown extractor {name!r} (expected 'auto', 'inception' or "
            "'random') — refusing to silently hand back random-conv "
            "features, whose scores are not Inception-comparable"
        )
    from infodiffusion_tpu_torch.runner import resolve_device

    device = resolve_device(device)
    if name in ("auto", "inception"):
        got = inception_extractor(device) or _try_inception_extractor(device)
        if got is not None:
            return got
        if name == "inception":
            raise RuntimeError(
                "InceptionV3 weights unavailable: no local pt_inception "
                "checkpoint (set INFODIFF_INCEPTION_WEIGHTS) and clean-fid "
                "is not importable; use extractor='random' or provide "
                "weights (no network egress in this environment)"
            )
    return _random_conv_extractor(device=device)


# ---------------------------------------------------------------------------
# folder -> features
# ---------------------------------------------------------------------------


def _read(path: str, res: Optional[int]) -> np.ndarray:
    arr = read_image_rgb(path)
    if res is not None and arr.shape[:2] != (res, res):
        # PIL's quantized uint8 bicubic, as the JAX package pre-resizes
        # (an image already at res x res is left as it is, as PIL does)
        from PIL import Image

        arr = np.asarray(Image.fromarray(arr).resize((res, res),
                                                     Image.BICUBIC))
    return arr


def _iter_folder(folder: str, res: Optional[int], batch: int = 256):
    """Batches of [B, H, W, 3] uint8. ``res=None`` keeps images at their
    NATIVE size (flushing the buffer whenever the size changes) — the
    clean-fid semantics, where the extractor's own antialiased 299
    resize is the ONLY resample. An integer ``res`` pre-resizes with
    quantized uint8 bicubic (needed for extractors without an internal
    resize, whose inputs must share one resolution to be comparable).
    The next ``batch`` files decode on threads while the caller works on
    the current batch."""
    files = _list_images(folder)
    if not files:
        raise FileNotFoundError(f"no images under {folder}")
    chunks = [files[i:i + batch] for i in range(0, len(files), batch)]
    with ThreadPoolExecutor(max_workers=_READERS) as ex:
        pending = [ex.submit(_read, p, res) for p in chunks[0]]
        try:
            buf = []
            for k in range(len(chunks)):
                done = pending
                pending = ([ex.submit(_read, p, res) for p in chunks[k + 1]]
                           if k + 1 < len(chunks) else [])
                for fut in done:
                    arr = fut.result()
                    if buf and buf[-1].shape != arr.shape:
                        yield np.stack(buf)
                        buf = []
                    buf.append(arr)
                    if len(buf) == batch:
                        yield np.stack(buf)
                        buf = []
            if buf:
                yield np.stack(buf)
        finally:  # a caller that stops early leaves no decode queued
            for fut in pending:
                fut.cancel()


def folder_features(
    folder: str, res: int = 64, extractor: str = "auto",
    max_images: Optional[int] = None, device=None,
) -> Tuple[np.ndarray, str]:
    extract, tag = get_extractor(extractor, device)
    # inception extractors clean-resize to 299 internally: feed native
    # sizes so that resize is the only resample, exactly like clean-fid
    # feeds original images. The random-conv extractor has no internal
    # resize — it keeps the res normalization so real and generated
    # folders are extracted at one resolution.
    size = None if tag.startswith("inception") else res
    feats = []
    n = 0
    for batch in _iter_folder(folder, size):
        feats.append(extract(batch))
        n += len(batch)
        if max_images is not None and n >= max_images:
            break
    out = np.concatenate(feats)
    if max_images is not None:
        out = out[:max_images]
    return out, tag


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID = |mu1-mu2|^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2}).

    Near-singular covariances (fewer images than feature dims) can make
    sqrtm non-finite; like pytorch-fid/clean-fid, retry with an eps
    offset on the diagonals instead of returning NaN."""
    import scipy.linalg

    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (sigma1 + offset) @ (sigma2 + offset)
        )
    if np.iscomplexobj(covmean):
        # like pytorch-fid: a large imaginary component means sqrtm
        # genuinely failed — refuse to return a silently-wrong score
        imax = float(np.max(np.abs(covmean.imag)))
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"covariance sqrtm failed (max imaginary component "
                f"{imax:.3g}): too few images for the feature "
                "dimensionality to form usable FID statistics"
            )
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def kid_score(
    feats1: np.ndarray, feats2: np.ndarray,
    n_subsets: int = 100, max_subset_size: int = 1000, seed: int = 0,
) -> float:
    """Unbiased polynomial-kernel MMD averaged over random subsets
    (clean-fid's KID protocol)."""
    n = feats1.shape[1]
    m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
    rng = np.random.RandomState(seed)
    t = 0.0
    for _ in range(n_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.trace(a)) / (m - 1) - b.sum() * 2 / m
    return float(t / n_subsets / m)


# ---------------------------------------------------------------------------
# clean-fid-shaped public API (reference: gen_fid_stats.py:8, calc_fid.py:6-14)
# ---------------------------------------------------------------------------


def _stats_path(name: str, extractor_tag: str) -> str:
    d = stats_dir()
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{name}_{extractor_tag}.npz")


def make_custom_stats(
    name: str, folder: str, res: int = 64, extractor: str = "auto",
    device=None,
) -> str:
    feats, tag = folder_features(folder, res, extractor, device=device)
    mu, sigma = feature_stats(feats)
    path = _stats_path(name, tag)
    np.savez(path, mu=mu, sigma=sigma, feats=feats, extractor=tag, res=res)
    return path


def compute_fid(
    folder: str, dataset_name: str, dataset_res: int = 64,
    num_gen: int = 10000, extractor: str = "auto", device=None, **_ignored,
) -> float:
    feats, tag = folder_features(
        folder, dataset_res, extractor, max_images=num_gen, device=device
    )
    ref = np.load(_stats_path(dataset_name, tag), allow_pickle=True)
    mu, sigma = feature_stats(feats)
    return frechet_distance(ref["mu"], ref["sigma"], mu, sigma)


def compute_kid(
    folder: str, dataset_name: str, dataset_res: int = 64,
    num_gen: int = 10000, extractor: str = "auto", device=None, **_ignored,
) -> float:
    feats, tag = folder_features(
        folder, dataset_res, extractor, max_images=num_gen, device=device
    )
    ref = np.load(_stats_path(dataset_name, tag), allow_pickle=True)
    return kid_score(ref["feats"], feats)
