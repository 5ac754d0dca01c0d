"""Host image I/O rates: the native batcher's JPEG decode against a PIL
thread pool, and the native PNG writer against ``imaging.write_png_batch``,
on the same files and images.

    python -m infodiffusion_tpu_torch.tools.image_io_bench \\
        [--files 512] [--batch 128] [--repeats 5] [--writes 128,10000]

Decode: the CelebA-shaped fixtures (``tests/fixtures/celeba_jpeg``, 178x218
at quality 95) copied to ``--files`` names, decoded to 64x64 with the
center crop (CelebA's transform), ``--batch`` at a time, by
``ImageFolderDataset`` with the native library (``data/native.py``, the
build that loads: libjpeg or nvJPEG), and by the same dataset's PIL decode
(``_load_one``, the PIL path's pixels) mapped over a thread pool of one
worker a core and over one thread. Write: the decoded images, tiled to each
count of ``--writes``, as one PNG each, through the native writer and
through ``imaging.write_png_batch``; the two outputs are checked to decode
to the same pixels. Every figure is the median of ``--repeats`` timings on
the host clock, the two sides interleaved. Prints the card's name and power
limit (``nvidia-smi``), then one JSON line. The PIL rows need PIL and are
null where it is absent. The files live in a temporary folder under
``build/`` at the root of the checkout, removed at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from infodiffusion_tpu_torch import imaging
from infodiffusion_tpu_torch.data import native
from infodiffusion_tpu_torch.data.datasets import ImageFolderDataset

ROOT = Path(__file__).resolve().parents[2]
FIXTURES = ROOT / "tests" / "fixtures" / "celeba_jpeg"
SIZE = 64


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def median_s(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def have_pil() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def decode_rates(files, batch: int, repeats: int) -> dict:
    """Images/s of each decoder over all ``files``, ``batch`` at a time."""
    ds = ImageFolderDataset(files=files, size=SIZE, center_crop=True)
    batches = [np.arange(i, i + batch) for i in range(0, len(files), batch)]
    threads = os.cpu_count() or 1

    def run_native():
        for idx in batches:
            ds.get_batch_u8(idx)

    def run_pool(pool):
        for idx in batches:
            np.stack(list(pool.map(ds._load_one, [files[i] for i in idx])))

    def run_one():
        for idx in batches:
            np.stack([ds._load_one(files[i]) for i in idx])

    n = sum(len(b) for b in batches)
    out = {"images": n, "batch": batch, "backend": native.backend(),
           "pil_threads": threads}
    before = native.counts["pil"]
    run_native()  # builds the library, warms the page cache
    if native.counts["pil"] != before:
        raise AssertionError("the native batcher sent images to PIL")
    sides = {"native": run_native}
    pool = None
    if have_pil():
        pool = ThreadPoolExecutor(max_workers=threads)
        sides.update(pil_pool=lambda: run_pool(pool), pil_one=run_one)
        for fn in sides.values():
            fn()
    times = {k: [] for k in sides}
    for _ in range(repeats):
        for k, fn in sides.items():
            times[k].append(median_s(fn, 1))
    if pool is not None:
        pool.shutdown()
    for k in ("native", "pil_pool", "pil_one"):
        out[f"{k}_images_per_s"] = (n / float(np.median(times[k]))
                                    if k in times else None)
    return out


def write_times(images: np.ndarray, count: int, work: Path,
                repeats: int) -> dict:
    """Seconds to write ``count`` PNGs with each writer."""
    u8 = np.ascontiguousarray(np.resize(images, (count,) + images.shape[1:]))
    dirs = {k: work / f"write_{k}_{count}" for k in ("native", "imaging")}

    def paths(k):
        return [str(dirs[k] / f"sample-{i:06d}.png") for i in range(count)]

    def run(k):
        shutil.rmtree(dirs[k], ignore_errors=True)
        dirs[k].mkdir(parents=True)
        if k == "imaging":
            imaging.write_png_batch(paths(k), u8)
        elif not native.write_png_batch(paths(k), u8):
            raise RuntimeError(f"native writer unavailable: "
                               f"{native.build_error()}")

    times = {k: [] for k in dirs}
    for _ in range(repeats):
        for k in dirs:
            times[k].append(median_s(lambda: run(k), 1))
    for i in (0, count // 2, count - 1):
        a, b = (imaging.decode_png(Path(paths(k)[i]).read_bytes())
                for k in dirs)
        if not (np.array_equal(a, b) and np.array_equal(a, u8[i])):
            raise AssertionError(f"the writers' PNG {i} differ")
    out = {"count": count}
    for k in dirs:
        out[f"{k}_s"] = float(np.median(times[k]))
        shutil.rmtree(dirs[k])
    return out


def main(files: int = 512, batch: int = 128, repeats: int = 5,
         writes=(128, 10000)) -> dict:
    if not native.native_available():
        raise RuntimeError(f"the native library did not build:\n"
                           f"{native.build_error()}")
    smi = card()
    print(smi)
    good = sorted(str(p) for p in FIXTURES.glob("0*.jpg"))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        work = Path(tmp)
        names = []
        for i in range(files):
            dst = work / f"{i + 1:06d}.jpg"
            shutil.copyfile(good[i % len(good)], dst)
            names.append(str(dst))
        result = {"device": smi, "build_s": native.build_seconds(),
                  "decode": decode_rates(names, batch, repeats)}
        images = ImageFolderDataset(files=names, size=SIZE,
                                    center_crop=True).get_batch_u8(
                                        np.arange(min(files, batch)))[0]
        result["write"] = [write_times(images, n, work, repeats)
                           for n in writes]
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--files", type=int, default=512)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--writes", default="128,10000",
                   help="comma-separated PNG counts")
    a = p.parse_args()
    main(a.files, a.batch, a.repeats,
         tuple(int(n) for n in a.writes.split(",")))
