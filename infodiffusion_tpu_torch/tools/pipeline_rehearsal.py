"""Input-pipeline rehearsal at CelebA scale: whether host JPEG decode keeps
the card's Encoder fed during ``save_latent``.

    python -m infodiffusion_tpu_torch.tools.pipeline_rehearsal --n 200000
        [--dir DIR] [--decode-limit 50000] [--encode-limit 20000]
        [--skip-e2e] [--device cpu]

1. corpus: N JPEGs at CelebA's 178x218 geometry, quality 85, with the JAX
   package's generator (``tools/pipeline_rehearsal.py``): gradient
   canvases, texture and rectangles, so the files land in the real
   corpus' size range. PIL writes them (without PIL the tool raises a
   named ImportError); files that exist are kept, so a run resumes.
2. decode: ``ImageFolderDataset`` (D2C crop, resize 64: the CelebA
   save_latent transform) through the native batcher
   (``data/native.py``: libjpeg, or nvJPEG on the card's machine), and
   the explicit PIL path (``INFODIFF_DISABLE_NATIVE=1``) on 512 files for
   the comparison row.
3. end to end: the prefetching ``DataLoader`` feeding the flagship
   Encoder (bf16, its initializers' weights) on the card, and the
   Encoder alone on one resident batch.

The verdict divides the device's encode rate by the decode rate per host
core (the native rate over this machine's cores): the cores decode needs
to keep up, against the cores this machine has. Every rate is on the host
clock, synchronised with the card on both ends. Prints JSON lines, the
last prefixed ``VERDICT``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from infodiffusion_tpu_torch.data import native
from infodiffusion_tpu_torch.data.datasets import ImageFolderDataset
from infodiffusion_tpu_torch.data.loader import DataLoader
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.tools import (
    env_set,
    flagship_config,
    resolve_device,
    synchronize,
)
from infodiffusion_tpu_torch.train.step import make_eval_encode_step

PIL_ROW = 512  # files of the PIL comparison row


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("pipeline_rehearsal writes its JPEG corpus with "
                          "PIL (pillow), which is not installed") from exc
    return Image


def generate_corpus(root: str, n: int, seed: int = 0) -> List[str]:
    """Synthesize a CelebA-geometry JPEG corpus (178x218, quality 85), the
    bytes of the JAX tool's ``generate_corpus`` for the same seed."""
    Image = _pil_image()
    os.makedirs(root, exist_ok=True)
    W, H = 178, 218
    rng = np.random.RandomState(seed)
    # a bank of 256 base canvases; each file varies one cheaply
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    bases = []
    for _ in range(256):
        g = (
            rng.rand() * xx / W + rng.rand() * yy / H
            + 0.3 * np.sin(xx / rng.uniform(8, 40))
            * np.cos(yy / rng.uniform(8, 40))
        )
        img = np.stack([g * rng.uniform(0.5, 1.0) for _ in range(3)], -1)
        img = (img - img.min()) / max(float(np.ptp(img)), 1e-6)
        # photo-like texture: real align_celeba files are ~8 KB
        img = img * 200 + 20 + rng.randn(H, W, 3) * 6
        bases.append(np.clip(img, 0, 255).astype(np.uint8))
    paths = []
    t0 = time.perf_counter()
    made = 0
    for i in range(n):
        p = os.path.join(root, f"{i:06d}.jpg")
        paths.append(p)
        if os.path.exists(p):
            continue
        arr = bases[i % 256].copy()
        r = np.random.RandomState(seed * 1000003 + i)
        for _ in range(4):  # face-ish rectangles around the D2C window
            x0 = r.randint(30, 120)
            y0 = r.randint(60, 160)
            w, h = r.randint(12, 50), r.randint(12, 50)
            arr[y0: y0 + h, x0: x0 + w] = r.randint(0, 255, size=3)
        Image.fromarray(arr).save(p, quality=85)
        made += 1
    if made:
        print(json.dumps({"generated": made, "seconds":
                          time.perf_counter() - t0}), flush=True)
    return paths


def _decode_rate(paths, n: int, batch: int) -> float:
    ds = ImageFolderDataset(paths, size=64, d2c=True)
    ds.get_batch(np.arange(min(batch, n)))  # the library, the file cache
    t0 = time.perf_counter()
    for b in range(0, n, batch):
        ds.get_batch(np.arange(b, min(b + batch, n)))
    return n / (time.perf_counter() - t0)


def measure_decode(paths, limit: int, batch: int = 256) -> Dict:
    """Decode rate through the native batcher, and through the explicit
    PIL path on ``PIL_ROW`` files."""
    n = min(limit, len(paths)) // batch * batch
    if not n:
        raise ValueError(f"--decode-limit {limit} holds no batch of {batch}")
    if not native.native_available():
        raise RuntimeError(f"the native image library is unavailable:\n"
                           f"{native.build_error()}")
    pil_before = native.counts["pil"]
    rate = _decode_rate(paths, n, batch)
    if native.counts["pil"] != pil_before:
        raise RuntimeError(f"the native batcher left "
                           f"{native.counts['pil'] - pil_before} files to PIL")
    m = min(PIL_ROW, n)
    with env_set({"INFODIFF_DISABLE_NATIVE": "1"}):  # the explicit PIL path
        pil_rate = _decode_rate(paths, m, m)
    cores = os.cpu_count() or 1
    return {"native_backend": native.backend(), "decode_imgs": n,
            "native_decode_imgs_per_sec": rate,
            "host_cores": cores,
            "native_decode_imgs_per_sec_per_core": rate / cores,
            "pil_decode_imgs": m, "pil_decode_imgs_per_sec": pil_rate}


def measure_e2e(paths, limit: int, device: torch.device,
                batch: int = 256) -> Dict:
    """save_latent end to end: the prefetching DataLoader (native decode on
    its producer thread) feeding the flagship Encoder; and the Encoder
    alone on one resident batch (the device's encode rate)."""
    n = min(limit, len(paths)) // batch * batch
    if not n:
        raise ValueError(f"--encode-limit {limit} holds no batch of {batch}")
    torch.manual_seed(0)
    net = build_model(flagship_config(64), dtype=torch.bfloat16,
                      device=device).eval()
    enc = make_eval_encode_step(net)
    x0 = torch.zeros(batch, 64, 64, 3, device=device)
    enc(x0)  # cuDNN plans outside the timed loops
    synchronize(device)
    reps = max(1, n // batch)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = enc(x0)
    synchronize(device)
    encode_rate = reps * batch / (time.perf_counter() - t0)
    loader = DataLoader(ImageFolderDataset(paths[:n], size=64, d2c=True),
                        batch, device=device, prefetch=4)
    total = 0
    synchronize(device)
    t0 = time.perf_counter()
    for x in loader:
        out = enc(x)
        total += x.shape[0]
    synchronize(device)
    rate = total / (time.perf_counter() - t0)
    if not torch.isfinite(out).all():
        raise AssertionError("the Encoder gave non-finite latents")
    return {"e2e_imgs": total, "save_latent_e2e_imgs_per_sec": rate,
            "device_encode_imgs_per_sec": encode_rate,
            "device": str(device)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--dir", default="rehearsal_jpegs")
    ap.add_argument("--decode-limit", type=int, default=50_000)
    ap.add_argument("--encode-limit", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--skip-e2e", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    paths = generate_corpus(args.dir, args.n)
    sizes = [os.path.getsize(p) for p in paths[:2000]]
    print(json.dumps({"corpus_files": len(paths), "dir": args.dir,
                      "mean_jpeg_kb": float(np.mean(sizes)) / 1024}),
          flush=True)
    dec = measure_decode(paths, args.decode_limit, args.batch)
    print(json.dumps(dec), flush=True)
    e2e = {}
    if not args.skip_e2e:
        e2e = measure_e2e(paths, args.encode_limit, device, args.batch)
        print(json.dumps(e2e), flush=True)
    per_core = dec["native_decode_imgs_per_sec_per_core"]
    encode_rate = e2e.get("device_encode_imgs_per_sec")
    cores_needed = encode_rate / per_core if encode_rate else None
    verdict = {
        "corpus_files": len(paths),
        "mean_jpeg_kb": float(np.mean(sizes)) / 1024,
        **dec, **e2e,
        "cores_for_compute_bound": cores_needed,
        "decode_keeps_up": (None if cores_needed is None
                            else cores_needed <= dec["host_cores"]),
    }
    print("VERDICT " + json.dumps(verdict), flush=True)
    return verdict


if __name__ == "__main__":
    main()
