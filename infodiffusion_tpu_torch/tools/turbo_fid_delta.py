"""The FID of the bf16 tier against the int8 turbo tier on one trained
model: a quantization bias that FID would see shows here.

    python -m infodiffusion_tpu_torch.tools.turbo_fid_delta [--device cpu]

The JAX package's ``tools/turbo_fid_delta.py`` steps, through the port's
command line (``python -m infodiffusion_tpu_torch``, run in this process:
``tools.run_cli``) at the flagship's width on synthetic celeba:

1. train the InfoDiff (a_dim 32, mmd 0.1, bf16, B=128);
2. save_latent, then train_latent_ddim (the latent prior);
3. ``eval_fid --is_latent`` twice with identical seeds,
   ``INFODIFF_TURBO=""`` and then ``int8`` (only the conv tier differs);
4. score both sample sets with the port's ``metrics/fid.py`` against
   rendered images of the training distribution (disjoint draws), beside
   the real-vs-real floor (two disjoint rendered halves).

Prints ONE JSON line: ``fid_bf16``, ``fid_int8``, ``delta``,
``real_floor``, ``delta_vs_bf16_pct``, ``n_samples``, ``extractor`` (what
scored: the random-conv fallback, an Inception checkpoint that is not the
canonical release, e.g. a fixture, or ``pt_inception``) and ``verdict``
(``tier_verdict``). Scores from the random-conv fallback are only
comparable with each other, which is what a tier delta needs.

Knobs (the JAX tool's): INFODIFF_TFD_DIR (work directory; default a new
one under the current directory), INFODIFF_TFD_EPOCHS (300, both models:
the command line loads each at ``model-{epochs}``, so the JAX tool's
INFODIFF_TFD_LATENT_EPOCHS, which it reads and never passes on, is not
read), INFODIFF_TFD_SAMPLES (2048), INFODIFF_TFD_REAL_N (4096),
INFODIFF_TFD_SKIP_TRAIN=1 (reuse the work directory's checkpoints);
INFODIFF_SYNTHETIC_N (2048) sizes the training set.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np

from infodiffusion_tpu_torch.tools import (
    env_set,
    in_directory,
    resolve_device,
    run_cli,
)

SIZE = 64
COMMON = ["--model", "diff", "--prior", "regular", "--dataset", "celeba",
          "--a_dim", "32", "--data_dir", "synthetic",
          "--diffusion_steps", "1000", "--batch_size", "128",
          "--r_seed", "64", "--mmd_weight", "0.1", "--bf16"]


def tier_verdict(delta: float, fid_bf16: float, floor: float) -> str:
    """Invariant when the tier delta sits within 3% of the bf16 score or
    within 10x the real-vs-real floor (the floor of the random-conv
    fallback is ~0, so the relative bound is the one that acts there)."""
    noise = max(abs(floor), 1e-6)
    return ("fid_invariant" if delta <= max(0.03 * fid_bf16, 10.0 * noise)
            else "fid_divergent")


def dump_real_halves(work: str, n: int, size: int = SIZE):
    """Render 2n synthetic celeba images (the training distribution,
    other draws) into two PNG folders."""
    from infodiffusion_tpu_torch.data.datasets import _render_celeba
    from infodiffusion_tpu_torch.imaging import write_png_batch

    ds = _render_celeba(2 * n, size, np.random.RandomState(1234))
    dirs = [os.path.join(work, d) for d in ("real_a", "real_b")]
    for h, d in enumerate(dirs):
        os.makedirs(d, exist_ok=True)
        write_png_batch([os.path.join(d, f"real-{i:06d}.png")
                         for i in range(h * n, (h + 1) * n)],
                        ds.images[h * n:(h + 1) * n])
    return dirs


def extractor_name(tag: str) -> str:
    """What scored: the random-conv fallback, a non-canonical Inception
    checkpoint (a fixture stands in for the real weights), or the
    canonical ``pt_inception``."""
    from infodiffusion_tpu_torch.metrics import inception as inc
    from infodiffusion_tpu_torch.tools.verify_inception_weights import (
        file_sha256,
    )

    if not tag.startswith("inception"):
        return f"random-conv fallback ({tag})"
    path = inc.default_weights_path()
    if file_sha256(path).startswith(inc.CANONICAL_SHA256_PREFIX):
        return "pt_inception"
    return f"Inception from {os.path.basename(path)} (not the canonical " \
           f"release bytes, e.g. a fixture)"


def main(device: Optional[str] = None) -> Dict:
    dev = resolve_device(device)
    cpu_env = {"INFODIFF_FORCE_CPU": "1"} if dev.type == "cpu" else {}
    work = os.path.abspath(os.environ.get("INFODIFF_TFD_DIR") or
                           tempfile.mkdtemp(prefix="turbo_fid_", dir="."))
    epochs = os.environ.get("INFODIFF_TFD_EPOCHS", "300")
    n_samples = int(os.environ.get("INFODIFF_TFD_SAMPLES", "2048"))
    real_n = int(os.environ.get("INFODIFF_TFD_REAL_N", "4096"))
    env = {"INFODIFF_SYNTHETIC_N": os.environ.get("INFODIFF_SYNTHETIC_N",
                                                  "2048"), **cpu_env}
    print(json.dumps({"workdir": work, "device": str(dev)}), flush=True)
    with in_directory(work):
        if os.environ.get("INFODIFF_TFD_SKIP_TRAIN") != "1":
            run_cli([*COMMON, "-e", epochs, "--mode", "train",
                     "--save_epochs", epochs], env)
            run_cli([*COMMON, "-e", epochs, "--mode", "save_latent"], env)
            run_cli([*COMMON, "-e", epochs, "--mode", "train_latent_ddim",
                     "--save_epochs", epochs], env)
        img_dirs = {}
        for tier, name in (("", "bf16"), ("int8", "int8")):
            folder = os.path.join(work, f"imgs_{name}")
            run_cli([*COMMON, "-e", epochs, "--mode", "eval_fid",
                     "--is_latent", "--deterministic",
                     "--sampling_steps", "100",
                     "--sampling_number", str(n_samples),
                     "--img_folder", folder],
                    {**env, "INFODIFF_TURBO": tier})
            # eval_fid writes under <img_folder>/<exp>/eval-fid-latent
            hits = [root for root, _dirs, files in os.walk(folder)
                    if root.endswith("eval-fid-latent") and files]
            if len(hits) != 1:
                raise RuntimeError(f"eval_fid wrote {hits} under {folder}")
            img_dirs[name] = hits[0]

        from infodiffusion_tpu_torch.metrics.fid import (
            compute_fid,
            make_custom_stats,
        )

        real_a, real_b = dump_real_halves(work, real_n // 2)
        with env_set(cpu_env):
            stats = make_custom_stats("tfd_real", real_a, res=SIZE)
            kw = dict(dataset_name="tfd_real", dataset_res=SIZE,
                      num_gen=n_samples)
            floor = compute_fid(real_b, **kw)
            fid_bf16 = compute_fid(img_dirs["bf16"], **kw)
            fid_int8 = compute_fid(img_dirs["int8"], **kw)
            tag = str(np.load(stats, allow_pickle=True)["extractor"])
    delta = abs(fid_int8 - fid_bf16)
    rec = {
        "fid_bf16": float(fid_bf16), "fid_int8": float(fid_int8),
        "delta": float(delta), "real_floor": float(floor),
        "delta_vs_bf16_pct": 100.0 * delta / max(fid_bf16, 1e-9),
        "n_samples": n_samples, "extractor": extractor_name(tag),
        "device": str(dev),
        "verdict": tier_verdict(delta, fid_bf16, floor),
    }
    print(json.dumps(rec), flush=True)
    with open(os.path.join(work, "turbo_fid_delta.json"), "w") as f:
        json.dump(rec, f)
    return rec


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    main(parser.parse_args().device)
