"""Representation learning end to end on rendered synthetic dsprites: train
an MMD-InfoDiff through the port's command line, encode the dataset with
``save_latent``, and ridge-probe the aux latents against the ground-truth
factors.

    python -m infodiffusion_tpu_torch.tools.repr_learning_demo [workdir]
        [--epochs 150] [--device cpu]

The JAX package's ``tools/repr_learning_demo.py`` steps, through
``python -m infodiffusion_tpu_torch`` (run in this process:
``tools.run_cli``), 2,048 sprites (``INFODIFF_SYNTHETIC_N``):

1. ``--mode train`` and ``--mode save_latent`` (a_dim 8, T 50, B 64);
2. the 5-fold protocol of ``eval_disentanglement`` (DCI and the linear
   probes) where scikit-learn imports; elsewhere one line names the step
   as skipped;
3. the result: per factor, the R^2 of a ridge regression (alpha 1.0, with
   an intercept) from the latents, fitted on 70% and scored on the other
   30%: the split of scikit-learn's ``train_test_split(test_size=0.3,
   random_state=0)`` and the closed-form fit, both in numpy
   (:func:`train_test_split`, :func:`ridge_r2`), so the probe needs no
   scikit-learn. A factor the renderer leaves constant is skipped.

Prints JSON lines, the last the probe's.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

from infodiffusion_tpu_torch.tools import (
    env_set,
    in_directory,
    resolve_device,
    run_cli,
)

COMMON = ["--model", "diff", "--prior", "regular", "--dataset", "dsprites",
          "--a_dim", "8", "--data_dir", "synthetic", "--diffusion_steps", "50",
          "--batch_size", "64", "--r_seed", "3"]
FACTORS = ("color", "shape", "scale", "orient", "posX", "posY")
LATENTS = "diff_dsprites_8d_0_1mmd_latent.npz"


def train_test_split(x: np.ndarray, y: np.ndarray, test_size: float = 0.3,
                     random_state: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """(x_train, x_test, y_train, y_test) as scikit-learn's
    ``train_test_split`` draws them: the first ceil(test_size * n) of a
    ``RandomState(random_state)`` permutation are the test rows."""
    n = len(x)
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    return x[train], x[test], y[train], y[test]


def ridge_fit(x: np.ndarray, y: np.ndarray, alpha: float = 1.0):
    """(w, b) of ridge regression with an unpenalized intercept: the
    centred normal equations (XcᵀXc + alpha I) w = Xcᵀ yc, in f64."""
    x, y = x.astype(np.float64), y.astype(np.float64)
    xm, ym = x.mean(0), y.mean()
    xc = x - xm
    w = np.linalg.solve(xc.T @ xc + alpha * np.eye(x.shape[1]),
                        xc.T @ (y - ym))
    return w, ym - xm @ w


def ridge_r2(x_train, y_train, x_test, y_test, alpha: float = 1.0) -> float:
    """R^2 on the test rows of the ridge fit on the train rows."""
    w, b = ridge_fit(x_train, y_train, alpha)
    pred = x_test.astype(np.float64) @ w + b
    y = y_test.astype(np.float64)
    return float(1.0 - ((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum())


def probe(a: np.ndarray, attr: np.ndarray) -> Dict[str, float]:
    """Ridge R^2 per factor that varies."""
    out = {}
    for i, name in enumerate(FACTORS):
        y = attr[:, i]
        if np.std(y) < 1e-9:
            continue
        xtr, xte, ytr, yte = train_test_split(a, y)
        out[name] = ridge_r2(xtr, ytr, xte, yte)
    return out


def main(argv=None, device: Optional[str] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("workdir", nargs="?", default=None)
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--device", default=device,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    work = os.path.abspath(args.workdir or tempfile.mkdtemp(
        prefix="infodiff_repr_", dir="."))
    env = {"INFODIFF_SYNTHETIC_N": os.environ.get("INFODIFF_SYNTHETIC_N",
                                                  "2048")}
    if dev.type == "cpu":
        env["INFODIFF_FORCE_CPU"] = "1"
    flags = [*COMMON, "-e", str(args.epochs)]
    print(json.dumps({"workdir": work, "device": str(dev)}), flush=True)
    with in_directory(work):
        run_cli([*flags, "--mode", "train", "--save_epochs",
                 str(args.epochs)], env)
        run_cli([*flags, "--mode", "save_latent"], env)
        try:
            import sklearn  # noqa: F401
        except ImportError:
            print(json.dumps({"step": "eval_disentanglement (5-fold DCI "
                              "and linear probes)", "skipped": "scikit-learn "
                              "is not installed; the ridge probe below is "
                              "the result"}), flush=True)
        else:
            from infodiffusion_tpu_torch import eval_disentanglement

            with env_set(env):
                eval_disentanglement.main([*flags, "--mode", "save_latent"])
        f = np.load(LATENTS)
        a, attr = f["all_a"], f["all_attr"]
    out = {"latents": list(a.shape), "ridge_r2": probe(a, attr),
           "device": str(dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
