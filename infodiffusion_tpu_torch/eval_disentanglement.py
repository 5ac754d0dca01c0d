"""Standalone disentanglement-eval CLI (JAX counterpart:
``infodiffusion_tpu/eval_disentanglement.py``; reference:
eval_disentanglement.py).

    python -m infodiffusion_tpu_torch.eval_disentanglement --model diff \
        --prior regular --dataset celeba --a_dim 256

Loads the ``{model}_{exp}_latent.npz`` written by save_latent mode, runs
5-fold evaluation with StandardScaler, and prints TAD (celeba), DCI
(3dshapes, dsprites) and linear-probe accuracy, mean ± std — the same
protocol and output format as the reference
(eval_disentanglement.py:365-476). A host tool: it touches no device.
KFold and StandardScaler are numpy copies of scikit-learn's (the same
folds index for index, the same arithmetic); DCI and the linear probe fit
scikit-learn models and raise without it, TAD needs none.

Reference quirk NOT preserved: the reference hardcodes
``dataset = "celeba"`` at module top, silently ignoring ``--dataset``
(eval_disentanglement.py:366). Here --dataset is honored; passing
celeba reproduces the reference behavior exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from infodiffusion_tpu_torch.cli import build_parser
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.metrics import PredMetric, TADMetric, compute_dci

CELEBA_ATTRS = [
    "5_o_Clock_Shadow", "Arched_Eyebrows", "Attractive", "Bags_Under_Eyes",
    "Bald", "Bangs", "Big_Lips", "Big_Nose", "Black_Hair", "Blond_Hair",
    "Blurry", "Brown_Hair", "Bushy_Eyebrows", "Chubby", "Double_Chin",
    "Eyeglasses", "Goatee", "Gray_Hair", "Heavy_Makeup", "High_Cheekbones",
    "Male", "Mouth_Slightly_Open", "Mustache", "Narrow_Eyes", "No_Beard",
    "Oval_Face", "Pale_Skin", "Pointy_Nose", "Receding_Hairline",
    "Rosy_Cheeks", "Sideburns", "Smiling", "Straight_Hair", "Wavy_Hair",
    "Wearing_Earrings", "Wearing_Hat", "Wearing_Lipstick",
    "Wearing_Necklace", "Wearing_Necktie", "Young",
]

ATTR_TABLES = {
    "celeba": (CELEBA_ATTRS, "b"),
    "fmnist": (["Class"], "c"),
    "cifar10": (["Class"], "c"),
    "mnist": (["Class"], "c"),
    "ffhq": (["Age", "Gender", "Glass"], "c"),
    "3dshapes": (
        ["Floor hue", "Wall hue", "Object hue:", "Scale", "Shape",
         "Orientation"],
        "c",
    ),
    # dsprites' color factor is constant (always white): it carries no
    # information and crashes the per-factor GBT, so the eval drops it
    # (load_latents) and the names table matches
    "dsprites": (
        ["Shape", "Scale", "Orientation", "PosX", "PosY"], "c"
    ),
}


def kfold_splits(n: int, n_splits: int = 5, seed: int = 0):
    """scikit-learn's ``KFold(n_splits, shuffle=True, random_state=seed)``
    splits of ``range(n)``: the indices shuffled by
    ``RandomState(seed)``, cut into folds of ``n // n_splits`` (the first
    ``n % n_splits`` one longer); each (train, test) pair in ascending
    order."""
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[idx[start:start + size]] = True
        start += size
        yield np.arange(n)[~test], np.arange(n)[test]


class StandardScaler:
    """scikit-learn's ``StandardScaler`` (mean and ddof-0 std; a feature
    whose variance is zero to rounding keeps scale 1), with its arithmetic
    (scikit-learn 1.9): float64 sums of a float32 input, and a transform in
    the input's dtype with the mean and scale cast to it."""

    def fit(self, x):
        x = np.asarray(x)
        n = x.shape[0]
        self.mean_ = np.sum(x, axis=0, dtype=np.float64) / n
        temp = x - self.mean_
        correction = np.sum(temp, axis=0, dtype=np.float64)
        var = (np.sum(temp ** 2, axis=0, dtype=np.float64)
               - correction ** 2 / n) / n
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * self.mean_ * eps) ** 2
        self.var_ = var
        self.scale_ = np.where(constant, 1.0, np.sqrt(var))
        return self

    def transform(self, x):
        x = np.array(x, dtype=np.result_type(np.asarray(x).dtype,
                                             np.float32), copy=True)
        x -= self.mean_.astype(x.dtype)
        x /= self.scale_.astype(x.dtype)
        return x


def load_latents(cfg: Config, dataset: str, npz_path: Optional[str] = None):
    """(a, y) with the reference's per-dataset slicing/label transforms
    (eval_disentanglement.py:394-417)."""
    from infodiffusion_tpu_torch.runner import latent_npz_path

    path = npz_path or latent_npz_path(cfg)
    data = np.load(path, allow_pickle=True)
    all_a, all_attr = data["all_a"], data["all_attr"]
    if all_attr.dtype.kind not in "biuf":
        # save_latent writes the string 'No Attributes' for label-less
        # datasets (chairs, ffhq without ffhq_labels.csv) — fail with a
        # real explanation instead of astype/indexing errors downstream
        raise ValueError(
            f"{path} carries no usable labels (all_attr dtype "
            f"{all_attr.dtype}): the dataset it was encoded from has no "
            "attributes, and the disentanglement protocol needs labeled "
            "latents (celeba / dsprites / mnist / fmnist / cifar10, or "
            "ffhq with ffhq_labels.csv)"
        )
    if dataset == "celeba":
        a = all_a[:10000, :]
        y = all_attr[:10000, :].astype(np.int64)
    elif dataset == "3dshapes":
        a = all_a[:10000, :]
        y = all_attr[:10000, :].astype(np.float64)
        y[:, 0] *= 10
        y[:, 1] *= 10
        y[:, 2] *= 10
        y[:, 3] = y[:, 3] * 14 - 10.5
        y[:, 5] = y[:, 5] * 14 / 60 + 7
        y = y.astype(np.int64)
    elif dataset == "dsprites":
        # attrs ride along as [6 latents_values | 6 latents_classes]
        # (data.py loader); DCI wants the discrete classes, minus the
        # constant color factor (see ATTR_TABLES note). Capped at 10k
        # rows like celeba/3dshapes — the real dataset has 737k and the
        # per-factor GBT protocol is intractable on all of them.
        a = all_a[:10000, :]
        y = all_attr[:10000, 7:].astype(np.int64)
    elif dataset == "ffhq":
        # reference reads labels from ffhq_labels.csv (columns 2+, first
        # 69952 rows; eval_disentanglement.py:397-401)
        import os

        a = all_a[:, :]
        if os.path.exists("ffhq_labels.csv"):
            import pandas as pd

            y = pd.read_csv("ffhq_labels.csv").values[:, 2:].astype(np.int64)
            n = min(len(a), len(y), 69952)
            a, y = a[:n], y[:n]
        else:
            y = all_attr if all_attr.ndim == 2 else all_attr[:, None]
            y = y.astype(np.int64)
    else:
        a = all_a
        y = all_attr if all_attr.ndim == 2 else all_attr[:, None]
        y = y.astype(np.int64)
    return a, y


def evaluate_latents(a, y, dataset: str, verbose: bool = True):
    """5-fold TAD/DCI/linear-probe protocol
    (reference: eval_disentanglement.py:419-476)."""
    y_names, output_type = ATTR_TABLES.get(dataset, (["Class"], "c"))
    tad_scores, tad_attrs, dci_scores = [], [], []
    avg_preds_ln, preds_ln = [], []

    for tr_idx, te_idx in kfold_splits(len(a)):
        tr_a, te_a = a[tr_idx], a[te_idx]
        tr_y, te_y = y[tr_idx], y[te_idx]
        std = StandardScaler().fit(tr_a)
        tr_a, te_a = std.transform(tr_a), std.transform(te_a)

        if dataset == "celeba":
            tad = TADMetric(y.shape[1], y_names)
            score, _auroc, num_attr = tad.evaluate(tr_a, tr_y)
            if verbose:
                print("TAD SCORE: ", score, "Attributes Captured: ", num_attr)
            tad_scores.append(score)
            tad_attrs.append(num_attr)
        if dataset in ("3dshapes", "dsprites"):
            dci = compute_dci(tr_a.T, tr_y.T, te_a.T, te_y.T)
            if verbose:
                print("DCI Score", dci["disentanglement"])
            dci_scores.append(dci["disentanglement"])

        pred = PredMetric("Linear", output_type, y_names)
        res = pred.evaluate(tr_a, tr_y, te_a, te_y)
        if verbose:
            print("Avg Result", res["Linear_avg_result"])
        avg_preds_ln.append(res["Linear_avg_result"])
        preds_ln.append(res["Linear_result"])

    out = {}
    if dci_scores:
        dci_scores = np.asarray(dci_scores)
        if verbose:
            print("DCI Score, {:.4f} \\pm {:.4f}".format(
                dci_scores.mean(), dci_scores.std()))
        out["dci"] = (dci_scores.mean(), dci_scores.std())
    if tad_scores:
        tad_scores = np.asarray(tad_scores)
        tad_attrs = np.asarray(tad_attrs)
        if verbose:
            print("TAD Score, {:.4f} \\pm {:.4f}".format(
                tad_scores.mean(), tad_scores.std()))
            print("TAD Attr, {:.4f} \\pm {:.4f}".format(
                tad_attrs.mean(), tad_attrs.std()))
        out["tad"] = (tad_scores.mean(), tad_scores.std())
        out["tad_attrs"] = (tad_attrs.mean(), tad_attrs.std())
    avg_preds_ln = np.asarray(avg_preds_ln)
    if verbose:
        print("Avg Acc (Linear), {:.4f} \\pm {:.4f}".format(
            avg_preds_ln.mean(), avg_preds_ln.std()))
    out["linear_probe"] = (avg_preds_ln.mean(), avg_preds_ln.std())
    preds_ln = np.vstack(preds_ln)
    if verbose:
        for a_idx in range(preds_ln.shape[1]):
            print(
                "Acc for {} (Linear), {:.4f} \\pm {:.4f}".format(
                    y_names[a_idx] if a_idx < len(y_names) else a_idx,
                    preds_ln[:, a_idx].mean(), preds_ln[:, a_idx].std(),
                )
            )
    return out


def main(argv: Optional[Sequence[str]] = None):
    parser = build_parser(require_mode=False)
    # this tool additionally evaluates 3dshapes latents (label transforms
    # above, reference: eval_disentanglement.py:404-411) even though the
    # training CLI has no 3dshapes data loader — widen the choices
    for act in parser._actions:
        if act.dest == "dataset" and act.choices is not None \
                and "3dshapes" not in act.choices:
            act.choices = tuple(act.choices) + ("3dshapes",)
    args = parser.parse_args(argv)
    if args.dataset == "3dshapes":
        # Config validates against the TRAINING datasets; 3dshapes
        # latents come from elsewhere and exist only for this tool.
        # Build past validation, then restore the name (it only feeds
        # the npz filename and the label-transform dispatch).
        d = {**vars(args), "dataset": "celeba"}
        cfg = Config(**d)
        cfg.dataset = "3dshapes"
    else:
        cfg = Config(**vars(args))
    a, y = load_latents(cfg, cfg.dataset)
    return evaluate_latents(a, y, cfg.dataset)


if __name__ == "__main__":
    main()
