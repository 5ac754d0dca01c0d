"""Disentanglement metrics: DCI, TAD, latent-classification probes
(JAX counterpart: ``infodiffusion_tpu/metrics/disentanglement.py``, which
has no JAX in it either; reference: eval_disentanglement.py:88-363).

Offline metrics over [N, a_dim] latents, on the host in numpy / scipy.
TAD, the MI matrix and :func:`auroc` need nothing more. The learners stay
scikit-learn's, imported where they are fit (gradient boosted trees for
DCI, LogisticRegression / RandomForest for the probe): reimplementing them
would not reproduce sklearn's fits. Where scikit-learn is absent, which is
so on the card's machine, those two raise an ``ImportError`` that names
it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import scipy.stats


def _sklearn_missing(what: str, exc: ImportError) -> ImportError:
    return ImportError(
        f"{what} fits a scikit-learn model, and scikit-learn is not "
        f"installed ({exc}); TAD and the AUROC need none")


def auroc(y, score) -> float:
    """Area under the ROC curve of ``score`` against binary labels ``y``
    (the greater label positive), as the Mann-Whitney U statistic over
    midranks: equal to sklearn's ``roc_auc_score``, ties included. Raises
    when ``y`` holds one class."""
    y = np.asarray(y)
    score = np.asarray(score, np.float64)
    if y.min() == y.max():
        raise ValueError("AUROC is undefined when y holds one class")
    pos = y == y.max()
    n1 = float(pos.sum())
    n0 = float(len(y) - n1)
    ranks = scipy.stats.rankdata(score, method="average")
    return float((ranks[pos].sum() - n1 * (n1 + 1.0) / 2.0) / (n1 * n0))


# ---------------------------------------------------------------------------
# DCI (reference: eval_disentanglement.py:88-150, after disentanglement_lib)
# ---------------------------------------------------------------------------


def compute_importance_gbt(x_train, y_train, x_test, y_test):
    """Importance matrix [num_codes, num_factors] from gradient boosted
    trees, plus train/test accuracies. Inputs are [num_codes, N] /
    [num_factors, N] like the reference."""
    try:
        from sklearn.ensemble import GradientBoostingClassifier
    except ImportError as exc:
        raise _sklearn_missing("DCI", exc) from exc

    num_factors = y_train.shape[0]
    num_codes = x_train.shape[0]
    importance = np.zeros([num_codes, num_factors], dtype=np.float64)
    train_acc, test_acc = [], []
    for i in range(num_factors):
        model = GradientBoostingClassifier()
        model.fit(x_train.T, y_train[i, :])
        importance[:, i] = np.abs(model.feature_importances_)
        train_acc.append(np.mean(model.predict(x_train.T) == y_train[i, :]))
        test_acc.append(np.mean(model.predict(x_test.T) == y_test[i, :]))
    return importance, np.mean(train_acc), np.mean(test_acc)


def disentanglement_per_code(importance_matrix):
    return 1.0 - scipy.stats.entropy(
        importance_matrix.T + 1e-11, base=importance_matrix.shape[1]
    )


def disentanglement(importance_matrix):
    per_code = disentanglement_per_code(importance_matrix)
    if importance_matrix.sum() == 0.0:
        importance_matrix = np.ones_like(importance_matrix)
    code_importance = importance_matrix.sum(axis=1) / importance_matrix.sum()
    return np.sum(per_code * code_importance)


def completeness_per_factor(importance_matrix):
    return 1.0 - scipy.stats.entropy(
        importance_matrix + 1e-11, base=importance_matrix.shape[0]
    )


def completeness(importance_matrix):
    per_factor = completeness_per_factor(importance_matrix)
    if importance_matrix.sum() == 0.0:
        importance_matrix = np.ones_like(importance_matrix)
    factor_importance = importance_matrix.sum(axis=0) / importance_matrix.sum()
    return np.sum(per_factor * factor_importance)


def compute_dci(mus_train, ys_train, mus_test, ys_test) -> Dict:
    """DCI scores; inputs [num_codes, N] / [num_factors, N]."""
    importance, train_err, test_err = compute_importance_gbt(
        mus_train, ys_train, mus_test, ys_test
    )
    return {
        "informativeness_train": train_err,
        "informativeness_test": test_err,
        "importance": importance,
        "disentanglement": disentanglement(importance),
        "completeness": completeness(importance),
    }


# ---------------------------------------------------------------------------
# Latent-classification probe (reference: eval_disentanglement.py:153-212)
# ---------------------------------------------------------------------------


class PredMetric:
    """Per-attribute classifier probe: AUROC for binary ('b') targets,
    accuracy for categorical ('c')."""

    def __init__(self, predictor="RandomForest", output_type="b",
                 attr_names=None):
        try:
            from sklearn.ensemble import RandomForestClassifier
            from sklearn.linear_model import LogisticRegression
        except ImportError as exc:
            raise _sklearn_missing("PredMetric (the latent probe)",
                                   exc) from exc

        self.attr_names = attr_names
        self._predictor = predictor
        self.output_type = output_type
        if predictor == "Linear":
            self.predictor_class = LogisticRegression
            self.params = {}
            self.importances_attr = "coef_"
        elif predictor == "RandomForest":
            self.predictor_class = RandomForestClassifier
            self.importances_attr = "feature_importances_"
            self.params = {"oob_score": True}
        else:
            raise NotImplementedError(predictor)

    def evaluate(self, train_codes, train_attrs, test_codes, test_attrs):
        results = []
        for j in range(train_attrs.shape[-1]):
            tr_col, te_col = train_attrs[:, j], test_attrs[:, j]
            uniq = np.unique(tr_col)
            if len(uniq) < 2 or (
                self.output_type == "b" and len(np.unique(te_col)) < 2
            ):
                # degenerate attribute in this fold (single class):
                # LogisticRegression's predict_proba has one column and
                # AUROC is undefined — score it chance / majority like
                # TADMetric's constant-attr guard instead of crashing
                results.append(
                    0.5 if self.output_type == "b"
                    else float(np.mean(te_col == uniq[0]))
                )
                continue
            predictor = self.predictor_class(**self.params)
            predictor.fit(train_codes, tr_col)
            if self.output_type == "b":
                prob = predictor.predict_proba(test_codes)[:, 1]
                r = auroc(te_col, prob)
            else:
                pred = predictor.predict(test_codes)
                r = float(np.mean(pred == te_col))
            results.append(r)
        results = np.asarray(results)
        return {
            f"{self._predictor}_avg_result": results.mean(),
            f"{self._predictor}_result": results,
        }


# ---------------------------------------------------------------------------
# TAD (reference: eval_disentanglement.py:236-363, after NashAE)
# ---------------------------------------------------------------------------


def _binary_mi_matrix(y: np.ndarray) -> np.ndarray:
    """Pairwise MI between binary attribute columns, vectorized.

    mi[i,j] = sum over the four (F/T, F/T) joint cells of
    jp * log(jp / (p_i * p_j)), with 0 contribution when any prob is 0
    (reference: eval_disentanglement.py:323-355)."""
    y = y.astype(np.float64)
    n, d = y.shape
    ny = 1.0 - y
    p1 = y.mean(axis=0)
    p0 = 1.0 - p1

    def cell(a, b, pa, pb):
        jp = (a.T @ b) / n  # [d, d]
        with np.errstate(divide="ignore", invalid="ignore"):
            term = jp * np.log(jp / np.outer(pa, pb))
        term[~np.isfinite(term)] = 0.0
        return term

    mi = (
        cell(ny, ny, p0, p0)
        + cell(ny, y, p0, p1)
        + cell(y, ny, p1, p0)
        + cell(y, y, p1, p1)
    )
    return mi


class TADMetric:
    """Total AUROC Difference: per attribute, the margin between the best
    and second-best single-latent detector, summed over attributes whose
    best AUROC >= 0.75 and whose label is sufficiently *distinct* (its
    entropy reduction from the most-informative other label <= 0.2)."""

    def __init__(self, y_dim: int, all_attrs: Optional[Sequence[str]] = None):
        self.y_dim = y_dim
        self.all_attrs = all_attrs

    def aurocs_search(self, a: np.ndarray, y: np.ndarray) -> np.ndarray:
        """[y_dim, a_dim] best-of-both-signs AUROC grid
        (reference: eval_disentanglement.py:285-297), vectorized.

        AUROC of a score column against a binary label IS the
        Mann-Whitney U statistic over midranks (ties averaged — exactly
        sklearn's trapezoidal ROC value), so the whole grid is ONE
        rankdata per latent column plus ONE [y_dim, n] @ [n, a_dim]
        matmul: auroc[i, j] = (sum of positive-row ranks − n1(n1+1)/2)
        / (n1 * n0). This replaces the reference's per-pair sklearn
        loop — 40 × 256 = 10,240 roc_auc_score calls per fold on the
        celeba protocol. Held equal to the JAX package's sklearn loop in
        tests/test_torch_metrics.py."""
        a = np.asarray(a, np.float64)
        y = np.asarray(y)
        n = a.shape[0]
        y_dim = y.shape[1]
        ranks = scipy.stats.rankdata(a, method="average", axis=0)  # [n, A]
        # positive class = the greater label (sklearn's convention for
        # binary labels); constant columns are degenerate -> 0.5
        col_max = y.max(axis=0)
        valid = col_max != y.min(axis=0)
        pos = (y == col_max[None, :]).astype(np.float64)  # [n, y_dim]
        n1 = pos.sum(axis=0)
        n0 = n - n1
        r1 = pos.T @ ranks  # [y_dim, a_dim] sum of positive-row ranks
        denom = np.where(valid, n1 * n0, 1.0)
        auc = (r1 - (n1 * (n1 + 1.0) / 2.0)[:, None]) / denom[:, None]
        out = np.maximum(auc, 1.0 - auc)  # == max(auroc(a), auroc(-a))
        out[~valid] = 0.5
        assert out.shape == (y_dim, a.shape[1])
        return out

    def evaluate(self, a: np.ndarray, y: np.ndarray):
        auroc = self.aurocs_search(np.asarray(a), np.asarray(y))
        dim_y = y.shape[1]

        order = np.argsort(auroc, axis=1)
        max_aur = auroc[np.arange(dim_y), order[:, -1]]
        second = auroc[np.arange(dim_y), order[:, -2]] if auroc.shape[1] > 1 \
            else np.zeros(dim_y)
        aurs_diffs = max_aur - second

        mi = _binary_mi_matrix(np.asarray(y))
        off = mi * (1.0 - np.eye(dim_y))
        mi_maxes = off.max(axis=1)
        diag = np.diag(mi)
        with np.errstate(divide="ignore", invalid="ignore"):
            ent_red = 1.0 - (diag - mi_maxes) / diag
        ent_red[~np.isfinite(ent_red)] = 1.0

        thresh, ent_red_thresh = 0.75, 0.2
        keep = (max_aur >= thresh) & (ent_red <= ent_red_thresh)
        tad_score = float(aurs_diffs[keep].sum())
        return tad_score, auroc, int(keep.sum())
