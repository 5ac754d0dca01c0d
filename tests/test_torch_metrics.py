"""The port's disentanglement metrics and ``eval_disentanglement`` against
the JAX package's, on the CPU (scikit-learn is installed here; the card's
machine has none):

- ``auroc`` equals ``sklearn.metrics.roc_auc_score`` to 1e-12, ties
  included;
- ``TADMetric``, ``_binary_mi_matrix`` and the DCI entropy helpers equal
  JAX's to 1e-10, the TAD grid JAX's sklearn loop to 1e-12;
- the numpy KFold equals ``KFold(5, shuffle=True, random_state=0)`` index
  for index, the StandardScaler sklearn's to 1e-12;
- ``evaluate_latents`` on the celeba (TAD + probe) and dsprites (DCI +
  probe) protocols equals JAX's dict to 1e-9, and ``main`` JAX's;
- with sklearn hidden, TAD and the AUROC run and the learners raise an
  ImportError that names scikit-learn.
"""

import importlib
import subprocess
import sys

import numpy as np
import pytest
from sklearn.metrics import roc_auc_score
from sklearn.model_selection import KFold
from sklearn.preprocessing import StandardScaler as SkStandardScaler

from infodiffusion_tpu import eval_disentanglement as jed
from infodiffusion_tpu_torch import eval_disentanglement as ped

# the packages export a function of the module's name
jdis = importlib.import_module("infodiffusion_tpu.metrics.disentanglement")
pdis = importlib.import_module(
    "infodiffusion_tpu_torch.metrics.disentanglement")

AUROC_TOL = 1e-12
METRIC_TOL = 1e-10
PROTOCOL_TOL = 1e-9


def _auroc_case(name, rng, n=157):
    if name == "continuous":
        s = rng.randn(n)
        return (s + rng.randn(n) > 0).astype(int), s
    if name == "ties":
        s = np.round(rng.randn(n))
        return (rng.rand(n) < 0.4).astype(int), s
    if name == "labels_minus1_2":
        s = rng.randint(0, 5, n).astype(float)
        return np.where(s + rng.randn(n) > 2, 2, -1), s
    if name == "float_labels_const_score":
        return (rng.rand(n) < 0.5).astype(np.float32), np.zeros(n)
    s = rng.rand(n).astype(np.float32)
    return (s > 0.7).astype(bool), s  # "separable", booleans


@pytest.mark.parametrize("case", ["continuous", "ties", "labels_minus1_2",
                                  "float_labels_const_score", "separable"])
def test_auroc_matches_sklearn(case):
    y, s = _auroc_case(case, np.random.RandomState(len(case)))
    assert abs(pdis.auroc(y, s) - roc_auc_score(y, s)) <= AUROC_TOL


def test_auroc_refuses_one_class():
    with pytest.raises(ValueError, match="one class"):
        pdis.auroc(np.ones(5), np.arange(5.0))


def _attrs(rng, n, a_dim, y_dim):
    a = rng.randn(n, a_dim)
    a[:, 2] = np.round(a[:, 2])
    y = (rng.rand(n, y_dim) < 0.3).astype(np.int64)
    for k in range(min(y_dim, a_dim)):
        y[:, k] = a[:, k] + 0.3 * rng.randn(n) > 0
    y[:, -1] = 1  # a constant attribute
    return a, y


def test_tad_and_mi_match_jax():
    a, y = _attrs(np.random.RandomState(0), 300, 12, 9)
    y[:, 5] = y[:, 0]  # a duplicate label: entropy reduction 1
    got = pdis.TADMetric(9).evaluate(a, y)
    want = jdis.TADMetric(9).evaluate(a, y)
    assert abs(got[0] - want[0]) <= METRIC_TOL and got[2] == want[2]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=METRIC_TOL)
    np.testing.assert_allclose(
        got[1], jdis.TADMetric(9).aurocs_search_sklearn(a, y), rtol=0,
        atol=AUROC_TOL)
    np.testing.assert_allclose(pdis._binary_mi_matrix(y),
                               jdis._binary_mi_matrix(y), rtol=0,
                               atol=METRIC_TOL)


@pytest.mark.parametrize("kind", ["random", "zero", "diagonal"])
def test_dci_entropy_helpers_match_jax(kind):
    rng = np.random.RandomState(1)
    m = {"random": rng.rand(10, 4), "zero": np.zeros((6, 3)),
         "diagonal": np.eye(5)}[kind]
    for fn in ("disentanglement_per_code", "disentanglement",
               "completeness_per_factor", "completeness"):
        np.testing.assert_allclose(getattr(pdis, fn)(m),
                                   getattr(jdis, fn)(m), rtol=0,
                                   atol=METRIC_TOL, err_msg=fn)


@pytest.mark.parametrize("output_type", ["b", "c"])
def test_pred_metric_matches_jax(output_type):
    rng = np.random.RandomState(2)
    a = rng.randn(240, 6)
    if output_type == "b":
        y = (a[:, :3] + 0.5 * rng.randn(240, 3) > 0).astype(np.int64)
        y[:190, 2] = 0  # degenerate in the train split's first rows
    else:
        y = np.stack([np.digitize(a[:, 0], [-0.5, 0.5]),
                      rng.randint(0, 4, 240)], 1)
    args = (a[:180], y[:180], a[180:], y[180:])
    got = pdis.PredMetric("Linear", output_type).evaluate(*args)
    want = jdis.PredMetric("Linear", output_type).evaluate(*args)
    np.testing.assert_allclose(got["Linear_result"], want["Linear_result"],
                               rtol=0, atol=AUROC_TOL)


@pytest.mark.parametrize("n", [10, 23, 400, 1001])
def test_kfold_matches_sklearn(n):
    want = list(KFold(5, shuffle=True, random_state=0).split(np.zeros(n)))
    got = list(ped.kfold_splits(n))
    assert len(got) == len(want) == 5
    for (tr, te), (wtr, wte) in zip(got, want):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(te, wte)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
def test_standard_scaler_matches_sklearn(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(409, 16) * 3 + 1).astype(dtype)
    x[:, 3] = 2  # constant: scale 1
    t = (rng.randn(100, 16) * 3).astype(dtype)
    got = ped.StandardScaler().fit(x)
    want = SkStandardScaler().fit(x)
    for attr in ("mean_", "var_", "scale_"):
        np.testing.assert_allclose(getattr(got, attr), getattr(want, attr),
                                   rtol=0, atol=1e-12, err_msg=attr)
    out, ref = got.transform(t), want.transform(t)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


def _dsprites_latents(rng, n=150):
    classes = np.stack([np.zeros(n), rng.randint(0, 3, n),
                        rng.randint(0, 3, n), rng.randint(0, 4, n),
                        rng.randint(0, 2, n), rng.randint(0, 3, n)], 1)
    attrs = np.concatenate([classes.astype(np.float64), classes], 1)
    a = np.concatenate([classes[:, 1:] + 0.3 * rng.randn(n, 5),
                        rng.randn(n, 3)], 1).astype(np.float32)
    return a, attrs


def _compare(got, want):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key], np.float64),
                                   np.asarray(want[key], np.float64),
                                   rtol=0, atol=PROTOCOL_TOL, err_msg=key)


@pytest.mark.parametrize("dataset", ["celeba", "dsprites"])
def test_evaluate_latents_matches_jax(dataset, tmp_path, capsys):
    rng = np.random.RandomState(4)
    if dataset == "celeba":
        a, attrs = _attrs(rng, 260, 16, 40)
        a = a.astype(np.float32)
    else:
        a, attrs = _dsprites_latents(rng)
    path = str(tmp_path / "latent.npz")
    np.savez(path, all_a=a, all_attr=attrs)
    la, y = ped.load_latents(None, dataset, npz_path=path)
    ja, jy = jed.load_latents(None, dataset, npz_path=path)
    np.testing.assert_array_equal(la, ja)
    np.testing.assert_array_equal(y, jy)
    np.random.seed(0)  # DCI's GBT draws its feature order from it
    got = ped.evaluate_latents(la, y, dataset)
    printed = capsys.readouterr().out
    np.random.seed(0)
    want = jed.evaluate_latents(ja, jy, dataset)
    assert printed == capsys.readouterr().out  # the same lines
    _compare(got, want)


def test_main_matches_jax(tmp_path, monkeypatch, capsys):
    """The command line: the 3dshapes choice widening and its label
    transforms, and the attr-less dump refused with JAX's message."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(5)
    # raw factors whose transforms give two or three classes each (the
    # per-factor GBT's cost grows with the classes)
    y = np.stack([rng.randint(0, 3, 80) / 10 + 0.01,
                  rng.randint(0, 2, 80) / 10 + 0.01,
                  rng.randint(0, 3, 80) / 10 + 0.01,
                  (rng.randint(0, 2, 80) + 10.5) / 14 + 0.01,
                  rng.randint(0, 3, 80),
                  rng.randint(0, 2, 80) * 60 / 14 + 0.1], 1)
    a = np.concatenate([y, rng.randn(80, 2)], 1)
    np.savez("diff_3dshapes_32d_0_1mmd_latent.npz", all_a=a, all_attr=y)
    argv = ["--model", "diff", "--prior", "regular", "--dataset", "3dshapes",
            "--a_dim", "32"]
    outs = []
    for main in (ped.main, jed.main):
        np.random.seed(0)  # the GBT's feature order (random_state=None)
        outs.append(main(argv))
    _compare(*outs)
    capsys.readouterr()
    np.savez("diff_chairs_32d_0_1mmd_latent.npz", all_a=a,
             all_attr=np.array(["No Attributes"] * 80))
    argv[5] = "chairs"
    errors = []
    for main in (ped.main, jed.main):
        with pytest.raises(ValueError, match="no usable labels") as info:
            main(argv)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_learners_raise_without_sklearn():
    """With scikit-learn blocked, as on the card's machine: TAD and the
    AUROC run; DCI and the probe raise an ImportError naming it."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "from infodiffusion_tpu_torch.metrics import (PredMetric, TADMetric,"
        " auroc, compute_dci)\n"
        "rng = np.random.RandomState(0)\n"
        "a = rng.randn(50, 4); y = (a[:, :3] > 0).astype(int)\n"
        "score, _, _ = TADMetric(3).evaluate(a, y)\n"
        "assert np.isfinite(score) and auroc(y[:, 0], a[:, 0]) == 1.0\n"
        "for make in (lambda: PredMetric('Linear', 'b'),\n"
        "             lambda: compute_dci(a.T, y.T, a.T, y.T)):\n"
        "    try:\n"
        "        make()\n"
        "    except ImportError as exc:\n"
        "        assert 'scikit-learn is not installed' in str(exc), exc\n"
        "        assert 'TAD and the AUROC need none' in str(exc), exc\n"
        "    else:\n"
        "        raise AssertionError('no ImportError')\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
