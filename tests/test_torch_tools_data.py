"""The end-to-end tools' pieces on the CPU: ``pipeline_rehearsal``'s
corpus, byte for byte the JAX tool's ``generate_corpus`` for the same
seed, decoded through the native batcher's libjpeg build; and
``repr_learning_demo``'s numpy probe (split and ridge fit) against
scikit-learn's ``train_test_split`` and ``Ridge(1.0)`` within 1e-10."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from infodiffusion_tpu_torch import tracing
from infodiffusion_tpu_torch.tools import pipeline_rehearsal
from infodiffusion_tpu_torch.tools import repr_learning_demo as demo

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def test_corpus_is_the_jax_tools_bytes(tmp_path):
    sys.path.insert(0, TOOLS)
    try:
        import pipeline_rehearsal as jax_tool
    finally:
        sys.path.remove(TOOLS)
    want = jax_tool.generate_corpus(str(tmp_path / "jax"), 6, seed=3)
    got = pipeline_rehearsal.generate_corpus(str(tmp_path / "port"), 6,
                                             seed=3)
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read(), g


def test_decode_through_the_libjpeg_build(tmp_path):
    paths = pipeline_rehearsal.generate_corpus(str(tmp_path), 64)
    pil = tracing.counts["pil"]
    row = pipeline_rehearsal.measure_decode(paths, 64, batch=64)
    assert row["native_backend"] == "libjpeg"
    assert row["decode_imgs"] == 64 and row["pil_decode_imgs"] == 64
    # the native rows decoded every file; the comparison row used PIL
    assert tracing.counts["pil"] - pil == 2 * 64  # its warm-up and its run
    assert row["native_decode_imgs_per_sec"] > 0
    assert row["pil_decode_imgs_per_sec"] > 0


@pytest.mark.parametrize("n", [10, 97, 2048])
def test_probe_matches_scikit_learn(n):
    sklearn_ms = pytest.importorskip("sklearn.model_selection")
    from sklearn.linear_model import Ridge

    rng = np.random.RandomState(n)
    x = rng.randn(n, 8)
    y = x @ rng.randn(8) + 0.5 * rng.randn(n)
    want = sklearn_ms.train_test_split(x, y, test_size=0.3, random_state=0)
    got = demo.train_test_split(x, y)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    xtr, xte, ytr, yte = got
    ridge = Ridge(1.0).fit(xtr, ytr)
    w, b = demo.ridge_fit(xtr, ytr)
    np.testing.assert_allclose(w, ridge.coef_, rtol=0, atol=1e-10)
    assert abs(b - ridge.intercept_) <= 1e-10
    assert abs(demo.ridge_r2(xtr, ytr, xte, yte)
               - ridge.score(xte, yte)) <= 1e-10


def test_probe_skips_constant_factors():
    rng = np.random.RandomState(0)
    a = rng.randn(50, 4)
    attr = np.zeros((50, 6))
    attr[:, 2] = a[:, 0] * 2.0 + 1.0  # scale, linear in the latents
    out = demo.probe(a, attr)
    assert list(out) == ["scale"]
    assert out["scale"] == pytest.approx(1.0, abs=1e-2)
