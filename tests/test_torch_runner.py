"""The port's runner against the JAX runner on an InfoDiff, given the same
weights (``tests/torch_runner_parity.py``):

- ``save_latent``: ``all_a`` within 1e-4 of its max abs (f32 encoders that
  differ by summation order), the attributes equal;
- ``interpolate`` with ``--sampling_steps 10``: deterministic reverse DDIM
  then DDIM-10 from the same xT, the PNG pixels within 1 code of 255.
"""

import numpy as np
import pytest

from torch_runner_parity import argv, assert_pngs_close, runner_for, same_weights

LATENT_TOL = 1e-4


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return same_weights(tmp_path_factory.mktemp("runner"), "diff")


@pytest.fixture()
def run(dirs, monkeypatch):
    return runner_for(dirs, monkeypatch)


def test_save_latent_matches_jax(dirs, run):
    for side in ("jax", "torch"):
        run(side, argv("diff", "save_latent"))
    name = "diff_mnist_32d_0_1mmd_latent.npz"
    want = np.load(dirs["jax"] / name, allow_pickle=True)
    got = np.load(dirs["torch"] / name, allow_pickle=True)
    assert got["all_a"].dtype == np.float32
    assert got["all_a"].shape == want["all_a"].shape == (32, 32)
    err = np.abs(got["all_a"] - want["all_a"]).max()
    assert err <= LATENT_TOL * np.abs(want["all_a"]).max(), err
    np.testing.assert_array_equal(got["all_attr"], want["all_attr"])


def test_interpolate_matches_jax(dirs, run):
    for side in ("jax", "torch"):
        run(side, argv("diff", "interpolate", "--sampling_steps", "10"))
    assert assert_pngs_close(
        dirs, "imgs/mnist_32d_0.1mmd/interpolate-0") == 1
