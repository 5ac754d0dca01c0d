"""The port's runner against the JAX runner on a VAE, given the same
weights (``tests/torch_runner_parity.py``): ``disentangle`` (the decoder
only) writes one PNG per latent dim, every one within 1 code of 255 of
JAX's."""

import pytest

from torch_runner_parity import argv, assert_pngs_close, runner_for, same_weights


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return same_weights(tmp_path_factory.mktemp("runner_vae"), "vae")


def test_vae_disentangle_matches_jax(dirs, monkeypatch):
    run = runner_for(dirs, monkeypatch)
    for side in ("jax", "torch"):
        run(side, argv("vae", "disentangle", "--img_id", "3"))
    assert assert_pngs_close(
        dirs, "imgs/vae/mnist_32d_0.1mmd/disentangle-3") == 32
