"""The port's modes that the parity tests do not reach, end to end through
its CLI on the CPU, each artifact where the JAX runner puts it: a profiled
training run with its metrics cadence, save_latent, train_latent_ddim,
eval_fid (two-phase over a vanilla model, and the latent prior), eval,
latent_quality under --turbo int8, plot_latent, save_original_img and
attr_classification."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from torch_runner_parity import ENV, argv


@pytest.fixture()
def run(tmp_path, monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    from infodiffusion_tpu_torch import cli

    return cli.main


def test_other_modes_run(run, tmp_path, monkeypatch):
    # a profiled run of 16 steps an epoch: the capture takes steps 10..20
    monkeypatch.setenv("INFODIFF_PROFILE", str(tmp_path / "trace"))
    monkeypatch.setenv("INFODIFF_LOG_EVERY", "4")
    run(argv("vanilla", "train", "--mmd_weight", "0", "--save_epochs", "1",
             "--batch_size", "2"))
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    monkeypatch.delenv("INFODIFF_PROFILE")
    with open(tmp_path / "logs/mnist_32d/metrics.jsonl") as f:
        assert len(f.readlines()) == 4  # steps 0, 4, 8, 12
    run(argv("diff", "train", "--save_epochs", "1"))
    run(argv("diff", "save_latent"))
    run(argv("diff", "train_latent_ddim", "--save_epochs", "1"))
    img = tmp_path / "imgs/mnist_32d_0.1mmd"
    for extra, sub in (([], "eval-fid-fast"),
                       (["--is_latent"], "eval-fid-latent")):
        run(argv("diff", "eval_fid", "--sampling_number", "3",
                 "--sampling_steps", "2", "--split_step", "25", *extra))
        assert sorted(os.listdir(img / sub)) == [
            f"sample-{i:06d}.png" for i in range(3)]
    run(argv("diff", "eval", "--sampling_steps", "2"))
    assert os.listdir(img / "eval") == ["sample00000.png"]
    run(argv("diff", "latent_quality", "--sampling_steps", "2",
             "--sampling_number", "3", "--turbo", "int8"))
    assert len(os.listdir(img / "latent_quality")) == 3
    run(argv("diff", "plot_latent"))
    assert np.asarray(Image.open(img / "plot_latent/plot_latent.png")
                      ).shape == (512, 512, 3)
    run(argv("diff", "save_original_img"))
    assert len(os.listdir(tmp_path / "mnist_imgs")) == 2
    run(argv("diff", "attr_classification"))
    with open(img / "attr_classification/results.json") as f:
        res = json.load(f)
    assert sorted(res) == ["mean_auroc", "per_attr_auroc"]
    assert len(res["per_attr_auroc"]) == 1  # mnist: the class, as y > 0
