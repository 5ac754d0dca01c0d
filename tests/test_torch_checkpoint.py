"""The port's checkpoints (``train/checkpoint.py``) and the runner's resume,
preemption, retention and background saves, as ``tests/test_preempt.py``
holds the JAX package's.

- Save and restore are exact: parameters, optimizer moments and count,
  EMA, step and seed.
- A run preempted by ``INFODIFF_PREEMPT_AFTER_STEPS`` mid-epoch and resumed
  ends with the parameters of the run without the break (within 1e-6; on
  the CPU they are the same bits), as does a resume from an epoch
  boundary.
- Retention and background saves keep only the newest epochs.
- A directory that the JAX package wrote (Orbax) is refused with an error
  that names both formats; an unfinished write is not loaded; a missing
  epoch names the one to pass with -e.
"""

import os
import shutil
import signal

import numpy as np
import pytest
import torch

from infodiffusion_tpu_torch import cli, runner
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.train import checkpoint as ckpt
from infodiffusion_tpu_torch.train.state import create_train_state, make_optimizer
from infodiffusion_tpu_torch.train.step import make_train_step

ROOT = "models/mnist_8d_0.1mmd_latent"
RESUME_TOL = 1e-6


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("INFODIFF_FORCE_CPU", "1")
    monkeypatch.setenv("INFODIFF_SYNTHETIC_N", "64")
    monkeypatch.delenv("INFODIFF_PREEMPT_AFTER_STEPS", raising=False)
    a = np.random.RandomState(0).randn(64, 8).astype(np.float32)
    np.savez("diff_mnist_8d_0_1mmd_latent", all_a=a, all_attr=np.zeros(64))
    return tmp_path


def _latent(extra=()):
    # the latent prior's trainer is the cheapest real train loop (an MLP);
    # 4 steps an epoch
    return cli.main([
        "--model", "diff", "--mode", "train_latent_ddim", "--prior",
        "regular", "--a_dim", "8", "--dataset", "mnist", "--epochs", "3",
        "--batch_size", "16", "--diffusion_steps", "6", "--save_epochs",
        "10", "--data_dir", "synthetic", *extra])


def _state(seed=0, ema=False):
    cfg = Config(a_dim=8, diffusion_steps=6)
    model = build_model(cfg, latent=True, device="cpu")
    tx = make_optimizer(1e-3, 3, 4)
    return model, tx, create_train_state(model, seed, tx, ema=ema)


def _assert_states_equal(got, want, tol=0.0):
    assert got.step == want.step and got.seed == want.seed
    assert got.opt_state.count == want.opt_state.count
    pairs = [(got.params[n], want.params[n]) for n in want.params]
    pairs += list(zip(got.opt_state.mu + got.opt_state.nu,
                      want.opt_state.mu + want.opt_state.nu))
    if want.ema_params is not None:
        pairs += [(got.ema_params[n], want.ema_params[n])
                  for n in want.ema_params]
    for g, w in pairs:
        assert (g.detach() - w.detach()).abs().max().item() <= tol


def test_save_and_restore_are_exact(tmp_path):
    model, tx, state = _state(ema=True)
    step = make_train_step(model, tx, ema_decay=0.9)
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 8).astype(
        np.float32))
    for _ in range(3):
        state, _ = step(state, x)
    root = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(root, 2, state, position=(1, 3))
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    _, _, fresh = _state(seed=5, ema=True)
    fresh, position = ckpt.restore_checkpoint(root, 2, fresh)
    assert position == (1, 3)
    _assert_states_equal(fresh, state)
    assert ckpt.latest_checkpoint_epoch(root) == 2


def test_restore_params_prefers_ema(tmp_path):
    model, tx, state = _state(ema=True)
    step = make_train_step(model, tx, ema_decay=0.5)
    state, _ = step(state, torch.ones(16, 8))
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, 1, state)
    for prefer, want in ((True, state.ema_params), (False, state.params)):
        target, _, _ = _state(seed=9)
        ckpt.restore_params(root, 1, target, prefer_ema=prefer)
        for n, p in target.named_parameters():
            assert torch.equal(p, want[n].detach()), n


def test_preempted_run_resumes_to_the_uninterrupted_run(workdir,
                                                        monkeypatch):
    full = _latent()
    assert full.step == 3 * 4
    assert not os.path.exists("models")  # save_epochs 10: nothing saved
    # preempt after 6 steps: epoch 1, batch 2 -> model-1 with the position
    monkeypatch.setenv("INFODIFF_PREEMPT_AFTER_STEPS", "6")
    cut = _latent()
    assert cut.step == 6
    assert sorted(os.listdir(ROOT)) == ["model-1"]
    _, position = ckpt.restore_checkpoint(
        os.path.abspath(ROOT), 1, _state()[2])
    assert position == (1, 2)
    monkeypatch.delenv("INFODIFF_PREEMPT_AFTER_STEPS")
    resumed = _latent(["--resume"])
    assert resumed.step == 3 * 4
    _assert_states_equal(resumed, full, tol=RESUME_TOL)


def test_epoch_boundary_resume_is_exact(workdir):
    full = _latent(["--save_epochs", "1"])
    shutil.rmtree(f"{ROOT}/model-2")
    shutil.rmtree(f"{ROOT}/model-3")
    resumed = _latent(["--save_epochs", "10", "--resume"])
    assert resumed.step == 3 * 4
    _assert_states_equal(resumed, full)


def test_non_finite_loss_stops_training(workdir, monkeypatch):
    """The fetched loss is checked on the metrics cadence: a NaN raises
    FloatingPointError instead of training on."""
    real = runner.make_train_step

    def nan_at_step_5(model, tx, ema_decay=0.0):
        step = real(model, tx, ema_decay)

        def run(state, batch, curr_epoch=0):
            state, metrics = step(state, batch, curr_epoch)
            if state.step == 5:
                metrics["loss"] = torch.tensor(float("nan"))
            return state, metrics

        return run

    monkeypatch.setattr(runner, "make_train_step", nan_at_step_5)
    monkeypatch.setenv("INFODIFF_LOG_EVERY", "2")
    with pytest.raises(FloatingPointError, match="non-finite loss nan at "
                                                 "step 5 \\(epoch 1\\)"):
        _latent()


def test_sigterm_sets_the_preempt_flag():
    runner._PREEMPTED.clear()
    prev = signal.signal(signal.SIGTERM, runner.request_preempt)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert runner._PREEMPTED.wait(timeout=5)
    finally:
        signal.signal(signal.SIGTERM, prev)
        runner._PREEMPTED.clear()


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_retention_keeps_the_newest(workdir, async_ckpt):
    _latent(["--save_epochs", "1", "--keep_checkpoints", "1"]
            + (["--async_ckpt"] if async_ckpt else []))
    assert sorted(os.listdir(ROOT)) == ["model-3"]
    assert ckpt._writer is None and ckpt._pending_retention is None


def test_background_save_waits_for_the_previous(tmp_path, monkeypatch):
    """At most one write in flight, and retention only once the newest is
    on disk."""
    _, _, state = _state()
    root = str(tmp_path / "ck")
    order = []
    real = ckpt._write

    def slow(path, payload):
        order.append(("start", os.path.basename(path)))
        real(path, payload)
        order.append(("done", os.path.basename(path)))

    monkeypatch.setattr(ckpt, "_write", slow)
    for e in (1, 2, 3):
        ckpt.save_checkpoint(root, e, state, async_save=True, keep=2)
    ckpt.wait_for_saves()
    assert order == [(k, f"model-{e}") for e in (1, 2, 3)
                     for k in ("start", "done")]
    assert sorted(os.listdir(root)) == ["model-2", "model-3"]


def test_orbax_checkpoint_is_refused(tmp_path):
    import orbax.checkpoint as ocp

    root = str(tmp_path / "ck")
    writer = ocp.StandardCheckpointer()
    writer.save(os.path.join(root, "model-1"),
                {"params": {"w": np.zeros(3, np.float32)}})
    writer.wait_until_finished()
    model, _, _ = _state()
    with pytest.raises(ValueError, match="Orbax.*JAX package.*torch.save"):
        ckpt.restore_params(root, 1, model)


def test_unfinished_write_and_missing_epoch(tmp_path):
    _, _, state = _state()
    root = str(tmp_path / "ck")
    path = ckpt.save_checkpoint(root, 1, state)
    os.remove(os.path.join(path, "meta.json"))
    model, _, _ = _state()
    with pytest.raises(FileNotFoundError, match="did not complete"):
        ckpt.restore_params(root, 1, model)
    with pytest.raises(FileNotFoundError, match="pass -e/--epochs 1"):
        ckpt.restore_params(root, 20, model)
    with pytest.raises(FileNotFoundError, match="train first"):
        ckpt.restore_params(str(tmp_path / "none"), 1, model)


def test_checkpoint_root_layout():
    cfg = Config(dataset="celeba", a_dim=256)
    assert ckpt.checkpoint_root(cfg).endswith("models/celeba_256d_0.1mmd")
    assert ckpt.checkpoint_root(cfg, latent=True).endswith(
        "models/celeba_256d_0.1mmd_latent")
    assert ckpt.checkpoint_root(cfg.replace(model="vanilla")).endswith(
        "models/diff/celeba_256d_0.1mmd")
    assert ckpt.checkpoint_root(cfg.replace(model="vae")).endswith(
        "models/vae/celeba_256d_0.1mmd")
