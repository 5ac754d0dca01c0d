"""``--mode attr_classification`` in the port against the JAX package, on
the CPU:

- ``FeatureClassifier`` given JAX's parameters (``from_jax_params``,
  strict) equals JAX's forward within 1e-6 (deterministic); its dropout
  follows Flax's (keep 0.5, kept values doubled) from an explicit
  generator;
- one Adam step (lr 1e-3) on the probe's BCE with dropout off equals
  optax.adam's within 1e-6;
- the mode runs end to end through ``cli.main`` on synthetic celeba
  (``INFODIFF_FORCE_CPU=1``) and writes the JAX runner's ``results.json``
  schema; two runs with one seed write the same file; with no card and no
  ``INFODIFF_FORCE_CPU`` it raises.
"""

import json

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import optax
import pytest
import torch

from infodiffusion_tpu.models import FeatureClassifier as JFeatureClassifier
from infodiffusion_tpu_torch.interop import from_jax_params
from infodiffusion_tpu_torch.models.wrappers import FeatureClassifier
from infodiffusion_tpu_torch.runner import _bce

TOL = 1e-6
A_DIM, N_ATTR, B = 32, 40, 24


def _jax_probe(seed=0):
    clf = JFeatureClassifier(output_dim=N_ATTR)
    params = clf.init({"params": jr.PRNGKey(seed), "dropout": jr.PRNGKey(1)},
                      jnp.zeros((2, A_DIM)))["params"]
    return clf, params


def _port_probe(params):
    return from_jax_params(jax.tree.map(np.asarray, params),
                           FeatureClassifier(A_DIM, N_ATTR))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, A_DIM).astype(np.float32)
    y = (rng.rand(B, N_ATTR) < 0.4).astype(np.float32)
    return x, y


def test_feature_classifier_matches_jax():
    clf, params = _jax_probe()
    x, _ = _data()
    want = np.asarray(clf.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_probe(params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (B, N_ATTR)
    assert np.abs(got - want).max() <= TOL


def test_feature_classifier_dropout():
    """Flax's nn.Dropout(0.5): a unit kept with p 0.5 and doubled; the
    masks from the generator passed in (the same seed, the same masks),
    none without deterministic=False."""
    probe = FeatureClassifier(A_DIM, N_ATTR,
                              generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_data()[0])
    with torch.no_grad():
        runs = [probe(x, deterministic=False,
                      generator=torch.Generator().manual_seed(s))
                for s in (3, 3, 4)]
        plain = probe(x)
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], plain)
    hidden = torch.relu(probe.Dense_0(x))
    gen = torch.Generator().manual_seed(5)
    from infodiffusion_tpu_torch.nn.blocks import dropout

    out = dropout(hidden, 0.5, False, gen)
    kept = out != 0
    assert 0.4 < kept[hidden != 0].float().mean().item() < 0.6
    torch.testing.assert_close(out[kept], 2 * hidden[kept])
    with pytest.raises(ValueError, match="explicit"):
        probe(x, deterministic=False)


def test_adam_step_matches_optax():
    """The loss and every gradient within 1e-6 of JAX's; then one
    torch.optim.Adam step from JAX's gradients equals optax.adam's. (Adam's
    first step is g / (|g| + 1e-8) a parameter, so it turns f32 rounding
    differences in a gradient near 1e-8 into lr-sized ones: the step is
    held on the same gradients.)"""
    clf, params = _jax_probe(seed=2)
    x, y = _data(seed=1)

    def loss_fn(p):
        prob = clf.apply({"params": p}, jnp.asarray(x))
        eps = 1e-7
        return jnp.mean(-(y * jnp.log(prob + eps)
                          + (1 - y) * jnp.log(1 - prob + eps)))

    tx = optax.adam(1e-3)
    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    want_params = optax.apply_updates(params, updates)

    probe = _port_probe(params)
    loss = _bce(probe(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= TOL
    jax_grads = _port_probe(grads)
    opt = torch.optim.Adam(probe.parameters(), lr=1e-3)
    for (name, p), g in zip(probe.named_parameters(),
                            jax_grads.parameters()):
        assert (p.grad - g).abs().max().item() <= TOL, name
        p.grad = g.detach().clone()
    opt.step()
    want = _port_probe(want_params).state_dict()
    for name, value in probe.state_dict().items():
        assert (value - want[name]).abs().max().item() <= TOL, name


COMMON = ["--model", "diff", "--prior", "regular", "--dataset", "celeba",
          "--a_dim", "16", "--data_dir", "synthetic", "--batch_size", "8",
          "--r_seed", "7", "-e", "1", "--ch_mult", "1,2", "--attn", "1",
          "--diffusion_steps", "50"]


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    """A model-1 checkpoint of the flagship's widths at ch_mult (1, 2), as
    the port's train mode saves one (untrained weights)."""
    from infodiffusion_tpu_torch import cli
    from infodiffusion_tpu_torch.models.wrappers import build_model
    from infodiffusion_tpu_torch.train.checkpoint import (
        checkpoint_root,
        save_checkpoint,
    )
    from infodiffusion_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("INFODIFF_SYNTHETIC_N", "40")
    monkeypatch.setenv("INFODIFF_FORCE_CPU", "1")
    cfg = cli.parse_args(COMMON + ["--mode", "train"]).with_dataset_config()
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    save_checkpoint(checkpoint_root(cfg), 1,
                    create_train_state(model, 0, make_optimizer(1e-4, 1, 2)))
    return tmp_path


def test_mode_end_to_end(workdir, monkeypatch, capsys):
    from infodiffusion_tpu_torch import cli

    out = workdir / "imgs/celeba_16d_0.1mmd/attr_classification/results.json"
    files = []
    for _ in range(2):
        mean = cli.main(COMMON + ["--mode", "attr_classification"])
        files.append(out.read_text())
    assert files[0] == files[1]
    res = json.loads(files[0])
    assert sorted(res) == ["mean_auroc", "per_attr_auroc"]
    # 40 synthetic images: 32 train, 8 test; the test split's constant
    # attributes are skipped
    assert 0 < len(res["per_attr_auroc"]) <= N_ATTR
    assert all(0.0 <= v <= 1.0 for v in res["per_attr_auroc"])
    assert res["mean_auroc"] == pytest.approx(
        np.mean(res["per_attr_auroc"])) == mean
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == (f"attr_classification mean AUROC: {mean:.4f} "
                    f"({len(res['per_attr_auroc'])} attrs) -> "
                    f"./imgs/celeba_16d_0.1mmd/attr_classification/"
                    f"results.json")
    monkeypatch.delenv("INFODIFF_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(COMMON + ["--mode", "attr_classification"])
