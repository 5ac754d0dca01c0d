"""Helpers for the runner parity tests: the same weights in both runners'
checkpoints, and each runner's CLI in a directory of its own.

JAX ``init`` params (mnist, synthetic data, a_dim 32, T 50, batch 16,
ch_mult 1,2 and attention at level 1 to keep the JAX compiles short) are
saved through JAX's ``save_checkpoint``, and the same tree goes through
``from_jax_params`` into the port's checkpoint. The two runners share the
``./models`` layout and each format refuses the other, so each side works
in its own directory.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
from PIL import Image

from infodiffusion_tpu import cli as jcli
from infodiffusion_tpu import train as jtrain
from infodiffusion_tpu.models import build_model as jbuild_model
from infodiffusion_tpu.train.checkpoint import checkpoint_root as jroot
from infodiffusion_tpu_torch import cli as pcli
from infodiffusion_tpu_torch.interop import from_jax_params
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.train.checkpoint import (
    checkpoint_root,
    save_checkpoint,
)
from infodiffusion_tpu_torch.train.state import create_train_state, make_optimizer

COMMON = ["--prior", "regular", "--dataset", "mnist", "--a_dim", "32",
          "--data_dir", "synthetic", "--diffusion_steps", "50",
          "--batch_size", "16", "--r_seed", "7", "-e", "1", "--ch_mult",
          "1,2", "--attn", "1"]
ENV = {"INFODIFF_SYNTHETIC_N": "32", "INFODIFF_FORCE_CPU": "1"}
PIXEL_TOL = 1  # codes of 255


def argv(model, mode, *extra):
    return ["--model", model, "--mode", mode, *COMMON, *extra]


def same_weights(base, model: str) -> dict:
    """{'jax': dir, 'torch': dir} under ``base``, each holding model-1 of
    the same ``model`` weights in its runner's format."""
    out = {side: base / side for side in ("jax", "torch")}
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    cwd = os.getcwd()
    try:
        for d in out.values():
            d.mkdir(exist_ok=True)
        jcfg = jcli.parse_args(argv(model, "train")).with_dataset_config()
        state = jtrain.create_train_state(
            jbuild_model(jcfg), jr.PRNGKey(3), jnp.zeros((16, 32, 32, 1)),
            jtrain.make_optimizer(1e-4, 1, 2))
        os.chdir(out["jax"])
        jtrain.save_checkpoint(jroot(jcfg), 1, state)
        pcfg = pcli.parse_args(argv(model, "train")).with_dataset_config()
        pm = from_jax_params(jax.tree.map(np.asarray, state.params),
                             build_model(pcfg, device="cpu"))
        os.chdir(out["torch"])
        save_checkpoint(checkpoint_root(pcfg), 1,
                        create_train_state(pm, 0, make_optimizer(1e-4, 1, 2)))
    finally:
        os.chdir(cwd)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def runner_for(dirs, monkeypatch):
    """run(side, argv): that side's CLI in that side's directory."""
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)

    def run(side, args):
        monkeypatch.chdir(dirs[side])
        if side == "jax":
            return jcli.dispatch(jcli.parse_args(args))
        return pcli.main(args)

    return run


def _pngs(root):
    return {name: np.asarray(Image.open(os.path.join(root, name)), np.int16)
            for name in sorted(os.listdir(root))}


def assert_pngs_close(dirs, sub) -> int:
    """Every PNG under ``sub`` within PIXEL_TOL codes on both sides;
    returns how many there are."""
    want = _pngs(dirs["jax"] / sub)
    got = _pngs(dirs["torch"] / sub)
    assert sorted(got) == sorted(want) and want
    for name in want:
        assert got[name].shape == want[name].shape, name
        diff = np.abs(got[name] - want[name]).max()
        assert diff <= PIXEL_TOL, f"{name}: {diff} codes"
    return len(want)
