"""The port's data-parallel, FSDP, tensor-parallel and TP+FSDP training
steps on 2 and 4 gloo ranks (one process a rank, on the CPU) against the
one-process step: the InfoDiff loss with the MMD (and, at 4 ranks, the KLD
too), the grad norm, and the parameters and EMA after two steps. Also the
per-rank state bytes (FSDP below DP), each layout's placement against the
JAX rules on the same model, an FSDP checkpoint resumed in one process,
sampling split over the ranks against one process, and the command line
under torchrun at 2 ranks (train, resume; rank 0 alone writes) against the
one-process command line.

The UNet step is held to JAX transitively: N ranks = one process (here),
one process = JAX on one device (test_torch_train.py), JAX on one device
= JAX on its mesh (test_train.py). Bars are the JAX tests': the loss with
MMD rel 1e-4, the parameters 1e-5 abs.
"""

import functools
import os
import shlex
import subprocess
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.parallel import make_mesh as jmake_mesh
from infodiffusion_tpu.parallel.fsdp import fsdp_param_sharding
from infodiffusion_tpu.parallel.tp import tp_param_sharding
from infodiffusion_tpu_torch import cli as pcli
from infodiffusion_tpu_torch.parallel.fsdp import flax_perm
from infodiffusion_tpu_torch.parallel.launch import spawn
from infodiffusion_tpu_torch.train.checkpoint import restore_checkpoint
from infodiffusion_tpu_torch.train.state import create_train_state, make_optimizer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KLD = {2: 0.0, 4: 0.01}  # the 4-rank run has the KLD on as well
LAYOUT_NAMES = ("dp", "fsdp", "tp", "tp+fsdp")
PARAM_TOL = 1e-5

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world in (2, 4):
        work = str(tmp_path_factory.mktemp(f"ranks{world}"))
        out[world] = spawn("torch_dist_workers:battery", world,
                           {"workdir": work, "kld_weight": KLD[world]},
                           workdir=work, timeout=300, pythonpath=[HERE])
    return out


@functools.lru_cache(maxsize=None)
def reference(kld_weight):
    return W.one_process(kld_weight)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_layout_step_matches_one_process(runs, world, name):
    got = runs[world][0][name]
    want = reference(KLD[world])
    assert got["kind"] == name
    assert got["rows"] * (world // (2 if name.startswith("tp") else 1)) \
        == W.BATCH
    for g, w in zip(got["metrics"], want["metrics"]):
        assert set(g) == set(w)
        for key in w:
            tol = 1e-4 if key in ("loss", "mmd") else 1e-5
            assert abs(g[key] - w[key]) <= tol * abs(w[key]) + 1e-12, (
                key, g[key], w[key])
    for which in ("params", "ema"):
        for k, v in want[which].items():
            err = (got[which][k] - v).abs().max().item()
            assert err <= PARAM_TOL, (which, k, err)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree(runs, world):
    """Every rank holds the same whole state and metrics after the steps."""
    for r in runs[world][1:]:
        for name in LAYOUT_NAMES:
            assert r[name]["metrics"] == runs[world][0][name]["metrics"]
            for k, v in r[name]["params"].items():
                assert torch.equal(v, runs[world][0][name]["params"][k])


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_collectives(runs, world):
    """process_allgather stacks the ranks' arrays in rank order on every
    rank; agree_on_preemption is True everywhere when one rank saw it."""
    want = np.array([[r, 2 * r] for r in range(world)])
    for r in runs[world]:
        np.testing.assert_array_equal(r["allgather"], want)
        assert r["preempt"] == (False, True)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_state_bytes_below_dp(runs, world):
    by = {n: [r[n]["bytes"] for r in runs[world]] for n in LAYOUT_NAMES}
    dp = by["dp"][0]
    assert all(b == dp for b in by["dp"])
    assert max(by["fsdp"]) < dp
    if world == 4:  # the data axis is 2 wide under tp+fsdp at 4 ranks
        assert max(by["tp+fsdp"]) < max(by["tp"])


@functools.lru_cache(maxsize=None)
def _jax_tree():
    kw = dict(W.MODEL_KW)
    m = JInfoDiff(**kw)
    rngs = {k: jr.PRNGKey(i) for i, k in enumerate(
        ("params", "noise", "reparam", "dropout"))}
    x = jnp.zeros((1, 8, 8, 1))
    return jax.eval_shape(lambda: m.init(rngs, x, 0,
                                         method=JInfoDiff.loss_fn))["params"]


def _name(path):
    keys = [p.key for p in path]
    return ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight"}.get(
        keys[-1], keys[-1])])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", LAYOUT_NAMES)
def test_layout_placements_match_jax(runs, world, name):
    tree = _jax_tree()
    tp = 2 if name.startswith("tp") else 1
    fsdp = name.endswith("fsdp")
    mesh = jmake_mesh(world, model_parallel=tp)
    if tp > 1:
        specs = tp_param_sharding(mesh, tree, fsdp=fsdp)
    elif fsdp:
        specs = fsdp_param_sharding(mesh, tree)
    else:
        specs = jax.tree.map(lambda _: None, tree)
    got = runs[world][0][name]["placements"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    leaves = jax.tree.leaves(specs, is_leaf=lambda x: x is None)
    assert len(flat) == len(got)
    for (path, leaf), sh in zip(flat, leaves):
        n = _name(path)
        spec = () if sh is None else tuple(sh.spec)
        want = {a: i for i, a in enumerate(spec) if a is not None}
        perm = flax_perm(n, leaf.ndim)
        d, m = got[n]
        mine = {k: perm[v] for k, v in (("data", d), ("model", m))
                if v is not None}
        assert mine == want, (n, leaf.shape, mine, want)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_checkpoint_resumes_in_one_process(runs, world):
    got = runs[world][0]["fsdp"]
    model = W.tiny_infodiff(KLD[world])
    tx = make_optimizer(W.LR, 3, 4)
    state = create_train_state(model, 0, tx, ema=True)
    state, position = restore_checkpoint(got["ckpt"], W.STEPS, state)
    assert state.step == W.STEPS and state.seed == W.SEED
    assert position == (W.STEPS, 0)
    for k, v in state.params.items():
        assert torch.equal(v.detach(), got["params"][k]), k
    for k, v in state.ema_params.items():
        assert torch.equal(v, got["ema"][k]), k
    for a, b in zip(state.opt_state.mu, got["mu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [c[0] for c in W.SAMPLE_CASES])
def test_sharded_sampling_matches_unsharded(runs, case):
    want = W.sample_all()[case]
    for world in (2, 4):
        for r in runs[world]:
            got = r["sampling"]
            err = (got[case] - want).abs().max().item()
            assert err <= 1e-5, (world, case, err)
            warned = [w for w in got["warnings"] if "does not divide" in w]
            assert len(warned) == 1 and "batch size 3 " in warned[0]


CLI_FLAGS = ("--model diff --prior regular --dataset mnist --a_dim 32 "
             "--data_dir synthetic --diffusion_steps 50 --batch_size 16 "
             "--r_seed 7 --ch_mult 1,2 --attn 1 --save_epochs 1 --fsdp")
CLI_ENV = {"INFODIFF_SYNTHETIC_N": "64", "INFODIFF_FORCE_CPU": "1"}


def _cli_runs(work, ranks):
    """train -e 1, then -e 2 --resume, in ``work``: under torchrun at
    ``ranks`` ranks, or in this process (``ranks`` 0)."""
    os.makedirs(work, exist_ok=True)
    logs = []
    for extra in ("--mode train -e 1", "--mode train -e 2 --resume"):
        argv = shlex.split(f"{CLI_FLAGS} {extra}")
        if ranks == 0:
            cwd = os.getcwd()
            os.chdir(work)
            try:
                pcli.main(argv)
            finally:
                os.chdir(cwd)
            continue
        env = dict(os.environ, **CLI_ENV, OMP_NUM_THREADS="2",
                   PYTHONPATH=ROOT)
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(ranks), "-m", "infodiffusion_tpu_torch",
             *argv], cwd=work, env=env, capture_output=True, text=True,
            timeout=240)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        logs.append(out.stdout)
    return logs


def test_cli_two_ranks_train_and_resume(tmp_path, monkeypatch):
    for k, v in CLI_ENV.items():
        monkeypatch.setenv(k, v)
    logs = _cli_runs(str(tmp_path / "ranks"), 2)
    _cli_runs(str(tmp_path / "one"), 0)
    assert "[parallel] 2 ranks: mesh {'data': 2, 'model': 1}; fsdp" in logs[0]
    assert "Resumed from epoch 1 (step 4)" in logs[1]
    # rank 0 alone printed and wrote
    assert logs[0].count("Saved checkpoint to") == 1
    files = sorted(str(p.relative_to(tmp_path / "ranks"))
                   for p in (tmp_path / "ranks").rglob("*") if p.is_file())
    assert files == ["logs/mnist_32d_0.1mmd/metrics.jsonl",
                     "models/mnist_32d_0.1mmd/model-1/meta.json",
                     "models/mnist_32d_0.1mmd/model-1/state.pt",
                     "models/mnist_32d_0.1mmd/model-2/meta.json",
                     "models/mnist_32d_0.1mmd/model-2/state.pt"], files
    read = {}
    for side in ("ranks", "one"):
        root = tmp_path / side
        with open(root / "logs/mnist_32d_0.1mmd/metrics.jsonl") as f:
            lines = f.read().splitlines()
        state = torch.load(root / "models/mnist_32d_0.1mmd/model-2/state.pt",
                           weights_only=True)
        read[side] = (len(lines), state)
    assert read["ranks"][0] == read["one"][0] == 2
    got, want = read["ranks"][1], read["one"][1]
    assert got["step"] == want["step"] == 8
    for k, v in want["params"].items():
        err = (got["params"][k] - v).abs().max().item()
        assert err <= PARAM_TOL, (k, err)
