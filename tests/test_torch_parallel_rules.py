"""The port's parallel rules against the JAX package's, with no process
spawned: each rank's rows of the global batch, the FSDP and tensor-parallel
placement of every parameter of the flagship-shaped models (mapped through
``interop``'s layout rules), the sequence-parallel route, the mesh errors
and the runner's flag rules and warnings. The multi-process checks are in
test_torch_dist_train.py, test_torch_pp.py and test_torch_ring_attention.py.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest

from infodiffusion_tpu import runner as jrunner
from infodiffusion_tpu.config import Config as JConfig
from infodiffusion_tpu.models import build_model as jbuild_model
from infodiffusion_tpu.parallel import make_mesh as jmake_mesh
from infodiffusion_tpu.parallel.fsdp import fsdp_param_sharding
from infodiffusion_tpu.parallel.mesh import batch_sharding
from infodiffusion_tpu.parallel.tp import tp_param_sharding
from infodiffusion_tpu_torch import runner as prunner
from infodiffusion_tpu_torch.config import Config
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.parallel import multihost, sp
from infodiffusion_tpu_torch.parallel.fsdp import flax_perm, fsdp_dim
from infodiffusion_tpu_torch.parallel.mesh import make_1d_mesh, make_mesh
from infodiffusion_tpu_torch.parallel.tp import tp_dims

FLAGSHIP = dict(model="diff", mode="train", prior="regular", a_dim=256,
                dataset="celeba")


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_local_rows_match_jax(width):
    B = 32
    sh = batch_sharding(jmake_mesh(width))
    want = {}
    for dev, idx in sh.devices_indices_map((B,)).items():
        sl = idx[0]
        want[dev.id] = np.arange(sl.start or 0, B if sl.stop is None
                                 else sl.stop)
    devices = jax.devices()[:width]
    got = [multihost.local_row_indices(width, i, B) for i in range(width)]
    for i, dev in enumerate(devices):
        np.testing.assert_array_equal(got[i], want[dev.id])
    np.testing.assert_array_equal(np.concatenate(got), np.arange(B))
    with pytest.raises(ValueError, match="does not divide"):
        multihost.local_row_indices(2 * width, 0, 2 * width + 1)


@functools.lru_cache(maxsize=None)
def _trees(which: str):
    """(JAX param shapes, port param shapes by name) of the flagship
    InfoDiff or its latent prior."""
    jcfg = JConfig(**FLAGSHIP).with_dataset_config()
    cfg = Config(**FLAGSHIP).with_dataset_config()
    latent = which == "prior"
    jm = jbuild_model(jcfg, latent=latent)
    C, H, W = jcfg.shape
    x = jnp.zeros((1, jcfg.a_dim) if latent else (1, H, W, C))
    rngs = {k: jr.PRNGKey(i) for i, k in enumerate(
        ("params", "noise", "reparam", "dropout"))}
    tree = jax.eval_shape(lambda: jm.init(rngs, x, 0,
                                          method=type(jm).loss_fn))["params"]
    model = build_model(cfg, latent=latent, device="meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return tree, shapes


def _port_name(path) -> str:
    keys = [p.key for p in path]
    last = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
    return ".".join(keys[:-1] + [last])


def _axes(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return ({a: i for i, a in enumerate(spec) if a is not None})


def _leaves(tree, shardings):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(_port_name(path), leaf, sh) for (path, leaf), sh in zip(
        flat, jax.tree.leaves(shardings))]


def _flax_axis(name, shape, torch_axis):
    return None if torch_axis is None else flax_perm(name, len(shape))[
        torch_axis]


@pytest.mark.parametrize("which", ["infodiff", "prior"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_placement_matches_jax(which, n):
    tree, shapes = _trees(which)
    leaves = _leaves(tree, fsdp_param_sharding(jmake_mesh(n), tree))
    assert {name for name, _, _ in leaves} == set(shapes)
    split = 0
    for name, leaf, sh in leaves:
        want = _axes(sh.spec, leaf.ndim).get("data")
        got = _flax_axis(name, shapes[name], fsdp_dim(name, shapes[name], n))
        assert got == want, (name, leaf.shape, shapes[name], got, want)
        split += want is not None
    assert split > 0


@pytest.mark.parametrize("which", ["infodiff", "prior"])
@pytest.mark.parametrize("n,tp,fsdp", [(2, 2, False), (4, 2, True),
                                       (8, 2, True), (8, 4, False)])
def test_tp_placement_matches_jax(which, n, tp, fsdp):
    tree, shapes = _trees(which)
    mesh = jmake_mesh(n, model_parallel=tp)
    leaves = _leaves(tree, tp_param_sharding(mesh, tree, fsdp=fsdp))
    split = {"data": 0, "model": 0}
    for name, leaf, sh in leaves:
        want = _axes(sh.spec, leaf.ndim)
        d, m = tp_dims(name, shapes[name], tp, n // tp, fsdp=fsdp)
        got = {k: v for k, v in (
            ("data", _flax_axis(name, shapes[name], d)),
            ("model", _flax_axis(name, shapes[name], m))) if v is not None}
        assert got == want, (name, leaf.shape, got, want)
        for k in got:
            split[k] += 1
        if m is not None:  # output features: torch axis 0 of a weight
            assert m == 0, (name, m)
    assert split["model"] > 0 and (split["data"] > 0) == (fsdp and n > tp)


def test_sp_route_rules(monkeypatch):
    """JAX test_sp.py::test_sp_route_rules, on a stand-in 4-rank group."""
    group = object()
    monkeypatch.setattr(sp.dist, "get_world_size", lambda g: 4)
    assert sp.sp_route(64) is None  # not configured
    with sp.sp_scope(group, min_tokens=64):
        assert sp.sp_route(64) is group
        assert sp.sp_route(32) is None  # below threshold
        with pytest.warns(UserWarning, match="do not divide"):
            assert sp.sp_route(65) is None  # indivisible -> dense
    assert sp.sp_route(64) is None  # scope restored
    monkeypatch.setenv("INFODIFF_SP_MIN_TOKENS", "2048")
    with sp.sp_scope(group):
        assert sp.sp_route(1024) is None and sp.sp_route(2048) is group


def test_mesh_errors_match_jax():
    with pytest.raises(ValueError, match="mesh wants 9 devices but only 8"):
        jmake_mesh(9)
    with pytest.raises(ValueError, match="mesh wants 2 devices but only 1"):
        make_mesh(2)
    with pytest.raises(ValueError, match=r"tensor-parallel size 3 \(--tp\) "
                                         r"must divide the mesh device count"):
        jmake_mesh(8, model_parallel=3)
    with pytest.raises(ValueError, match=r"tensor-parallel size 2 \(--tp\) "
                                         r"must divide the mesh device count"):
        make_mesh(1, model_parallel=2)
    with pytest.raises(ValueError, match="'seq' mesh wants 2 devices"):
        make_1d_mesh(2, "seq")


def test_pp_only_for_latent_training():
    cfg = Config(**FLAGSHIP, pp=2)
    with pytest.raises(ValueError, match="only supported for --mode "
                                         "train_latent_ddim"):
        prunner.parallel_plan(cfg, latent=False)
    with pytest.raises(ValueError, match="only supported for --mode "
                                         "train_latent_ddim"):
        jrunner.train(JConfig(**FLAGSHIP, pp=2))


def test_pp_drops_the_data_mesh_with_jax_warning():
    cfg = Config(**FLAGSHIP, pp=2, fsdp=True, tp=2)
    with pytest.warns(UserWarning, match=r"--pp owns the device mesh: "
                                         r"--fsdp, --tp 2 disabled"):
        with pytest.raises(ValueError, match="must divide the world size 1"):
            prunner.parallel_plan(cfg, latent=True)


def _sp_warnings(configure, cfg):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        configure(cfg)
    kinds = set()
    for w in caught:
        msg = str(w.message)
        kinds |= {k for k in ("will never engage", "latency-bound")
                  if k in msg}
    return kinds


@pytest.mark.parametrize("size,sp_n,want", [
    (64, 4, {"will never engage"}), (128, 4, {"latency-bound"}),
    (512, 2, set())])
def test_configure_sp_warnings_match_jax(size, sp_n, want, monkeypatch):
    from infodiffusion_tpu.parallel.sp import configure_sp as jconfigure_sp
    from infodiffusion_tpu_torch.parallel import ring_attention

    monkeypatch.setattr(ring_attention, "make_seq_mesh", lambda n: None)
    kw = dict(FLAGSHIP, mode="eval", sp=sp_n, input_size=size)
    try:
        got = _sp_warnings(prunner._configure_sp, Config(**kw))
        jax_got = _sp_warnings(jrunner._configure_sp, JConfig(**kw))
    finally:
        jconfigure_sp(None)
        sp.configure_sp(None)
    assert got == jax_got == want


def test_eval_modes_refuse_several_processes(monkeypatch):
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    cfg = Config(**dict(FLAGSHIP, mode="eval"))
    with pytest.raises(RuntimeError, match="runs in one process"):
        prunner.evaluate(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="runs in one process"):
        prunner.save_original_img(cfg, device="cpu")
