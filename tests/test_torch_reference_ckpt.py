"""The reference's torch checkpoints in the port (``interop``'s reference
key map, ``load_torch_state_dict`` / ``export_torch_state_dict`` /
``load_torch_checkpoint`` and ``InfoDiffusionPipeline.from_torch_checkpoint``)
held against the JAX package's ``interop``: a state dict that JAX's
``export_torch_state_dict`` writes from numpy-seeded params loads into the
port bit for bit as ``from_jax_params`` moves the same params, and the
port exports the same keys, shapes and values, for the five model
families. DDIM-10 from one ``.pth`` through both packages'
``from_torch_checkpoint`` agrees within TRAJECTORY_TOL (f32)."""

import functools

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from infodiffusion_tpu import cli as jcli
from infodiffusion_tpu import interop as jinterop
from infodiffusion_tpu.models import VAE as JVAE
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu.pipelines import InfoDiffusionPipeline as JPipeline
from infodiffusion_tpu_torch import cli as pcli
from infodiffusion_tpu_torch import interop
from infodiffusion_tpu_torch.models.wrappers import VAE, Diff, InfoDiff
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
from torch_parity import TRAJECTORY_TOL, assert_close, randomize, rngs

torch.set_num_threads(2)

# (JAX class, port class, constructor arguments, example input shape)
FAMILIES = {
    "flagship": (JInfoDiff, InfoDiff, dict(
        T=8, a_dim=8, shape=(3, 16, 16), unets_channels=32,
        encoder_channels=32, ch_mult=(1, 2, 2, 2), attn=(2,)), (1, 16, 16, 3)),
    "bottleneck": (JInfoDiff, InfoDiff, dict(
        T=8, a_dim=8, shape=(3, 16, 16), unets_channels=32,
        encoder_channels=32, ch_mult=(1, 2), attn=(1,), is_bottleneck=True),
        (1, 16, 16, 3)),
    "vanilla_nrb3": (JDiff, Diff, dict(
        T=8, shape=(1, 16, 16), unets_channels=32, ch_mult=(1, 2), attn=(1,),
        num_res_blocks=3), (1, 16, 16, 1)),
    "latent": (JDiff, Diff, dict(T=8, shape=(1, 16, 16), is_latent=True),
               (2, 16)),
    "vae": (JVAE, VAE, dict(a_dim=4, shape=(1, 8, 8), encoder_channels=32,
                            ch_mult=(1, 2), attn=(1,)), (1, 8, 8, 1)),
}
# keys the reference saves and nothing builds
DEAD = {"backbone.middleblocks.0.crossattn.proj_q.weight": (32, 32, 1, 1),
        "backbone.time_embedding.timembedding.0.weight": (8, 32)}


def _params(jm, shape, seed):
    """numpy-seeded params of every submodule (the tree ``init`` over
    ``loss_fn`` makes; only its shapes are traced, nothing compiles)."""
    tree = jax.eval_shape(lambda: jm.init(rngs(), jnp.zeros(shape), 0,
                                          method=type(jm).loss_fn))
    return randomize(tree["params"], seed)


@functools.lru_cache(maxsize=None)
def _family(name, seed=1):
    """(JAX model, numpy-seeded params, JAX's reference state dict, port
    constructor); callers do not modify them."""
    jcls, pcls, kw, shape = FAMILIES[name]
    jm = jcls(**kw)
    params = _params(jm, shape, seed)
    return jm, params, jinterop.export_torch_state_dict(jm, params), \
        (lambda: pcls(**kw))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_key_map_matches_jax(name):
    jm, params, jax_sd, make = _family(name)
    want = interop.from_jax_params(params, make()).state_dict()
    got = interop.load_torch_state_dict(make(), jax_sd, strict=True)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
    exported = interop.export_torch_state_dict(got)
    assert set(exported) == set(jax_sd)
    for k, v in exported.items():
        assert tuple(v.shape) == jax_sd[k].shape, k
        np.testing.assert_array_equal(v.numpy(), jax_sd[k], err_msg=k)
    # the map itself: every port name to JAX's key for the same leaf
    kmap = interop.reference_key_map(got)
    jmap = {".".join(path[:-1] + ({"kernel": "weight", "scale": "weight"}
                                  .get(path[-1], path[-1]),)): key
            for path, (key, _) in jinterop.param_key_map(jm, params).items()}
    assert {n: key for n, (key, _) in kmap.items()} == jmap


def test_strict_and_dead_keys():
    _, _, jax_sd, make = _family("flagship")
    sd = dict(jax_sd)  # a shallow copy: the arrays are not modified
    sd.update({k: np.zeros(s, np.float32) for k, s in DEAD.items()})
    interop.load_torch_state_dict(make(), sd, strict=True)  # dead: skipped
    extra = dict(sd, **{"backbone.unexpected.weight": np.zeros(2)})
    interop.load_torch_state_dict(make(), extra, strict=False)
    with pytest.raises(KeyError, match="unexpected"):
        interop.load_torch_state_dict(make(), extra, strict=True)
    missing = dict(jax_sd)
    del missing["encoder.fc_var.bias"]
    for strict in (False, True):
        with pytest.raises(KeyError, match="fc_var"):
            interop.load_torch_state_dict(make(), missing, strict=strict)
    bad = dict(jax_sd, **{"backbone.head.weight": np.zeros((1, 1, 3, 3))})
    with pytest.raises(ValueError, match="shape"):
        interop.load_torch_state_dict(make(), bad)


def test_pth_roundtrip_and_no_alias(tmp_path):
    """A .pth of the reference's layout (torch tensors, dead keys beside)
    round-trips bit for bit, JAX's loader reads the port's export, and the
    loaded parameters do not alias the source's storage."""
    jm, params, jax_sd, make = _family("vae")
    src = {k: torch.from_numpy(v.copy()) for k, v in jax_sd.items()}
    path = str(tmp_path / "model-3.pth")
    torch.save(dict(src, **{"encoder.crossattn.proj.weight":
                            torch.zeros(4, 4, 1, 1)}), path)
    model = interop.load_torch_checkpoint(make(), path)
    for k, v in interop.from_jax_params(params, make()).state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    out = str(tmp_path / "back.pth")
    torch.save(interop.export_torch_state_dict(model), out)
    back = torch.load(out, weights_only=True)
    assert set(back) == set(src)
    assert all(torch.equal(back[k], src[k]) for k in src)
    jback = jinterop.load_torch_checkpoint(jm, params, out, strict=True)
    for (a, b) in zip(jax_leaves(jback), jax_leaves(params)):
        np.testing.assert_array_equal(a, b)
    model = interop.load_torch_state_dict(make(), src)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    for t in src.values():
        t.add_(1.0)  # what an optimizer step on the source would do
    exported = interop.export_torch_state_dict(model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, snapshot[k]), k
    next(iter(exported.values())).add_(1.0)  # the export is a copy too
    for k, v in model.state_dict().items():
        assert torch.equal(v, snapshot[k]), k


def jax_leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


ARGV = ["--model", "diff", "--mode", "eval", "--prior", "regular",
        "--dataset", "mnist", "--a_dim", "8", "--diffusion_steps", "50",
        "--ch_mult", "1,2", "--attn", "1", "--deterministic"]


def test_from_torch_checkpoint_ddim_matches_jax(tmp_path):
    """One reference .pth through both packages' from_torch_checkpoint,
    then DDIM-10 from the same injected xT and a, f32."""
    jcfg = jcli.parse_args(ARGV).with_dataset_config()
    jm = JInfoDiff(T=50, a_dim=8, shape=jcfg.shape, unets_channels=32,
                   encoder_channels=32, ch_mult=(1, 2), attn=(1,))
    params = _params(jm, (1, 32, 32, 1), 4)
    path = str(tmp_path / "model-50.pth")
    sd = {k: torch.from_numpy(a.copy())
          for k, a in jinterop.export_torch_state_dict(jm, params).items()}
    sd["backbone.downblocks.0.crossattn.proj.weight"] = torch.zeros(1)
    torch.save(sd, path)
    rng = np.random.RandomState(9)
    xT = rng.randn(2, 32, 32, 1).astype(np.float32)
    a = rng.randn(2, 8).astype(np.float32)
    jpipe = JPipeline.from_torch_checkpoint(jcfg, path)
    want = jpipe.process.sampling(jr.PRNGKey(0), xT=xT, a=a, num_steps=10)
    pipe = InfoDiffusionPipeline.from_torch_checkpoint(
        pcli.parse_args(ARGV), path, device="cpu")
    assert next(pipe.model.parameters()).device.type == "cpu"
    got = pipe.process.sampling(xT=torch.from_numpy(xT),
                                a=torch.from_numpy(a), num_steps=10)
    assert_close(got, np.asarray(want), TRAJECTORY_TOL, "DDIM-10")
