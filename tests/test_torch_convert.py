"""The port's checkpoint converter (``python -m
infodiffusion_tpu_torch.tools.convert_checkpoint``) and its examples
(``python -m infodiffusion_tpu_torch.examples.generate`` / ``.traverse``),
on the CPU at a small size: a reference ``.pth`` -> the port's
``model-{e}`` -> ``.pth`` is bit for bit, the JAX package's loader reads
what the converter writes, the EMA is preferred unless ``--no_ema``, an
Orbax directory is refused, and each example writes its PNGs from the
pipeline's own samples."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infodiffusion_tpu import interop as jinterop
from infodiffusion_tpu.models import Diff as JDiff
from infodiffusion_tpu.models import InfoDiff as JInfoDiff
from infodiffusion_tpu_torch import cli, imaging, interop
from infodiffusion_tpu_torch.examples import generate, traverse
from infodiffusion_tpu_torch.models.wrappers import build_model
from infodiffusion_tpu_torch.pipelines import InfoDiffusionPipeline
from infodiffusion_tpu_torch.tools import convert_checkpoint
from infodiffusion_tpu_torch.train.checkpoint import (
    checkpoint_root,
    save_checkpoint,
)
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from torch_parity import randomize, rngs

torch.set_num_threads(2)

FLAGS = ["--model", "diff", "--prior", "regular", "--dataset", "mnist",
         "--a_dim", "8", "--diffusion_steps", "20", "--ch_mult", "1,2",
         "--attn", "1", "--deterministic", "-e", "3"]


def _cfg():
    return cli.parse_args(FLAGS + ["--mode", "eval"]).with_dataset_config()


def _seeded(model, seed):
    """``model`` with every parameter redrawn from a numpy seed."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                (0.1 * rng.randn(*p.shape)).astype(np.float32)))
    return model


def _pth(tmp_path, latent=False, seed=0):
    model = _seeded(build_model(_cfg(), latent=latent, device="cpu"), seed)
    path = str(tmp_path / f"ref{'_latent' if latent else ''}.pth")
    torch.save(interop.export_torch_state_dict(model), path)
    return model, path


@pytest.mark.parametrize("latent", [False, True])
def test_roundtrip_bitwise(tmp_path, latent):
    model, src = _pth(tmp_path, latent)
    ckpt = str(tmp_path / "models" / "model-3")
    extra = ["--latent"] if latent else []
    convert_checkpoint.main(FLAGS + extra + ["--src", src, "--dst", ckpt])
    back = str(tmp_path / "back.pth")
    convert_checkpoint.main(FLAGS + extra + ["--src", ckpt, "--dst", back])
    a = torch.load(src, weights_only=True)
    b = torch.load(back, weights_only=True)
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # the JAX package's loader reads what the converter wrote, to the same
    # values (its params on a traced tree)
    jm = (JDiff(T=20, shape=_cfg().latent_shape, is_latent=True) if latent
          else JInfoDiff(T=20, a_dim=8, shape=_cfg().shape,
                         unets_channels=32, encoder_channels=32,
                         ch_mult=(1, 2), attn=(1,)))
    x = jnp.zeros((1, 8) if latent else (1, 32, 32, 1))
    tree = jax.eval_shape(lambda: jm.init(rngs(), x, 0,
                                          method=type(jm).loss_fn))
    params = jinterop.load_torch_checkpoint(jm, randomize(tree["params"], 0),
                                            back, strict=True)
    ported = interop.from_jax_params(jax.tree.map(np.asarray, params),
                                     build_model(_cfg(), latent=latent,
                                                 device="cpu"))
    for k, v in ported.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_ema_preferred_unless_no_ema(tmp_path):
    cfg = _cfg()
    model = _seeded(build_model(cfg, device="cpu"), 1)
    state = create_train_state(model, 0, make_optimizer(1e-4, 3, 1), ema=True)
    for t in state.ema_params.values():
        t.add_(0.5)  # EMA weights that differ from the raw ones
    root = str(tmp_path / "models")
    save_checkpoint(root, 3, state)
    for flags, want in (([], state.ema_params), (["--no_ema"], state.params)):
        out = str(tmp_path / f"out{len(flags)}.pth")
        convert_checkpoint.main(FLAGS + flags + [
            "--src", os.path.join(root, "model-3"), "--dst", out])
        got = interop.load_torch_checkpoint(
            build_model(cfg, device="cpu"), out).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in got)


def test_refusals(tmp_path):
    orbax = tmp_path / "model-2"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        convert_checkpoint.main(FLAGS + ["--src", str(orbax), "--dst",
                                         str(tmp_path / "x.pth")])
    _, src = _pth(tmp_path)
    with pytest.raises(SystemExit, match="model-"):
        convert_checkpoint.main(FLAGS + ["--src", src, "--dst",
                                         str(tmp_path / "somewhere")])
    (tmp_path / "model-4").mkdir()
    (tmp_path / "model-4" / "file").write_text("")
    with pytest.raises(SystemExit, match="not empty"):
        convert_checkpoint.main(FLAGS + ["--src", src, "--dst",
                                         str(tmp_path / "model-4")])


@pytest.fixture
def checkpoint_dir(tmp_path, monkeypatch):
    """A working directory holding a port checkpoint (model-3) of a small
    mnist InfoDiff; the CLI runs on the CPU there over synthetic data."""
    monkeypatch.setenv("INFODIFF_FORCE_CPU", "1")
    monkeypatch.setenv("INFODIFF_SYNTHETIC_N", "8")
    monkeypatch.chdir(tmp_path)
    _, src = _pth(tmp_path, seed=2)
    convert_checkpoint.main(FLAGS + [
        "--src", src, "--dst",
        os.path.join(checkpoint_root(_cfg()), "model-3")])
    return tmp_path


def test_generate_example(checkpoint_dir):
    argv = FLAGS + ["--mode", "eval", "--sampling_number", "4",
                    "--sampling_steps", "3"]
    imgs = generate.main(argv)
    want = InfoDiffusionPipeline.from_checkpoint(cli.parse_args(argv)) \
        .generate(4, steps=3).numpy()
    np.testing.assert_array_equal(imgs, want)
    imaging.save_image(want, "want.png", normalize=True,
                       value_range=(-1.0, 1.0))
    got = imaging.decode_png(open("generated.png", "rb").read())
    np.testing.assert_array_equal(
        got, imaging.decode_png(open("want.png", "rb").read()))
    assert got.shape == (32 + 4, 4 * 34 + 2, 1)


def test_traverse_example(checkpoint_dir):
    argv = FLAGS + ["--mode", "eval", "--data_dir", "synthetic",
                    "--sampling_steps", "3", "--img_id", "1"]
    rows = traverse.main(argv, n_dims=2)
    assert len(rows) == 2 and rows[0].shape == (11, 32, 32, 1)
    for k in range(2):
        png = imaging.decode_png(open(f"traverse-dim{k}.png", "rb").read())
        assert png.shape == (36, 11 * 34 + 2, 1)
    # the same traversal through the pipeline, of the --img_id-th image
    from infodiffusion_tpu_torch.data import get_dataset

    cfg = cli.parse_args(argv).with_dataset_config()
    x, _ = get_dataset(cfg).get_batch(np.array([1]))
    pipe = InfoDiffusionPipeline.from_checkpoint(cfg)
    want = pipe.traverse(torch.from_numpy(x), dim=1).numpy()
    np.testing.assert_allclose(rows[1], want, atol=1e-6)
