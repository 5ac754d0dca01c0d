"""Convert between the reference's torch ``model-{e}.pth`` files and the
port's ``model-{e}`` checkpoint directories, both ways
(JAX counterpart: ``tools/convert_checkpoint.py``).

A reference user brings trained ``.pth`` files to the port; a port user
takes theirs back. The key map and layouts are ``interop``'s
(``reference_key_map``); this is their command line. The model flags are
run.py's, so the architecture matches:

    # .pth -> the port's checkpoint (then evaluate with -e 50)
    python -m infodiffusion_tpu_torch.tools.convert_checkpoint \\
        --src /ref/models/celeba_256d_0.1mmd/model-50.pth \\
        --dst ./models/celeba_256d_0.1mmd/model-50 \\
        --model diff --prior regular --dataset celeba --a_dim 256

    # the port's checkpoint -> .pth (loadable by the reference's run.py)
    python -m infodiffusion_tpu_torch.tools.convert_checkpoint \\
        --src ./models/celeba_256d_0.1mmd/model-50 --dst /tmp/model-50.pth \\
        --model diff --prior regular --dataset celeba --a_dim 256

The direction follows ``--src``: a ``.pth`` file converts into a checkpoint
directory named ``model-{e}`` (the parameters, with a fresh optimizer
state, the EMA equal to them, at step 0), a ``model-{e}`` directory into a
``.pth``, the EMA
weights when the checkpoint has them unless ``--no_ema``. ``--latent``
converts the latent prior (the ``{exp}_latent`` family) instead. An Orbax
directory of the JAX package is refused (``train/checkpoint.py``). The
models are built on the CPU: a conversion needs no card.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence


def build_parser():
    from infodiffusion_tpu_torch.cli import build_parser as run_parser

    p = run_parser(require_mode=False)
    p.add_argument("--src", required=True,
                   help="a reference .pth file, or a model-{e} checkpoint "
                        "directory of the port")
    p.add_argument("--dst", required=True,
                   help="the model-{e} directory to write, or the .pth file")
    p.add_argument("--latent", action="store_true",
                   help="convert the latent prior (a LatentUNet Diff) "
                        "instead of the main model")
    p.add_argument("--no_ema", action="store_true",
                   help="checkpoint -> .pth: the raw parameters even where "
                        "the checkpoint has EMA weights")
    return p


def _checkpoint_dir(path: str, flag: str):
    """(root, epoch) of a ``.../model-{epoch}`` directory path."""
    root, name = os.path.split(os.path.normpath(os.path.abspath(path)))
    head, _, epoch = name.partition("-")
    if head != "model" or not epoch.isdigit():
        raise SystemExit(f"{flag} {path}: a checkpoint directory is named "
                         f"model-{{epoch}}")
    return root, int(epoch)


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the conversion; returns the path written."""
    import torch

    from infodiffusion_tpu_torch.config import Config
    from infodiffusion_tpu_torch.interop import (
        export_torch_state_dict,
        load_torch_checkpoint,
    )
    from infodiffusion_tpu_torch.models.wrappers import build_model
    from infodiffusion_tpu_torch.train import checkpoint as ckpt
    from infodiffusion_tpu_torch.train.state import (
        create_train_state,
        make_optimizer,
    )

    args = vars(build_parser().parse_args(argv))
    src, dst = args.pop("src"), args.pop("dst")
    latent, no_ema = args.pop("latent"), args.pop("no_ema")
    cfg = Config(**args).with_dataset_config()
    if latent:
        cfg = cfg.replace(is_latent=True)
    model = build_model(cfg, latent=latent, dtype=torch.float32,
                        device="cpu")
    if src.endswith(".pth"):
        root, epoch = _checkpoint_dir(dst, "--dst")
        if os.path.isdir(dst) and os.listdir(dst):
            raise SystemExit(f"--dst {dst} exists and is not empty")
        load_torch_checkpoint(model, src)
        state = create_train_state(
            model, seed=cfg.r_seed, ema=True,
            tx=make_optimizer(cfg.learning_rate, cfg.epochs, 1))
        ckpt.save_checkpoint(root, epoch, state)
        print(f"torch -> checkpoint: {src} -> {dst} "
              f"({len(state.params)} tensors); evaluate with -e {epoch} "
              f"once it is {{model_folder}}/{{exp}}/model-{epoch}")
        return dst
    if not os.path.isdir(src):
        raise SystemExit(f"--src {src} is neither a .pth file nor a "
                         f"checkpoint directory")
    ckpt.restore_params(*_checkpoint_dir(src, "--src"), model,
                        prefer_ema=not no_ema)
    state_dict = export_torch_state_dict(model)
    torch.save(state_dict, dst)
    print(f"checkpoint -> torch: {src} -> {dst} ({len(state_dict)} tensors)")
    return dst


if __name__ == "__main__":
    main()
