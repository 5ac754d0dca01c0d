"""The port's command line (JAX counterpart: ``infodiffusion_tpu/cli.py``).

    python -m infodiffusion_tpu_torch --model diff --mode train \\
        --prior regular --dataset celeba --a_dim 256 --data_dir synthetic

The flags, defaults, required markers and choices are the JAX CLI's (the
reference's ``run.py`` flags plus the JAX package's own), so every
``scripts/*.sh`` line and every ``run.py`` command runs unchanged. The run
goes to the card; ``INFODIFF_FORCE_CPU=1`` runs it on the CPU, and with
neither it raises.

Training across devices runs one process a device under torchrun:

    python -m torch.distributed.run --nproc_per_node N \
        -m infodiffusion_tpu_torch --mode train ... [--fsdp] [--tp K]

(``--nnodes`` / ``--rdzv_endpoint`` and ``--multihost`` across nodes;
``--pp S`` for ``train_latent_ddim``, ``--sp S`` for ring attention). The
process group starts first (``parallel.multihost.maybe_initialize``), as
the JAX CLI starts its distributed runtime.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from infodiffusion_tpu_torch.config import Config, DATASETS, MODELS, MODES, PRIORS

# the JAX package's turbo tiers
TURBO_CHOICES = ("", "off", "int8", "int8x")


def build_parser(require_mode: bool = True) -> argparse.ArgumentParser:
    """``require_mode=False`` defaults ``--mode`` to save_latent (the
    disentanglement evaluation's command line omits it)."""
    p = argparse.ArgumentParser(prog="python -m infodiffusion_tpu_torch")
    p.add_argument("--r_seed", type=int, default=0,
                   help="the value of given random seed")
    p.add_argument("--img_id", type=int, default=0,
                   help="the id of given img")
    p.add_argument("--model", required=True, choices=list(MODELS),
                   help="which type of model to run")
    p.add_argument("--mode", required=require_mode, choices=list(MODES),
                   default="save_latent" if not require_mode else None,
                   help="which mode to run")
    p.add_argument("--prior", required=True, choices=list(PRIORS),
                   help="which type of prior to run")
    p.add_argument("--kld_weight", type=float, default=0,
                   help="weight of kld loss")
    p.add_argument("--mmd_weight", type=float, default=0.1,
                   help="weight of mmd loss")
    p.add_argument("--use_C", action="store_true", default=False,
                   help="use control constant or not")
    p.add_argument("--C_max", type=float, default=25,
                   help="control constant of kld loss")
    p.add_argument("--dataset", required=True, choices=list(DATASETS),
                   help="training dataset")
    p.add_argument("--img_folder", default="./imgs",
                   help="path to save sampled images")
    p.add_argument("--log_folder", default="./logs",
                   help="path to save logs")
    p.add_argument("-e", "--epochs", type=int, default=20,
                   help="number of epochs to train; the eval modes load "
                        "model-{epochs}")
    p.add_argument("--save_epochs", type=int, default=5,
                   help="number of epochs to save model")
    p.add_argument("--batch_size", type=int, default=64,
                   help="training batch size")
    p.add_argument("--learning_rate", type=float, default=0.0001,
                   help="learning rate")
    p.add_argument("--optimizer", default="adam", choices=["adam"],
                   help="optimization algorithm")
    p.add_argument("--model_folder", default="./models",
                   help="folder where checkpoints are stored")
    p.add_argument("--deterministic", action="store_true", default=False,
                   help="deterministic sampling")
    p.add_argument("--input_channels", type=int, default=1)
    p.add_argument("--unets_channels", type=int, default=64)
    p.add_argument("--encoder_channels", type=int, default=64)
    p.add_argument("--input_size", type=int, default=32,
                   help="expected size of input")
    p.add_argument("--a_dim", type=int, default=32, required=True,
                   help="dimensionality of auxiliary variable")
    p.add_argument("--beta1", type=float, default=1e-5)
    p.add_argument("--betaT", type=float, default=1e-2)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--split_step", type=int, default=500,
                   help="the step for splitting two phases")
    p.add_argument("--sampling_number", type=int, default=16,
                   help="number of sampled images")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--tb_logger", action="store_true",
                   help="use tensorboard logger.")
    p.add_argument("--is_latent", action="store_true",
                   help="use latent diffusion for unconditional sampling.")
    p.add_argument("--is_bottleneck", action="store_true",
                   help="only fuse aux variable in bottleneck layers.")
    # the reference scripts pass these two, which its own parser lacks
    p.add_argument("--disent_metric", choices=["tad", "dci"], default="tad",
                   help="(accepted for the reference scripts)")
    p.add_argument("--save_epoch", type=int, dest="save_epochs",
                   default=argparse.SUPPRESS, help=argparse.SUPPRESS)
    p.add_argument("--sampling_steps", type=int, default=None,
                   help="DDIM-N fast sampling (default: the full T grid)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (schedule math stays f32)")
    p.add_argument("--mesh_devices", type=int, default=None,
                   help="data-parallel size: the ranks of the run "
                        "(torchrun's world size)")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group (torchrun's environment "
                        "starts it anyway)")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the latest checkpoint")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params and optimizer state over the data "
                        "ranks")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size (output channels over the "
                        "'model' ranks)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages of train_latent_ddim (GPipe over "
                        "the LatentUNet middle)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel attention size (ring attention "
                        "from INFODIFF_SP_MIN_TOKENS tokens)")
    p.add_argument("--turbo", choices=list(TURBO_CHOICES), default="",
                   help="inference tier of the image samplers: 'int8' runs "
                        "the UNet conv bodies W8A8 with scales calibrated "
                        "when the sampler is built; 'int8x' also reads "
                        "each ResBlock's input through an s8 view (norm1 "
                        "and the 1x1 shortcut); '' falls through to "
                        "$INFODIFF_TURBO, 'off' forces it off")
    p.add_argument("--async_ckpt", action="store_true",
                   help="write checkpoints on a background thread")
    p.add_argument("--keep_checkpoints", type=int, default=None,
                   help="retain only the newest N checkpoint epochs")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="EMA decay for eval weights (0 = off)")
    p.add_argument("--ch_mult", type=str, default=None,
                   help="override UNet ch_mult, e.g. '1,2,2,2'")
    p.add_argument("--attn", type=str, default=None,
                   help="override attention level indices, e.g. '2'")
    p.add_argument("--two_phase_reference_quirk", action="store_true",
                   help="reproduce the reference two-phase sampler's "
                        "dead-branch bug")
    p.add_argument("--reverse_reference_quirk", action="store_true",
                   help="reproduce the reference reverse_sampling bug that "
                        "drops `a` and re-encodes the noisy sample each "
                        "step")
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    args = build_parser().parse_args(argv)
    return Config(**vars(args))


def dispatch(cfg: Config, device=None):
    from infodiffusion_tpu_torch import runner

    if cfg.mode == "train":
        return runner.train(cfg, device=device)
    if cfg.mode == "train_latent_ddim":
        return runner.train(cfg, latent=True, device=device)
    if cfg.mode == "save_original_img":
        return runner.save_original_img(cfg, device=device)
    # the reference's batch-size overrides
    if cfg.mode in ("disentangle", "latent_quality"):
        cfg = cfg.replace(batch_size=1)
    elif cfg.mode == "interpolate":
        cfg = cfg.replace(batch_size=2)
    return runner.evaluate(cfg, device=device)


def main(argv: Optional[Sequence[str]] = None):
    from infodiffusion_tpu_torch.parallel.multihost import maybe_initialize

    cfg = parse_args(argv)
    maybe_initialize(cfg.multihost)
    return dispatch(cfg)
