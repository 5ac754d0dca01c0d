"""InfoDiffusion in PyTorch and CUDA: the port of ``infodiffusion_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and class names so each counterpart is found at once:

- ``nn``: time embeddings, the AdaGN ResBlocks, attention, resampling and
  the latent MLP block.
- ``models``: ``UNet``, ``AuxiliaryUNet``, ``BottleneckAuxUNet``,
  ``Encoder``, ``Decoder``, ``LatentUNet`` and the ``InfoDiff`` /
  ``Diff`` (vanilla or latent) / ``VAE`` wrappers with their losses;
  ``build_model`` picks one from a ``Config`` and puts it on the card.
- ``diffusion``: the schedule, its step algebra and the samplers (full
  grid, DDIM-N, reverse DDIM, two-phase).
- ``ops``: GroupNorm+FiLM (forward and backward), attention, flash
  attention (forward and backward), the latent trajectory, one latent
  MLP forward and the fused ResBlock shortcut, each a hand-written Hopper
  kernel (``csrc/``, bound in ``ops/cuda``) beside its plain PyTorch
  version, the int8 tier and the MMD. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises.
- ``train``: the clip + AdamW optimizer, the LR schedule, the train state,
  the train step and the checkpoints (``checkpoint``).
- ``data``: the datasets (the synthetic sets and the on-disk readers) and
  the loader that ships uint8 to the card.
- ``cli`` and ``runner`` (``python -m infodiffusion_tpu_torch <run.py
  flags>``): every mode of the JAX CLI, with ``imaging`` (PNG grids,
  written and read with the standard library) and ``logging_utils`` (the
  metrics JSONL).
- ``metrics``: FID and KID (``fid``, over the InceptionV3 of
  ``inception`` on the run's device) and the disentanglement metrics (DCI,
  TAD, the probe, ``auroc``); the entry points ``gen_fid_stats``,
  ``calc_fid`` and ``eval_disentanglement`` (``python -m
  infodiffusion_tpu_torch.<name>``).
- ``utils``: the prior draws, the slerp helpers, seeding and the console
  meters.
- ``pipelines``: ``InfoDiffusionPipeline`` (generate, encode, invert,
  reconstruct, traverse, interpolate; ``from_checkpoint``).
- ``interop``: ``from_jax_params`` moves a Flax param tree into the port's
  modules, which carry the same names.

Public functions keep the JAX package's layouts: images NHWC
``[B, H, W, C]``, attention inputs ``[B, N, C]``, latents ``[B, d]``.
This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
