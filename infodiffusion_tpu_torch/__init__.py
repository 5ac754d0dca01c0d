"""InfoDiffusion in PyTorch and CUDA: the port of ``infodiffusion_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and class names so each counterpart is found at once:

- ``nn``: time embeddings, the AdaGN ResBlocks, attention, resampling and
  the latent MLP block.
- ``models``: ``AuxiliaryUNet``, ``Encoder``, ``LatentUNet`` and the
  ``InfoDiff`` (eps prediction and the training loss) / ``Diff`` wrappers.
- ``diffusion``: the schedule, its step algebra and the samplers.
- ``ops``: GroupNorm+FiLM (forward and backward), attention, flash
  attention (forward and backward) and the latent trajectory, each a
  hand-written Hopper kernel (``csrc/``, bound in ``ops/cuda``) beside its
  plain PyTorch version, and the MMD. A CPU tensor takes the plain
  version; a CUDA tensor launches the kernel or raises.
- ``train``: the clip + AdamW optimizer, the LR schedule, the train state
  and the train step.
- ``utils``: the prior draws.
- ``pipelines``: ``InfoDiffusionPipeline.generate``.
- ``interop``: ``from_jax_params`` moves a Flax param tree into the port's
  modules, which carry the same names.

Public functions keep the JAX package's layouts: images NHWC
``[B, H, W, C]``, attention inputs ``[B, N, C]``, latents ``[B, d]``.
This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
