"""Parallel layouts over ``torch.distributed``
(JAX counterpart: ``infodiffusion_tpu/parallel/``).

- ``multihost``: the process group (``maybe_initialize``; torchrun's
  environment, ``--multihost``), each rank's rows of the global batch,
  the preemption agreement;
- ``mesh``: the ``(data, model)`` device mesh and the axis names;
- ``batch``: global-batch semantics on one rank's rows (the draws, the
  means and the MMD's gather) and the autograd-aware collectives;
- ``fsdp`` / ``tp``: the JAX placement rules, parameter by parameter;
- ``layout``: a train state laid out by those rules (data parallel, FSDP,
  tensor parallel, both) and the step's gradient reduction and clip;
- ``ring_attention`` / ``sp``: attention split over tokens under ``--sp``;
- ``pp``: GPipe over the LatentUNet's middle layers under ``--pp``;
- ``launch``: N local ranks as subprocesses (the CPU tests, the dry run).

One process is one device (the JAX package drives several devices from one
process). No module here imports jax.
"""
