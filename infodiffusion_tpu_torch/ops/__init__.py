"""Hot-path ops: each a hand-written CUDA kernel beside its plain version.

``adagn`` / ``group_norm`` (ops/norm.py) run K1, ``single_head_attention``
(ops/attention.py) K2, and ``ops.cuda.latent_traj.latent_trajectory`` K4.
A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""
