"""The library's two documented entry points as scripts (JAX counterparts:
``examples/generate.py`` and ``examples/traverse.py``):
``python -m infodiffusion_tpu_torch.examples.<name> <run.py flags>``."""
