"""The kernel wrappers: ``<name>_cuda`` launches ``csrc/<name>.cu`` and
counts its launches in ``<name>_cuda.launches``; ``<name>_reference`` is the
plain PyTorch version of the same function."""
