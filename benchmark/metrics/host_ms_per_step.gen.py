"""Median host milliseconds between the starts of two DDIM steps of one
batch (``diffusion/samplers.py``: one forward and its update enqueued),
over the traced run's window."""

from benchmark.harness import median_or_none


def read(ctx):
    return median_or_none(ctx["layer"]["spans"].get("fwd_host_s"), 1e3)
