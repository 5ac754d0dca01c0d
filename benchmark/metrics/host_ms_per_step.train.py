"""Median host milliseconds to enqueue one train step (``train/step.py``
and ``train/state.py``: the loss, its backward and the optimizer), no
synchronize inside, over the traced run's window."""

from benchmark.harness import median_or_none


def read(ctx):
    return median_or_none(ctx["layer"]["spans"].get("step_host_s"), 1e3)
