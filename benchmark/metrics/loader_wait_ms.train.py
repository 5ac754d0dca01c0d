"""Mean host milliseconds the train loop waited in the loader's ``next()``
(the data layer, ``data/loader.py``), over the traced run's window."""

from benchmark.harness import mean_or_none


def read(ctx):
    return mean_or_none(ctx["layer"]["spans"].get("loader_wait_s"), 1e3)
