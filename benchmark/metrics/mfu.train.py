"""The whole train step's share of the card's dense bf16 peak: the model
FLOPs of a train image (``benchmark/counts/flops.py``, valid taps) times
the traced run's images per second, in percent."""

from benchmark.counts import flops


def read(ctx):
    peak = ctx["peak"]
    if not peak:
        return None
    cfg, rate = ctx["config"], ctx["layer"]["rate"]
    g = flops.train_gflop(cfg, ctx["traffic"]["batch_size"])
    return 100.0 * g * 1e9 * rate / peak["bf16_flops_per_s"]
