"""Generation's share of the card's dense bf16 peak: the model FLOPs of
one image (DDIM's forwards, and the prior's trajectory for InfoDiff;
``benchmark/counts/flops.py``) times the traced run's images per second,
in percent."""

from benchmark.counts import flops


def read(ctx):
    peak = ctx["peak"]
    if not peak:
        return None
    g = flops.gen_gflop(ctx["config"])
    return 100.0 * g * 1e9 * ctx["layer"]["rate"] / peak["bf16_flops_per_s"]
