"""K1 and K1-bwd (``csrc/adagn.cu``, ``csrc/adagn_bwd.cu``) against their
memory roofline in training: the bytes of every GroupNorm site of the
traced steps (``benchmark/counts/adagn.py``) at the card's HBM rate, over
the kernels' device time, in percent."""

from benchmark.counts import adagn


def read(ctx):
    tr, peak = ctx["trace"], ctx["peak"]
    if not tr or not peak:
        return None
    cats = tr["by_category_s"]
    t = cats.get("K1 adagn", 0.0) + cats.get("K1-bwd adagn_bwd", 0.0)
    if t <= 0:
        return None
    b = adagn.train_step_bytes(ctx["config"], ctx["traffic"]["batch_size"])
    return 100.0 * b * tr["steps"] / peak["hbm_bytes_per_s"] / t
