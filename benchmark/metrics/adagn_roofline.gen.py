"""K1 (``csrc/adagn.cu``) against its memory roofline in generation: the
bytes of every GroupNorm site of the traced batch's DDIM forwards
(``benchmark/counts/adagn.py``) at the card's HBM rate, over K1's device
time, in percent."""

from benchmark.counts import adagn


def read(ctx):
    tr, peak = ctx["trace"], ctx["peak"]
    if not tr or not peak:
        return None
    t = tr["by_category_s"].get("K1 adagn", 0.0)
    if t <= 0:
        return None
    cfg = ctx["config"]
    b = (adagn.forward_pass_bytes(cfg, ctx["traffic"]["batch_size"])
         * cfg["sampling_steps"] * tr["batches"])
    return 100.0 * b / peak["hbm_bytes_per_s"] / t
