"""The device trace of a traced run, reduced to what the per-layer metrics
read: device seconds by category, the busy time and the traced window,
the kernels that took the most device time, and the longest idle gaps with
the host operation that ran in each.

The categories are a frozen copy of the port's trace summary tool
(``tools/trace_summary.py``): each hand kernel by its symbols' names,
then the library kernels by words in theirs.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

HAND_KERNELS = (
    ("K1-bwd adagn_bwd", ("adagn::",), ("bwd_kernel", "stream_reduce_kernel",
                                        "stream_film_kernel",
                                        "stream_dx_kernel",
                                        "params_kernel")),
    ("K1 adagn", ("adagn::",), ()),
    ("K2 attention", ("strip_mma::", "fma_f32::"), ()),
    ("K3a flash_attention", ("flash_fwd_kernel", "flash_wgmma::",
                             "flash_mma::"), ()),
    ("K3b flash_attention_bwd", ("flash_bwd::", "fma_bwd::"), ()),
    ("K3c flash_attention_online", ("fma_online::",), ()),
    ("K4 latent_traj", ("latent_traj_",), ()),
    ("K5 latent_mlp", ("latent_mlp_",), ()),
    ("K6 shortcut_fused", ("shortcut_wgmma_kernel", "shortcut_f32_kernel"),
     ()),
    ("K7 qconv", ("qconv_v1_kernel", "qconv_v2_kernel"), ()),
    ("int8 conv", ("int8_wgmma::",), ()),
)
LIBRARY = (
    ("elementwise", ("elementwise", "foreach", "catarray")),
    ("cuDNN conv", ("fprop", "dgrad", "wgrad", "cudnn", "conv")),
    ("cuBLAS GEMM", ("gemm", "cublas", "cutlass", "nvjet")),
    ("reduction", ("reduce", "norm", "softmax", "scan")),
)


def categorize(name: str, cat: str = "kernel") -> str:
    if cat in ("gpu_memcpy", "gpu_memset") or name.startswith(("Memcpy",
                                                                "Memset")):
        return "memcpy/memset"
    for label, marks, also in HAND_KERNELS:
        if any(m in name for m in marks) and (
                not also or any(a in name for a in also)):
            return label
    low = name.lower()
    for label, marks in LIBRARY:
        if any(m in low for m in marks):
            return label
    return "other"


def _merge(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_op(ops, s: float, e: float) -> Optional[str]:
    """The innermost host op running at the gap's middle, else the one that
    overlaps it most."""
    mid = (s + e) / 2
    at_mid = [(oe - os_, name) for name, os_, oe in ops if os_ <= mid <= oe]
    if at_mid:
        return min(at_mid)[1]
    over = [(min(e, oe) - max(s, os_), -(oe - os_), name)
            for name, os_, oe in ops if min(e, oe) > max(s, os_)]
    return max(over)[2] if over else None


WINDOW_MARK = "benchmark.traced_window"


def summarize(trace: dict, top: int = 10) -> Dict:
    """Seconds throughout. The window is the span of the ``WINDOW_MARK``
    annotation the traced work ran under."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == WINDOW_MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise ValueError("the trace holds no window annotation")
    t0 = min(e["ts"] for e in marks)
    t1 = max(e["ts"] + e["dur"] for e in marks)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e["dur"] > t0]
    by_cat: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_cat[categorize(e["name"], e["cat"])] += e["dur"] / 1e6
        by_name[e["name"]] += e["dur"] / 1e6
    busy = _merge((max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                  for e in dev)
    busy_us = sum(e - s for s, e in busy)
    idle, edge = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            idle.append((s - edge, edge, s))
        edge = max(edge, e)
    ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op"]
    gaps = sorted(idle, reverse=True)[:top]
    return {
        "window_s": (t1 - t0) / 1e6,
        "busy_s": busy_us / 1e6,
        "by_category_s": dict(by_cat),
        "device_ops": [[n[:64], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[_host_op(ops, s, e) or "none", d / 1e6]
                      for d, s, e in gaps],
    }


def capture(run: Callable[[], None],
            warm: Optional[Callable[[], None]] = None) -> Dict:
    """Trace ``run()`` with torch.profiler, host and device, and summarize
    it; ``warm()`` runs first under the profiler but outside the traced
    window, so that the profiler's own start falls outside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm is not None:
            warm()
            torch.cuda.synchronize()
        with record_function(WINDOW_MARK):
            run()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return summarize(trace)
