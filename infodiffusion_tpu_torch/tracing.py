"""Spans and counters of the port's hot path.

Spans time the phases of the program where they run, and are off unless
asked for. ``span(name)`` is a context manager: off, it hands back one
shared object that does nothing (one flag check, no clock, no torch
call); on, it takes the host clock on entry and exit, adds the duration
to the name's record (count, total, the latest ``KEEP`` durations) and,
while a profiler runs, enters ``torch.profiler.record_function(name)``, so
the span shows in any ``torch.profiler`` trace as a ``user_annotation`` on
the kernels' clock, and under ``torch.autograd.profiler.emit_nvtx()`` as
an NVTX range. While
on, a ``gc.callbacks`` hook records each garbage collection as the span
``host.gc``.

The spans, where the work happens:

- ``data.wait``: the train loop's wait for a batch (``data/loader.py``);
- ``train.forward``, ``train.backward``, ``train.optimizer``: the train
  step's draws and loss, its gradients, and the clip, AdamW and EMA
  (``train/step.py``);
- ``gen.ddim_step``: one DDIM step, the forward and the update
  (``diffusion/samplers.py``);
- ``gen.latent_prior``: the latent prior's trajectory (K4 or its loops);
- ``host.gc``: a garbage collection.

Tracing is on while any of these holds: ``INFODIFF_TRACE=1`` at import,
an ``enable()`` not yet matched by a ``disable()`` (the runner's
``INFODIFF_PROFILE`` capture, or a caller that reads ``snapshot()``).

``counts`` is the port's one counter tally, always on: ``count(name, n)``
adds to it from any thread. The image batcher counts ``decoded``,
``decode_s`` (the seconds of those calls), ``failed`` and ``written``
(``data/native.py``); the datasets count ``pil``, the images PIL decoded.

``snapshot()`` returns the spans and counters since the last ``reset()``,
with the CUDA caching allocator's calls over the same interval
(``alloc.device_allocs``, ``alloc.device_frees``, ``alloc.retries``:
``cudaMalloc`` and ``cudaFree`` calls and the retries after a failed one).
"""

from __future__ import annotations

import collections
import gc
import os
import threading
from time import perf_counter
from typing import Dict

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

KEEP = 16384  # durations kept per span name, for medians

# torch.cuda.memory_stats() key -> counter name
_ALLOC = {"num_device_alloc": "alloc.device_allocs",
          "num_device_free": "alloc.device_frees",
          "num_alloc_retries": "alloc.retries"}

counts: collections.Counter = collections.Counter()

# re-entrant: a collection can start, and the hook record, wherever the
# interpreter runs bytecode, this module's own locked code included
_LOCK = threading.RLock()
_records: Dict[str, "_Record"] = {}
_alloc0: Dict[str, int] = {}
_depth = 0
_on = False


class _Record:
    __slots__ = ("count", "total", "durations")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.durations = collections.deque(maxlen=KEEP)


def _add(name: str, seconds: float) -> None:
    with _LOCK:
        r = _records.get(name)
        if r is None:
            r = _records[name] = _Record()
        r.count += 1
        r.total += seconds
        r.durations.append(seconds)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _add(self.name, dt)
        return False


def span(name: str):
    """A context manager timing ``name`` while tracing is on."""
    if not _on:
        return _OFF
    return _Span(name)


def count(name: str, n=1) -> None:
    """Adds ``n`` to the counter ``name``."""
    with _LOCK:
        counts[name] += n


_gc_span = None


def _gc_hook(phase: str, info: dict) -> None:
    global _gc_span
    if phase == "start":
        _gc_span = _Span("host.gc")
        _gc_span.__enter__()
    elif _gc_span is not None:
        _gc_span.__exit__(None, None, None)
        _gc_span = None


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turns tracing on, until the matching ``disable()``."""
    global _depth, _on
    _depth += 1
    if not _on:
        _on = True
        gc.callbacks.append(_gc_hook)


def disable() -> None:
    """Undoes one ``enable()``; the last one turns tracing off and removes
    the collection hook."""
    global _depth, _on
    _depth = max(_depth - 1, 0)
    if _on and _depth == 0:
        _on = False
        if _gc_hook in gc.callbacks:
            gc.callbacks.remove(_gc_hook)


def _alloc_stats() -> Dict[str, int]:
    if not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in _ALLOC}


def reset() -> None:
    """Starts a new interval: clears the spans and counters and takes the
    allocator's counts as the new base."""
    with _LOCK:
        _records.clear()
        counts.clear()
        _alloc0.clear()
        _alloc0.update(_alloc_stats())


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "durations"}}, "counters":
    {...}}`` since the last ``reset()``; the allocator's counters on CUDA
    only."""
    with _LOCK:
        spans = {n: {"count": r.count, "total_s": r.total,
                     "durations": list(r.durations)}
                 for n, r in list(_records.items())}
        counters = dict(counts)
        base = dict(_alloc0)
    for key, value in _alloc_stats().items():
        counters[_ALLOC[key]] = value - base.get(key, 0)
    return {"spans": spans, "counters": counters}


exported = os.environ.get("INFODIFF_TRACE") == "1"
if exported:
    enable()
