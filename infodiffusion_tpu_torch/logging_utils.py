"""Metrics and logging (JAX counterpart: ``infodiffusion_tpu/logging_utils.py``).

``MetricsWriter`` appends one JSON record a call to
``{log_dir}/metrics.jsonl`` (``step``, ``dt`` since the previous record and
``{prefix}/{name}`` per scalar: the JAX package's schema), and mirrors the
scalars to TensorBoard when ``use_tb`` is set and torch's writer imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, use_tb: bool = False, enabled: bool = True):
        """``enabled=False`` makes every method a no-op."""
        self.enabled = enabled
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None
        self._t_last = time.perf_counter()

    def write(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        if not self.enabled:
            return
        now = time.perf_counter()
        rec = {"step": step, "dt": now - self._t_last}
        self._t_last = now
        rec.update({f"{prefix}/{k}": float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def flush(self):
        if self._jsonl is not None:
            self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
