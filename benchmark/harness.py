"""What every cell's run shares: finding the files of a cell by name, the
host's facts, the card's clocks and power beside the window, the
statistics, the readers of per-layer metrics and the result line.

Nothing here runs inside the measured window: the traffic kinds
(``benchmark/traffic/<kind>.py``) own the window's loop.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# modules that must not be loaded in a run, by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "infodiffusion_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> dict:
    """The workload ``name`` with its configuration and traffic mix, each
    read from its own file."""
    cell = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    if cell["name"] != name:
        raise ValueError(f"workload file {name}.json names {cell['name']}")
    cfg = load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return {"cell": cell, "config": cfg, "traffic": traffic}


def load_module(path: Path, name: str):
    """A benchmark module by file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(kind: str):
    return load_module(BENCH_DIR / "traffic" / f"{kind}.py",
                       f"benchmark_traffic_{kind}")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "benchmark_metric_" + name.replace(".", "_"))


def cell_metrics(spec: dict, cell: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those listing it, and those without a list whose end-to-end
    metric the cell reports."""
    e2e = [m["name"] for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    out = []
    for m in spec[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------


def percentile(values: List[float], p: float) -> float:
    """The ``p``-th percentile, linear between closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def median(values: List[float]) -> float:
    return percentile(values, 50.0)


# ---------------------------------------------------------------------------
# the host and the card
# ---------------------------------------------------------------------------


def cpu_model() -> str:
    """The first CPU's model name, or where a machine hides it, its vendor,
    family and model numbers (``/proc/cpuinfo``) and architecture."""
    fields: Dict[str, str] = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if not key and fields:
                    break
                fields.setdefault(key, value.strip())
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    ids = [fields.get("vendor_id", ""), fields.get("cpu family", ""),
           fields.get("model", "")]
    ids = " ".join(f"{k} {v}" for k, v in zip(("vendor", "family", "model"),
                                               ids) if v)
    return f"{ids or 'unknown'} ({platform.machine() or 'unknown'})"


class HostClock:
    """The process's CPU seconds against wall seconds over an interval."""

    def start(self):
        self.wall0 = time.perf_counter()
        self.cpu0 = time.process_time()

    def stop(self) -> Dict[str, float]:
        wall = time.perf_counter() - self.wall0
        cpu = time.process_time() - self.cpu0
        return {"window_wall_s": wall, "window_cpu_s": cpu}


def host_facts() -> Dict[str, object]:
    return {"cpus_in_affinity": len(os.sched_getaffinity(0)),
            "loadavg_1m_at_start": os.getloadavg()[0],
            "cpu_model": cpu_model()}


def card_state() -> Optional[Dict[str, str]]:
    """The card's name, SM clock, power draw and limit, temperature
    (``nvidia-smi``), or None where it cannot be read."""
    q = "name,clocks.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    first = out.strip().splitlines()[0] if out.strip() else ""
    keys = q.split(",")
    vals = [v.strip() for v in first.split(",")]
    return dict(zip(keys, vals)) if len(vals) == len(keys) else None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


class Marks:
    """Points in the device's timeline: CUDA events recorded on the
    current stream on the card, the host clock on the CPU (where every op
    has finished when it returns)."""

    def __init__(self, device):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self._torch = torch

    def mark(self):
        if self.cuda:
            e = self._torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def ms(self, a, b) -> float:
        """Milliseconds from mark ``a`` to mark ``b`` (after a sync)."""
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            self._torch.cuda.synchronize()


def mean_or_none(values, scale: float = 1.0) -> Optional[float]:
    return sum(values) / len(values) * scale if values else None


def median_or_none(values, scale: float = 1.0) -> Optional[float]:
    return median(values) * scale if values else None
