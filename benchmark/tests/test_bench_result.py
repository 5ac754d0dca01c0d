"""The result line's format: the keys the driver reads, the compared
numbers last, each beside its limit, and the per-layer metrics of a
traced run."""

from __future__ import annotations

import json
import time

import torch

from benchmark import harness as H
from benchmark.run import per_layer, run_cell
from benchmark.tests.tiny import patched_table, tiny_files


def test_last_line_format():
    cell = "vanilla64.gen.b512"
    files = tiny_files(cell)
    with patched_table(files):
        out = run_cell(cell, 12345, 0.3, False, torch.device("cpu"),
                       files=files, t_start=time.perf_counter())
    line = H.result_line(out["correct"], out["attempted"], out["failed"],
                         out["metrics"], out["device"], out["checks"])
    got = json.loads(line)
    assert list(got) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert got["correct"] is True and got["failed"] == 0
    assert got["attempted"] > 0
    assert set(got["metrics"]) == {"gen_imgs_per_s", "gen_step_ms_p95",
                                   "setup_s"}
    for m in got["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(got["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert got["checks"] == {"image_gap": got["checks"]["image_gap"]}
    assert set(got["checks"]["image_gap"]) == {"value", "limit"}


def test_per_layer_readers_on_a_trace_summary():
    """The readers on a made-up trace of one training step: shares from
    the counts, None where nothing was traced."""
    spec = H.benchmark_spec()
    files = H.cell_files("vanilla64.train.b512")
    summary = {"window_s": 1.0, "busy_s": 0.6, "steps": 2,
               "by_category_s": {"K1 adagn": 0.01, "K1-bwd adagn_bwd": 0.02}}
    ctx = {"layer": {"spans": {"step_host_s": [0.2, 0.22, 0.21],
                               "loader_wait_s": [0.0, 0.001, 0.002]},
                     "rate": 2000.0, "batch": 512},
           "trace": summary, "config": files["config"],
           "traffic": files["traffic"],
           "peak": {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}}
    got = per_layer(spec, "vanilla64.train.b512", ctx)
    assert set(got) == {"loader_wait_ms.train", "host_ms_per_step.train",
                        "adagn_roofline.train", "mfu.train",
                        "idle_share.train"}
    assert abs(got["idle_share.train"]["value"] - 40.0) < 1e-9
    assert abs(got["host_ms_per_step.train"]["value"] - 210.0) < 1e-9
    assert abs(got["loader_wait_ms.train"]["value"] - 1.0) < 1e-9
    ctx["trace"] = None
    got = per_layer(spec, "vanilla64.train.b512", ctx)
    assert "idle_share.train" not in got and "adagn_roofline.train" not in got
