"""Every file of the benchmark parses and is found by the name
``BENCHMARK.json`` gives it, and ``BENCHMARK.json`` keeps to its format."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark import harness as H

BENCH = Path(__file__).resolve().parents[1]
SPEC = H.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((BENCH.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] == 1


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"train_imgs_per_s", "train_step_ms_p90",
                        "gen_imgs_per_s", "gen_step_ms_p95", "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_what_their_cells_report():
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for cell in m["workloads"]:
            reported = [e["name"] for e in H.cell_metrics(SPEC, cell,
                                                          "end_to_end")]
            assert m["moves"] in reported, (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert callable(H.metric_reader(m["name"]).read)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in H.cell_metrics(SPEC, cell, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert H.cell_metrics(SPEC, cell, "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    files = H.cell_files(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    for key in ("config", "traffic", "chips", "why"):
        assert files["cell"][key] == entry[key]
    assert files["config"]["name"] == entry["config"]
    kind = H.traffic_kind(files["traffic"]["kind"])
    assert hasattr(kind, "Traffic")
    for key in ("setup", "window", "profile", "check", "layer_data"):
        assert callable(getattr(kind.Traffic, key))
    assert files["cell"]["limits"]


def test_configs_are_used_and_named():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((BENCH.parent / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert c["reduced"] == []
        assert "assumed" in body


def test_pairs_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_peaks_table():
    peaks = H.load_json(BENCH / "peaks.json")
    h100 = peaks["NVIDIA H100 80GB HBM3"]
    assert h100["bf16_flops_per_s"] == 989e12
    assert h100["hbm_bytes_per_s"] == 3.35e12
