"""The measured window runs only the loop and its marks: no thread, no
subprocess, no synchronize and no host statistics inside the loop of any
traffic kind's ``window``, nor in the loop body it calls."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
KINDS = sorted(p for p in TRAFFIC.glob("*.py"))

# calls that would put host work or a wait into the window
FORBIDDEN_CALLS = {"synchronize", "sync", "Thread", "Popen", "run",
                   "check_output", "system", "card_state", "item", "tolist",
                   "cpu", "numpy", "percentile", "median", "elapsed_time",
                   "ms", "print", "sleep"}
# the program's own wait for a batch's codes (runner._save_fid_batch)
ALLOWED = {"_wait_codes"}


def _calls(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            yield f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)


def _methods(tree):
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("path", KINDS, ids=lambda p: p.name)
def test_window_loop_is_quiet(path):
    tree = ast.parse(path.read_text())
    methods = _methods(tree)
    window = methods["window"]
    loops = [n for n in ast.walk(window) if isinstance(n, ast.While)]
    assert len(loops) == 1
    called = set(_calls(loops[0]))
    # the loop body's own methods, one level down
    for name in list(called):
        if name in methods and name not in ALLOWED and name != "window":
            called |= set(_calls(methods[name]))
    bad = (called & FORBIDDEN_CALLS) - ALLOWED
    assert not bad, f"{path.name}: {sorted(bad)} inside the window's loop"


def test_window_starts_no_thread_or_process(monkeypatch):
    """A tiny training window on the CPU with thread and process starts
    trapped after set-up: the window starts neither (the loader's producer
    thread starts with its epoch, in set-up)."""
    import subprocess
    import threading
    from unittest import mock

    import torch

    from benchmark import harness as H
    from benchmark.run import Run
    from benchmark.tests.tiny import patched_table, tiny_files

    files = tiny_files("vanilla64.train.b512")
    files["config"]["dataset_images"] = 256
    with patched_table(files):
        run = Run("vanilla64.train.b512", 5, 0.5, False,
                  torch.device("cpu"), files)
        t = H.traffic_kind("train").Traffic(run)
        t.setup()

        def trap(*a, **k):
            raise AssertionError("started inside the window")

        with mock.patch.object(threading.Thread, "start", trap), \
                mock.patch.object(subprocess, "Popen", trap):
            out = t.window()
    assert out["attempted"] >= 1
    t.it.close()
