"""The port's spans and counters (``infodiffusion_tpu_torch/tracing.py``)
on a tiny vanilla Diff on the CPU (8x8, ch 32, ch_mult (1, 2), batch 2):
off, a span makes no clock or profiler call; on, each phase of the train
step, each DDIM step and each wait for a batch is one span, a garbage
collection is ``host.gc``, the spans show in a ``torch.profiler`` trace,
``reset()`` starts a new interval and ``INFODIFF_TRACE=1`` makes the
runner's train loop write them to ``metrics.jsonl``."""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from infodiffusion_tpu_torch import runner, tracing
from infodiffusion_tpu_torch.data.datasets import ArrayDataset
from infodiffusion_tpu_torch.data.loader import DataLoader
from infodiffusion_tpu_torch.diffusion.samplers import strided_ddim_loop
from infodiffusion_tpu_torch.diffusion.schedule import make_schedule
from infodiffusion_tpu_torch.logging_utils import MetricsWriter
from infodiffusion_tpu_torch.models.wrappers import Diff
from infodiffusion_tpu_torch.train.state import (
    create_train_state,
    make_optimizer,
)
from infodiffusion_tpu_torch.train.step import make_train_step

torch.set_num_threads(2)

T, SIZE, B = 20, 8, 2
TRAIN_SPANS = ["train.forward", "train.backward", "train.optimizer"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model():
    torch.manual_seed(0)
    return Diff(T, (3, SIZE, SIZE), unets_channels=32, attn=(1,),
                ch_mult=(1, 2), num_res_blocks=1)


def _train_parts(ema: bool = True):
    model = _model().train()
    tx = make_optimizer(1e-4, 1, 10)
    state = create_train_state(model, 0, tx, ema=ema)
    return state, make_train_step(model, tx, ema_decay=0.9 if ema else 0.0)


def _train(steps: int):
    state, step_fn = _train_parts()
    x = torch.rand(B, SIZE, SIZE, 3) * 2 - 1
    for _ in range(steps):
        state, _ = step_fn(state, x)


@torch.no_grad()
def _ddim(num_steps: int):
    model = _model().eval()
    sched = make_schedule(1e-5, 1e-2, T, "cpu")
    strided_ddim_loop(lambda x, t, a: model(x, t), sched,
                      torch.randn(B, SIZE, SIZE, 3), num_steps=num_steps)


def _loader(n_batches: int):
    images = np.random.RandomState(0).randint(
        0, 256, (n_batches * B, SIZE, SIZE, 3), dtype=np.uint8)
    return DataLoader(ArrayDataset(images), B, device="cpu", shuffle=True,
                      flip=True, seed=3)


@pytest.fixture
def traced():
    """Tracing on, from a clean interval, and off again after."""
    tracing.enable()
    tracing.reset()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()


@pytest.fixture
def order(monkeypatch):
    """The names of the spans in the order they close."""
    seen = []
    add = tracing._add

    def record(name, seconds):
        seen.append(name)
        add(name, seconds)

    monkeypatch.setattr(tracing, "_add", record)
    return seen


@pytest.mark.parametrize("work", [lambda: _train(1), lambda: _ddim(3)],
                         ids=["train_step", "ddim_3_steps"])
def test_off_makes_no_clock_or_profiler_call(work):
    assert not tracing.enabled()
    clock, rf = mock.Mock(return_value=0.0), mock.MagicMock()
    with mock.patch.object(tracing, "perf_counter", clock), \
            mock.patch.object(tracing, "record_function", rf):
        work()
    assert clock.call_count == 0 and rf.call_count == 0
    assert tracing.span("train.forward") is tracing.span("gen.ddim_step")


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_spans_in_order(traced, order, steps):
    _train(steps)
    train = [n for n in order if n.startswith("train.")]
    assert train == TRAIN_SPANS * steps
    snap = tracing.snapshot()["spans"]
    for name in TRAIN_SPANS:
        assert snap[name]["count"] == steps
        assert len(snap[name]["durations"]) == steps
        assert snap[name]["total_s"] == pytest.approx(
            sum(snap[name]["durations"]))
        assert all(d > 0 for d in snap[name]["durations"])


@pytest.mark.parametrize("num_steps", [1, 3, 5])
def test_one_ddim_span_per_step(traced, num_steps):
    _ddim(num_steps)
    assert tracing.snapshot()["spans"]["gen.ddim_step"]["count"] == num_steps


@pytest.mark.parametrize("taken", [1, 4])
def test_one_wait_per_batch_taken(traced, taken):
    it = iter(_loader(6))
    for _ in range(taken):
        next(it)
    it.close()
    assert tracing.snapshot()["spans"]["data.wait"]["count"] == taken


def test_gc_is_a_span(traced):
    gc.collect()
    gc.collect()
    rec = tracing.snapshot()["spans"]["host.gc"]
    assert rec["count"] >= 2 and rec["total_s"] > 0
    tracing.disable()
    tracing.reset()
    gc.collect()
    assert "host.gc" not in tracing.snapshot()["spans"]
    tracing.enable()


def test_spans_are_user_annotations_around_their_ops(traced):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(1)
        _ddim(2)
    events = [e for e in prof.events()]
    spans = {}
    for e in events:
        if e.name in TRAIN_SPANS + ["gen.ddim_step"]:
            spans.setdefault(e.name, []).append(e)
    assert {n: len(v) for n, v in spans.items()} == {
        "train.forward": 1, "train.backward": 1, "train.optimizer": 1,
        "gen.ddim_step": 2}

    def inside(op, name):
        s = spans[name][0].time_range
        return any(e.name == op and s.start <= e.time_range.start
                   and e.time_range.end <= s.end for e in events)

    assert inside("aten::convolution", "train.forward")
    assert inside("aten::_foreach_mul_", "train.optimizer")
    assert inside("aten::convolution", "gen.ddim_step")
    assert not inside("aten::_foreach_mul_", "train.forward")


def test_reset_clears_spans_and_counters(traced):
    with tracing.span("x"):
        pass
    tracing.count("decoded", 3)
    tracing.count("decode_s", 0.5)
    snap = tracing.snapshot()
    assert snap["spans"]["x"]["count"] == 1
    assert snap["counters"] == {"decoded": 3, "decode_s": 0.5}
    tracing.reset()
    assert tracing.snapshot() == {"spans": {}, "counters": {}}


def test_counters_count_while_tracing_is_off():
    assert not tracing.enabled()
    before = tracing.counts["written"]
    tracing.count("written", 8)
    assert tracing.counts["written"] == before + 8


def test_enable_and_disable_nest():
    tracing.enable()
    tracing.enable()
    tracing.disable()
    assert tracing.enabled()
    tracing.disable()
    assert not tracing.enabled()
    assert tracing._gc_hook not in gc.callbacks


@pytest.mark.parametrize("value,on", [("1", True), ("0", False)])
def test_environment_read_at_import(value, on):
    code = ("from infodiffusion_tpu_torch import tracing as t; "
            "print(t.enabled(), t.exported)")
    env = dict(os.environ, INFODIFF_TRACE=value, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=120, check=True)
    assert out.stdout.split() == [str(on), str(on)]


@pytest.mark.parametrize("exported", [True, False])
def test_train_loop_writes_trace_metrics(tmp_path, monkeypatch, exported):
    monkeypatch.setenv("INFODIFF_LOG_EVERY", "2")
    monkeypatch.setattr(tracing, "exported", exported)
    if exported:
        tracing.enable()
    try:
        state, step_fn = _train_parts(ema=False)
        cfg = SimpleNamespace(epochs=1, save_epochs=2, async_ckpt=False,
                              keep_checkpoints=0)
        writer = MetricsWriter(str(tmp_path))
        runner._train_loop(cfg, _loader(4), state, step_fn, (0, 0), writer,
                           str(tmp_path / "ckpt"), torch.device("cpu"))
    finally:
        if exported:
            tracing.disable()
        tracing.reset()
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    trace = [r for r in recs if any(k.startswith("trace/") for k in r)]
    train = [r for r in recs if "train/loss" in r]
    assert len(train) == 2  # batches 0 and 2 of 4
    if not exported:
        assert trace == []
        return
    assert len(trace) == 2
    first = trace[0]
    for name in TRAIN_SPANS + ["data.wait"]:
        assert first[f"trace/{name}.count"] == 1
        assert first[f"trace/{name}.mean_ms"] > 0
    # the second interval: batches 1 and 2, after the reset
    assert trace[1]["trace/train.forward.count"] == 2
