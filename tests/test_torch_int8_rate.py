"""The int8 sampling-rate tool (``infodiffusion_tpu_torch.tools.int8_rate``)
on the CPU at a reduced image size: it samples, the printed lines are the
returned rows, and the card is the default."""

from __future__ import annotations

import json

import pytest
import torch

from infodiffusion_tpu_torch.tools import int8_rate


def test_int8_rate_runs_on_the_cpu_when_asked(capsys):
    rows = int8_rate.main(device="cpu", batch=1, steps=1, repeats=1, size=16)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows
    (row,) = rows
    assert row["device"] == "cpu"
    assert row["samples_per_s"] > 0 and row["finite"]


def test_int8_rate_needs_the_card_unless_asked(monkeypatch):
    with pytest.raises(ValueError, match="device time"):
        int8_rate.main(device="cpu", steps=1, repeats=1, profile=True,
                       size=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        int8_rate.main(steps=1, repeats=1, size=16)
