"""The training-rate tool (``infodiffusion_tpu_torch.tools.train_rate``) on
the CPU at a reduced image size: each model trains, the printed lines are
the returned rows, and the card is the default."""

from __future__ import annotations

import json
import math

import pytest
import torch

from infodiffusion_tpu_torch.tools import train_rate


@pytest.mark.parametrize("model", train_rate.MODELS)
def test_train_rate_runs_on_the_cpu_when_asked(capsys, model):
    rows = train_rate.main(model, device="cpu", batch=1, steps=1, repeats=2,
                           size=32)
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["repeat"] for r in rows] == [0, 1]
    for r in rows:
        assert r["model"] == model and r["device"] == "cpu"
        assert r["imgs_per_s"] > 0 and math.isfinite(r["loss"])


def test_train_rate_needs_the_card_unless_asked(monkeypatch):
    with pytest.raises(ValueError, match="device time"):
        train_rate.main("vae", device="cpu", steps=1, repeats=1,
                        profile=True, size=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_rate.main("vae", steps=1, repeats=1)
