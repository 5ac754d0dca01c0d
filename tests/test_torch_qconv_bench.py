"""The K7 bench tool (``infodiffusion_tpu_torch.tools.qconv_bench``) on the
CPU at a reduced batch: it runs the plain versions at the chosen sites, the
printed lines are the returned rows, the default route it times computes
K7's function within the two routes' designed difference, and the card is
the default."""

from __future__ import annotations

import json

import pytest
import torch

from infodiffusion_tpu_torch.ops.cuda import qconv as K7
from infodiffusion_tpu_torch.tools import qconv_bench


def test_qconv_bench_runs_on_the_cpu_when_asked(capsys):
    rows = qconv_bench.main(device="cpu", batch=1, reps=1,
                            sites=["8x8-128+128-128", "16x16-128-128"])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["site"] for r in rows] == ["8x8-128+128-128", "16x16-128-128",
                                         "sum"]
    for r in rows:
        assert r["device"] == "cpu" and r["clock"] == "host"
        assert r["v1_ms"] > 0 and r["v2_ms"] > 0 and r["default_ms"] > 0
        assert r["bound_ms"] > 0
    assert rows[-1]["bound_ms"] == pytest.approx(
        rows[0]["bound_ms"] + rows[1]["bound_ms"])


def test_qconv_bench_default_route_is_k7s_function():
    """The default route (bf16 chain, then the int8 conv) against K7's
    plain version (f32 chain): the routes differ by design by one-unit int8
    flips where bf16 rounding moves a value across a rounding boundary."""
    _, H, W, splits, cout = qconv_bench.SITES[1]
    pieces, A, Bv, absmax, kernel, bias = qconv_bench.site_inputs(
        1, H, W, splits, cout, torch.device("cpu"))
    got = qconv_bench.default_route(absmax, kernel, bias, splits)(
        pieces, A, Bv).float()
    want = K7.qconv_reference(pieces, A, Bv, absmax, kernel, bias).float()
    assert got.shape == want.shape
    rel = ((got - want).norm() / want.norm()).item()
    assert rel < 5e-2


def test_qconv_bench_needs_the_card_unless_asked(monkeypatch):
    with pytest.raises(ValueError, match="unknown sites"):
        qconv_bench.main(device="cpu", batch=1, reps=1, sites=["9x9"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        qconv_bench.main(batch=1, reps=1)
