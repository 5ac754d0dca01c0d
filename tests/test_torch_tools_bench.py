"""The decision logic of the port's measurement tools against the JAX
package's (``tools/latent_turbo_bench.py``'s ``significant`` and
``measure``, ``tools/turbo_fid_delta.py``'s ``tier_verdict``, as
``tests/test_bench_tools.py`` pins them), ``latent_turbo_bench`` on the
CPU at a reduced size, and ``memory_report``'s refusals: a typo in
``INFODIFF_MEMREPORT_PROGRAMS``, and no card."""

from __future__ import annotations

import importlib.util
import itertools
import os
import sys

import jax
import jax.numpy as jnp
import jax.random as jr
import pytest
import torch

from infodiffusion_tpu_torch.tools import (
    latent_turbo_bench,
    memory_report,
    turbo_fid_delta,
)

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


def _load(name):
    """A JAX ``tools/`` script, the suite's compile-cache directory
    restored afterwards (the scripts repoint it at import)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    cache_dir = jax.config.jax_compilation_cache_dir
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def jax_ltb():
    return _load("latent_turbo_bench")


@pytest.fixture(scope="module")
def jax_tfd():
    return _load("turbo_fid_delta")


# the pinned cases of tests/test_bench_tools.py and a grid around the
# boundary
SIG_CASES = [(33.68, 33.57, 1.16, 1.92), (75.16, 74.20, 2.32, 1.04),
             (90.3, 76.6, 2.0, 2.0), (76.6, 90.3, 2.0, 2.0),
             (10.0, 9.0, 0.5, 0.5)] + list(itertools.product(
                 (9.0, 10.0, 11.5), (10.0,), (0.25, 0.5, 1.0), (0.5, 1.0)))


def test_significant_matches_jax(jax_ltb):
    for case in SIG_CASES:
        assert latent_turbo_bench.significant(*case) \
            == jax_ltb.significant(*case), case


@pytest.mark.parametrize("durations", [
    [1.0, 2.0, 3.0, 4.0, 5.0], [5.0, 1.0, 4.0, 2.0], [2.5],
    [0.3, 0.1, 0.9, 0.4, 0.2, 0.8, 0.7]])
def test_measure_matches_jax(jax_ltb, durations):
    def clock_of():
        ticks = [0.0]
        for d in durations:
            ticks += [ticks[-1] + 1.0, ticks[-1] + 1.0 + d]
        return iter(ticks[1:]).__next__

    want = jax_ltb.measure(lambda k: jnp.zeros(()), jr.PRNGKey(0),
                           len(durations), clock=clock_of())
    got = latent_turbo_bench.measure(lambda i: None, len(durations),
                                     clock=clock_of())
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", [
    (1.0, 100.0, 0.0), (3.0, 100.0, -0.0002), (10.0, 100.0, 0.0),
    (4.0, 100.0, 0.5), (3.0001, 100.0, 0.0), (0.5, 2.0, 0.04),
    (0.5, 2.0, 0.06)])
def test_tier_verdict_matches_jax(jax_tfd, case):
    assert turbo_fid_delta.tier_verdict(*case) == jax_tfd.tier_verdict(*case)


def test_latent_turbo_bench_runs_on_the_cpu(capsys):
    rows = latent_turbo_bench.main("cpu", a_dims=(32, 20), reps=3, batch=2,
                                   T=10)
    k4, torch_route = rows
    assert k4["route"] == {"bf16": "k4", "int8": "k4"}
    assert k4["bf16_ms"] > 0 and k4["int8_ms"] > 0
    assert isinstance(k4["significant"], bool)
    assert 0 < k4["max_abs_diff"] < 0.1  # int8 weights, not other draws
    # the cluster core takes no a_dim 20: the line says so, nothing timed
    assert torch_route["route"] == {"bf16": "torch", "int8": "torch"}
    assert "bf16_ms" not in torch_route and "k4" in torch_route
    assert len(capsys.readouterr().out.splitlines()) == 2


def test_memory_report_refuses_a_typo_and_the_cpu(monkeypatch):
    monkeypatch.setenv("INFODIFF_MEMREPORT_PROGRAMS", "sample")
    with pytest.raises(SystemExit, match="sample"):
        memory_report.main()
    for programs, want in (("both", ["train", "sampler"]),
                           ("train", ["train"]), ("sampler", ["sampler"])):
        monkeypatch.setenv("INFODIFF_MEMREPORT_PROGRAMS", programs)
        assert memory_report.programs_from_env() == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(memory_report.NoCardError, match="CUDA"):
        memory_report.main()
