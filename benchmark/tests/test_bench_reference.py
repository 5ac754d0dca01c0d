"""The plain reference against the port at a tiny size on the CPU, float32
on both sides: a run of each cell through the harness compares them, and
every number it compares is at float32's rounding."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.tiny import patched_table, tiny_files

CELLS = ["infodiff64.train.b512", "vanilla64.train.b512",
         "infodiff64.gen.b512", "vanilla64.gen.b512"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_port(cell):
    files = tiny_files(cell)
    with patched_table(files):
        out = run_cell(cell, 2**31 + 11, 0.5, False, torch.device("cpu"),
                       files=files, t_start=time.perf_counter())
    assert out["correct"]
    assert out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] < 2e-4, (name, c)


def test_reference_draws_are_the_ports():
    """The step's draws made as the port makes them: the same t, noise and
    prior from the same (seed, step)."""
    from infodiffusion_tpu_torch.train.step import step_rngs

    from benchmark.reference import train as RT

    gens = RT.step_generators(2**31 + 3, 7, "cpu")
    rngs = step_rngs(2**31 + 3, 7, "cpu")
    for g, h in zip(gens, rngs):
        assert torch.equal(torch.randn(5, generator=g),
                           torch.randn(5, generator=h))
