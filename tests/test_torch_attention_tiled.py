"""K2', the attention microbenchmark's batch-tiled variant, and the port's
two attention tools, on the CPU: K2's plain version against the tool's
``_tiled_kernel`` under ``pl.pallas_call`` (interpret mode) with the tool's
BlockSpecs, in f32 and bf16; the tools at tiny shapes with ``device='cpu'``,
and refusing to run without a card otherwise. Inputs from numpy seeds."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from infodiffusion_tpu_torch.ops.cuda.attention import (
    attention_reference,
    attention_tiled_cuda,
    attention_tiled_reference,
)
from infodiffusion_tpu_torch.tools import flash_attn_bench, microbench_attention
from tools.microbench_attention import _tiled_kernel
from torch_parity import OP_TOL, assert_close, tensor

torch.set_num_threads(2)

# f32: summation order; bf16: the output's one rounding (w stays f32)
TILED_TOL = {"float32": OP_TOL, "bfloat16": 1e-2}


def _tiled_pallas(q, k, v, tb):
    """The tool's ``attention_pallas_tiled``, in interpret mode."""
    B, N, C = q.shape
    spec = pl.BlockSpec((tb, N, C), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(_tiled_kernel, scale=float(C) ** -0.5),
        grid=(B // tb,), in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((B, N, C), v.dtype), interpret=True,
    )(q, k, v)


@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_plain_matches_pallas(dtype, C):
    rng = np.random.RandomState(80 + C)
    q, k, v = (rng.randn(16, 64, C).astype(np.float32) for _ in range(3))
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = _tiled_pallas(*(jnp.asarray(t, jdt) for t in (q, k, v)), tb=8)
    got = attention_tiled_reference(*(tensor(t).to(pdt) for t in (q, k, v)),
                                    tb=8)
    assert got.dtype == pdt
    assert_close(got.float(), np.asarray(want, np.float32), TILED_TOL[dtype],
                 "K2' plain")
    if dtype == "float32":  # K2's function in f32
        assert_close(got, attention_reference(tensor(q), tensor(k),
                                              tensor(v)).numpy(), OP_TOL, "K2")


def test_tiled_refuses_what_the_tool_refuses():
    q = torch.zeros(12, 16, 128)
    with pytest.raises(ValueError, match="divide"):
        attention_tiled_reference(q, q, q, tb=8)
    with pytest.raises(ValueError, match="CUDA"):
        attention_tiled_cuda(torch.zeros(16, 16, 128), q[:1], q[:1])


def test_microbench_runs_on_the_cpu_when_asked(capsys):
    rows = microbench_attention.main("cpu", reps=2, shapes=((8, 16, 128),))
    assert [(r["dtype"], r["clock"]) for r in rows] == [
        ("float32", "host"), ("bfloat16", "host")]
    assert all(r[f"{v}_us"] > 0 for r in rows for v in
               ("plain", "k2", "k2_tiled"))
    assert "k2_tiled" in capsys.readouterr().out


@pytest.mark.parametrize("grad", ["0", "1"])
def test_flash_attn_bench_runs_on_the_cpu_when_asked(monkeypatch, capsys,
                                                     grad):
    monkeypatch.setenv("INFODIFF_FAB_CONFIGS", "64x2,128x1")
    monkeypatch.setenv("INFODIFF_FAB_REPS", "3")
    monkeypatch.setenv("INFODIFF_FAB_DTYPE", "f32")
    monkeypatch.setenv("INFODIFF_FAB_GRAD", grad)
    lines = flash_attn_bench.main("cpu")
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == lines and [(x["N"], x["B"]) for x in lines] == [
        (64, 2), (128, 1)]
    for x in lines:
        assert x["route"] == "flash" and x["clock"] == "host"
        assert x["grad"] == (grad == "1") and x["max_abs_diff"] < 1e-5
        assert x["significant"] == flash_attn_bench.significant(
            x["xla_ms"], x["flash_ms"], x["xla_spread_ms"],
            x["flash_spread_ms"])


def test_tools_need_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench_attention.main(reps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        flash_attn_bench.main()
