"""``tools.trace_summary`` on a hand-written Chrome trace with known kernel
events and gaps (exact categories, idle share and gaps), and the profile
tools on the CPU at a reduced size (their trace is written and
summarised)."""

from __future__ import annotations

import json

import pytest
import torch

from infodiffusion_tpu_torch.tools import profile_sampler, trace_summary


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


K1 = "void adagn::(anonymous namespace)::resident_kernel<__nv_bfloat16, 0>"
K1_BWD = "void adagn::(anonymous namespace)::stream_dx_kernel<__nv_bfloat16>"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
EW = "void at::native::vectorized_elementwise_kernel<4, at::native::add>"
K2 = "void (anonymous namespace)::strip_mma::strip_kernel<64>(...)"
TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {}},
    _x("PyTorch Profiler (0)", "Trace", 0, 100),
    _x("outer", "user_annotation", 0, 100),
    _x("aten::conv2d", "cpu_op", 0, 30),
    _x("aten::add", "cpu_op", 40, 20),
    _x("cudaLaunchKernel", "cuda_runtime", 5, 1),
    _x(K1, "kernel", 10, 10),
    _x(K1_BWD, "kernel", 15, 10),  # overlaps K1 on another stream
    _x(CONV, "kernel", 30, 5),
    _x(EW, "kernel", 35, 5),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 70, 10),
    _x(K2, "kernel", 90, 5),
]}


def test_summary_of_a_known_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    out = trace_summary.main([str(tmp_path), "--top", "3", "--gaps", "3"])
    assert out["trace"] == str(path)
    assert out["window_ms"] == pytest.approx(0.100)
    assert out["device_ms"] == pytest.approx(0.045)  # durations summed
    assert out["device_busy_ms"] == pytest.approx(0.040)  # their union
    assert out["idle_share"] == pytest.approx(0.6)
    assert out["device_events"] == 6
    assert out["by_category_ms"] == pytest.approx({
        "K1 adagn": 0.010, "K1-bwd adagn_bwd": 0.010, "cuDNN conv": 0.005,
        "elementwise": 0.005, "memcpy/memset": 0.010, "K2 attention": 0.005})
    assert [(t[0], t[2], t[3]) for t in out["top"]] == [
        (K1, 1, "K1 adagn"), (K1_BWD, 1, "K1-bwd adagn_bwd"),
        ("Memcpy HtoD (Pageable -> Device)", 1, "memcpy/memset")]
    # idle: [40, 70] during aten::add, [0, 10] during aten::conv2d, then
    # [80, 90] during only the outer range ([25, 30] and [95, 100] are 5)
    assert [(g["start_ms"], g["ms"], g["host_op"]) for g in out["gaps"]] \
        == pytest.approx([(0.040, 0.030, "aten::add"),
                          (0.080, 0.010, "outer"),
                          (0.0, 0.010, "aten::conv2d")])


@pytest.mark.parametrize("name,want", [
    ("void flash_bwd::rows_kernel<flash_bwd::RowsPlan<128, 2, 32, 1, 0>>",
     "K3b flash_attention_bwd"),
    ("void flash_wgmma::forward_kernel<flash_wgmma::Plan<128>>",
     "K3a flash_attention"),
    ("void (anonymous namespace)::fma_online::flash_online_kernel<128>",
     "K3c flash_attention_online"),
    ("void (anonymous namespace)::latent_traj_int8_kernel<64>",
     "K4 latent_traj"),
    ("void (anonymous namespace)::latent_mlp_bf16_kernel<64>",
     "K5 latent_mlp"),
    ("void (anonymous namespace)::shortcut_wgmma_kernel(Args)",
     "K6 shortcut_fused"),
    ("void qconv_wgmma::(anonymous namespace)::qconv_v2_kernel<64, 128>",
     "K7 qconv"),
    ("void int8_wgmma::(anonymous namespace)::conv_kernel<128, 64>",
     "int8 conv"),
    ("void adagn::(anonymous namespace)::params_kernel(BwdArgs)",
     "K1-bwd adagn_bwd"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
     "cuBLAS GEMM"),
    ("void at::native::reduce_kernel<512, 1>", "reduction"),
    ("Memset (Device)", "memcpy/memset"),
    ("void some_kernel<int>", "other"),
])
def test_categories_by_symbol(name, want):
    assert trace_summary.categorize(name) == want


def test_profile_sampler_writes_and_summarises_its_trace(tmp_path, capsys):
    out = tmp_path / "trace"
    row = profile_sampler.main(str(out), "cpu", batch=1, steps=1, size=16)
    assert (out / "trace.json").is_file()
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row
    assert row["device"] == "cpu" and row["summary"]["device_events"] == 0
    assert row["summary"]["idle_share"] == pytest.approx(1.0)
    with pytest.raises(FileNotFoundError):
        trace_summary.summarize_file(str(tmp_path / "none"))


def test_profile_step_reads_its_numbers_from_the_trace(tmp_path):
    """One definition of device time and idle share: ``profile_step``'s
    are ``summarize``'s of the trace it captured."""
    x = torch.ones(64, 64)
    out = tmp_path / "trace"
    prof = trace_summary.profile_step(lambda: x @ x, torch.device("cpu"),
                                      trace_dir=str(out))
    summary = trace_summary.summarize_file(str(out))
    assert prof["wall_ms"] > 0
    assert prof["device_ms"] == summary["device_ms"] == 0.0
    assert prof["idle"] == summary["idle_share"] == pytest.approx(1.0)
    assert prof["adagn_ms"] == 0.0 and prof["kernels"] == []
