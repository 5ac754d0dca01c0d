"""Build and load the hand-written kernels in ``infodiffusion_tpu_torch/csrc``.

At first use ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, then links the objects into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds), which ``ctypes`` loads. The library lands in
``build/torch_kernels/<hash of the sources>/`` at the root of the checkout,
so an edited source triggers a fresh build and an unchanged one is reused.
Nothing here runs at import time: a machine without ``nvcc`` or a card can
import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of the kernels' entry points (csrc/*.cu)
_SIGNATURES = {
    "infodiff_adagn": [_P, _P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    "infodiff_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "infodiff_latent_traj": [_P] * 9 + [_I] * 6 + [_P],
    "infodiff_adagn_bwd": [_P] * 13 + [_I] * 10 + [_P],
    "infodiff_flash_attention": [_P] * 4 + [_I] * 4 + [_P],
    "infodiff_flash_attention_bwd": [_P] * 8 + [_I] * 4 + [_P],
}

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libinfodiff_kernels.so"


class Library:
    """The loaded kernel library: ``lib`` (ctypes), the seconds its build
    took (0.0 when an earlier build was reused) and the compiler's log."""

    def __init__(self):
        path = library_path()
        self.build_seconds = 0.0
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            self._build(path)
            self.build_seconds = time.perf_counter() - t0
        self.build_log = (path.parent / "build.log").read_text()
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.lib.infodiff_error_string.argtypes = [_I]
        self.lib.infodiff_error_string.restype = ctypes.c_char_p

    @staticmethod
    def _build(path: Path) -> None:
        """Compile each source in its own nvcc process, in parallel, then
        link; the log of every step goes to ``build.log``."""
        tmpdir = Path(tempfile.mkdtemp(dir=path.parent))
        try:
            Library._compile_and_link(tmpdir, path)
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)

    @staticmethod
    def _compile_and_link(tmpdir: Path, path: Path) -> None:
        sources = sorted(CSRC.glob("*.cu"))
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(tmpdir / f"{p.stem}.o"),
                 str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p in sources
        ]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [(p.name, log) for p, proc, log in zip(sources, procs, logs)
                  if proc.returncode != 0]
        if not failed:
            tmp = tmpdir / path.name
            link = subprocess.run(
                [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                 *[str(tmpdir / f"{p.stem}.o") for p in sources]],
                capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(("link", logs[-1]))
        (path.parent / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name}:\n{log[-4000:]}" for name, log in failed))
        os.replace(tmpdir / path.name, path)


@functools.lru_cache(maxsize=None)
def library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    return Library()


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        msg = library().lib.infodiff_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_tensor(t: torch.Tensor, name: str, *, shape=None, dtypes=None,
                 device=None) -> None:
    """Reject what a kernel does not take: device, dtype, shape, layout."""
    if not t.is_cuda:
        raise ValueError(f"{name}: a CUDA tensor is required, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")
