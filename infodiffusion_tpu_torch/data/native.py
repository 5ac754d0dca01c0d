"""The native image batcher and PNG writer
(JAX counterpart: ``infodiffusion_tpu/data/native.py``).

``infodiffusion_tpu_torch/native/image_loader.cpp`` (thread-pooled JPEG and
PNG decode with the dataset transforms fused in, and a thread-pooled PNG
writer) is compiled with ``g++`` at first use, into
``build/image_loader/<hash of the source and flags>/`` at the root of the
checkout: an edited source builds afresh, an unchanged one is reused. Two
builds are tried in turn, and ``backend()`` names the one that loaded:

- ``"libjpeg"``: JPEG through the system's libjpeg, the JAX package's and
  PIL's decoder, so a file decodes to the JAX batcher's bytes;
- ``"nvjpeg"``: where libjpeg's headers are absent (the card's machine),
  JPEG through nvJPEG from the CUDA toolkit, decoded on the card and
  copied back before the same transforms.

PNG is read and written with zlib in both. Each process compiles to a name
of its own and renames the result into place, so processes that build at
once never load a partial library. Nothing runs at import time.
``INFODIFF_DISABLE_NATIVE=1`` turns the library off; ``native_available()``
then reads False, as it does where neither build succeeds
(``build_error()`` says why).

``counts`` tallies what the library served in this process: images decoded
(``"decoded"``, with ``"decode_s"``, the seconds of those calls), slots that
failed (``"failed"``) and PNGs written (``"written"``); ``datasets.py``
adds the images it decoded through PIL instead (``"pil"``: the retried
slots, or every image where the library is off).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "image_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "image_loader"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

counts: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_STATE = {"lib": None, "backend": None, "error": None, "build_seconds": 0.0}


def _backends():
    """(name, compile flags, link flags) of each build, in the order
    tried."""
    yield "libjpeg", [], ["-ljpeg", "-lz", "-pthread"]
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is not None:
        lib = os.path.join(CUDA_HOME, "lib64")
        yield "nvjpeg", ["-DIDL_NVJPEG", f"-I{CUDA_HOME}/include"], [
            f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart", "-lz",
            "-pthread"]


def library_path(cflags, libs) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + cflags + libs).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libimage_loader.so"


def _build(path: Path, cflags, libs) -> None:
    """Compile to a per-process name, then rename into place (atomic)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}")
    cmd = ["g++", *CXX_FLAGS, *cflags, str(SOURCE), "-o", str(tmp), *libs]
    try:
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n"
                               f"{(done.stdout + done.stderr)[-2000:]}")
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _declare(lib) -> None:
    lib.idl_create.restype = ctypes.c_void_p
    lib.idl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.idl_destroy.restype = None
    lib.idl_destroy.argtypes = [ctypes.c_void_p]
    lib.idl_decode_batch.restype = ctypes.c_int
    lib.idl_decode_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_ubyte),
    ]
    lib.idl_write_png_batch.restype = ctypes.c_int
    lib.idl_write_png_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ubyte),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]


def _get_lib():
    """The loaded library, built on first use; None when it is turned off
    or no build succeeds (the reasons in ``build_error()``)."""
    if os.environ.get("INFODIFF_DISABLE_NATIVE"):
        return None
    with _LOCK:
        if _STATE["lib"] is not None or _STATE["error"] is not None:
            return _STATE["lib"]
        errors = []
        t0 = time.perf_counter()
        for name, cflags, libs in _backends():
            try:
                path = library_path(cflags, libs)
                if not path.exists():
                    _build(path, cflags, libs)
                lib = ctypes.CDLL(str(path))
            except (OSError, RuntimeError) as exc:
                errors.append(f"{name}: {type(exc).__name__}: {exc}")
                continue
            _declare(lib)
            _STATE.update(lib=lib, backend=name,
                          build_seconds=time.perf_counter() - t0)
            return lib
        _STATE["error"] = "\n".join(errors)
        return None


def backend() -> Optional[str]:
    """The build that loaded: "libjpeg" or "nvjpeg" (None when none
    did)."""
    _get_lib()
    return _STATE["backend"]


def native_available() -> bool:
    return _get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (None when it loaded or was not
    tried yet)."""
    if os.environ.get("INFODIFF_DISABLE_NATIVE"):
        return "INFODIFF_DISABLE_NATIVE is set"
    return _STATE["error"]


def build_seconds() -> float:
    """Seconds this process spent finding or compiling the library (a
    reused build takes a few milliseconds)."""
    return _STATE["build_seconds"]


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])


class NativeImageBatcher:
    """A native loader over a fixed file list: each ``decode`` turns a
    batch of indices into [b, size, size, 3] uint8 on the library's thread
    pool (``threads``; 0: one a core)."""

    def __init__(self, files: List[str], size: int, center_crop: bool,
                 d2c: bool, threads: int = 0):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native image loader unavailable: "
                               f"{build_error()}")
        self._lib = lib
        self.size = size
        self._files = _paths(files)  # the library keeps its own copies
        self._handle = lib.idl_create(self._files, len(files), size,
                                      int(center_crop), int(d2c), threads)

    def decode_with_failures(
            self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """([b, S, S, 3] uint8, positions of the failed slots). A failed
        slot (an index out of range, an unreadable file, a CMYK or YCCK
        JPEG, a truncated stream) is zero-filled; the caller retries it or
        raises."""
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        b = len(idx)
        out = np.empty((b, self.size, self.size, 3), np.uint8)
        failed = np.zeros(b, np.uint8)
        t0 = time.perf_counter()
        self._lib.idl_decode_batch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            b, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            failed.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        bad = np.flatnonzero(failed)
        counts.update(decoded=b - len(bad), failed=len(bad),
                      decode_s=time.perf_counter() - t0)
        return out, bad

    def decode(self, idx: np.ndarray) -> np.ndarray:
        out, failed = self.decode_with_failures(idx)
        if len(failed):
            raise IOError(f"native loader: {len(failed)}/{len(out)} images "
                          f"failed to decode")
        return out

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.idl_destroy(handle)
            self._handle = None


def write_png_batch(paths: Sequence[str], batch_u8: np.ndarray,
                    threads: int = 0) -> bool:
    """Write [B, H, W, C] uint8 (C 1 or 3) as one PNG per image on the
    library's thread pool. False when the library is unavailable or the
    batch is not one it writes (the caller writes it another way); raises
    IOError when a file fails."""
    lib = _get_lib()
    if lib is None:
        return False
    batch_u8 = np.ascontiguousarray(batch_u8, dtype=np.uint8)
    if batch_u8.ndim != 4 or batch_u8.shape[-1] not in (1, 3) \
            or len(paths) != len(batch_u8):
        return False
    b, h, w, c = batch_u8.shape
    fails = lib.idl_write_png_batch(
        _paths(paths), batch_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        b, h, w, c, threads)
    if fails:
        raise IOError(f"native png writer: {fails}/{b} failed")
    counts.update(written=b)
    return True
