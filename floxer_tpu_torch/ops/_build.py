"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The kernels have a plain C interface and are compiled with nvcc for
Hopper (sm_90a) into one shared library under build/floxer_tpu_torch_kernels/
at first use, then loaded with ctypes. The library name carries a hash of
the sources, so an edited kernel is never served from a stale build. A file
lock keeps concurrent processes from building the same library twice.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "floxer_tpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers and the stream as c_void_p);
# every entry returns cudaGetLastError() as an int
_SIGNATURES = {
    # vp0, planes0, texts, stream, scalars, T, band_words, text_words,
    # dist, end, stream
    "floxer_myers_banded": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # peq, plen, texts, tlen, B, num_words, num_text, dist, end, stream
    "floxer_myers_small": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # peq, plen, texts, tlen, B, words_padded, num_text, dist, end, stream
    "floxer_myers_large": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # windows, patterns, n_lens, m_lens, end_cols, distances, T, m_pad,
    # w_pad, n_pad, dirs, ops, num_ops, begin_cols, stream
    "floxer_traceback_banded": [
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
    ],
}

_lock = threading.Lock()
_library = None
last_build_seconds: float | None = None


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from floxer_tpu_torch/csrc at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for source in _sources():
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libfloxer_kernels_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile csrc/*.cu into `target` (under the build lock)."""
    global last_build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if target.exists():
                return
            started = time.monotonic()
            tmp = target.with_suffix(f".tmp{os.getpid()}.so")
            command = [
                _nvcc(), *NVCC_FLAGS,
                *[str(s) for s in _sources()], "-o", str(tmp),
            ]
            result = subprocess.run(command, capture_output=True, text=True)
            if result.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    "nvcc failed building the CUDA kernels:\n"
                    + result.stdout + result.stderr
                )
            os.replace(tmp, target)
            last_build_seconds = time.monotonic() - started
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises when the build or
    the load fails; there is no fallback."""
    global _library
    with _lock:
        if _library is None:
            target = library_path()
            if not target.exists():
                _build(target)
            library = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(library, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _library = library
        return _library


def launch(name: str, *args) -> None:
    """Call one C entry point; raise on a non-zero cudaError_t."""
    code = getattr(load_library(), name)(*args)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def check_operand(tensor, name: str, shape: tuple, dtype, device) -> None:
    """Validate one kernel operand (on either route, so the CPU tests
    catch what the CUDA kernel would refuse)."""
    if tensor.device != device:
        raise ValueError(f"{name}: on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}"
        )
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
