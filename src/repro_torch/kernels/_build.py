"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` exposes a plain C interface (no PyTorch
headers), so `nvcc` compiles it in seconds into a shared library that
`ctypes` loads.  Libraries go to `build/repro_torch/` at the root of the
checkout, named by a hash of the source and the flags, so an edited
source is never served a stale library.  Nothing is compiled at import:
a library is built the first time a wrapper launches its kernel, or
ahead of time by `build_all`, which starts one `nvcc` per source at once.

The C entry points return `cudaGetLastError()` (an int); `check` raises
on a non-zero code, since a refused launch never runs and a later
synchronise would not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: `nvcc` output (ptxas register/smem lines) of each library built here
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built on this machine")


def _target(name: str) -> Tuple[pathlib.Path, pathlib.Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    src, lib = _target(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, lib = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed on {name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)            # atomic: a reader never sees half a file


def build_all(names: Iterable[str]) -> None:
    """Compile the named sources in parallel (one nvcc each)."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        for n in names:
            _finish(n, started[n])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return _libs[name]


def check(lib: ctypes.CDLL, what: str, code: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")
