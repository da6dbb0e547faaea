"""Build-at-first-use for the port's CUDA sources (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface under ``access_control_srv_tpu_torch/_build/`` and is loaded with
``ctypes``.  The library name carries a hash of its source, so an edited
source builds anew and a stale library is never loaded.  A failed build
raises with nvcc's stderr; nothing falls back to another path.

``build(names)`` starts one nvcc per stale source, all at once, and waits
for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

# per source built in this process: nvcc's output, which carries ptxas's
# register and shared-memory report
BUILD_LOG: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Compile every stale source in ``names`` with one nvcc each, all
    started together; raises with nvcc's stderr if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, lib, tmp, proc))
    failures = []
    for name, lib, tmp, proc in jobs:
        out, err = proc.communicate()
        BUILD_LOG[name] = (out or "") + (err or "")
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader sees old or new
    if failures:
        raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib
