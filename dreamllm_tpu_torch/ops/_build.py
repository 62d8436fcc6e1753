"""Build and load the port's CUDA kernels (route: nvcc → shared library with
a C interface → ctypes).

Each ``csrc/*.cu`` compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/kernels/`` at
the repository root, a directory that ``.gitignore`` lists. The library name
carries a hash of its source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header rebuilds and an unchanged one loads
at once. Nothing is built when this module is imported: the first
CUDA launch of a kernel builds it, and :func:`build_all` builds every source
in parallel (one ``nvcc`` per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source name -> nvcc/ptxas output of its build


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # any source may include any of them
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(name).stem}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, temp output, target) or
    None when the library is already built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file


def build_all() -> list[str]:
    """Build every ``csrc/*.cu`` in parallel; returns the source names."""
    names = sorted(p.name for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
