"""Build and load the package's CUDA sources at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface under ``_build/`` (git-ignored), named by a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags, and is bound with
``ctypes``; :func:`build_all` runs one ``nvcc`` per source, all at once.
Nothing is compiled or loaded when a module is imported: the CPU tests
import every module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# -Xptxas -v: each kernel's registers, shared memory and spills, kept in
# the build's log (build_log).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    cands = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                               f"{name}.cu:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_log(name: str) -> str:
    """What nvcc printed when it built ``csrc/<name>.cu`` (the ptxas
    report of each kernel), or "" for a library built elsewhere."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names) -> list[Path]:
    """:func:`build` of every name, one ``nvcc`` process each, in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
