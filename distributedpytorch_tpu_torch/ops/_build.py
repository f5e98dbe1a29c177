"""Build and load the port's native libraries (``csrc/``).

A CUDA source (``csrc/<name>.cu``, the hand-written kernels) is compiled by
``nvcc`` for ``sm_90a``, a C++ source (``csrc/<name>.cpp``, the host image
ops) by the host C++ compiler (``$CXX``, else ``c++`` or ``g++`` on
``PATH``: nvcc's own host compiler).  Each becomes a shared library with a
plain C interface, loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds, not minutes.  Builds happen at first use, from the
sources in the checkout only, into ``build/kernels/`` beside the package;
the library's file name carries a hash of its source and flags, so an
edited source is never served by a stale build, and a library the checkout
did not build is never loaded.  A failed build raises.  This module imports
only the standard library, and nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
#: no fused multiply-adds: the host ops round as their numpy forms do
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: seconds each source took to compile in this process (0.0 when reused)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the CUDA kernels are built from source at first use")
    return found


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on ``PATH``."""
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(cand) if cand else None
        if found:
            return found
    raise RuntimeError(
        "no C++ compiler found ($CXX, c++ or g++ on PATH): the host image "
        "ops are built from source at first use")


def _source(name: str) -> tuple[Path, bool]:
    """``csrc/<name>.cu`` (CUDA) or ``csrc/<name>.cpp`` (host C++)."""
    cuda = CSRC / f"{name}.cu"
    return (cuda, True) if cuda.exists() else (CSRC / f"{name}.cpp", False)


def _library_path(name: str) -> Path:
    src, cuda = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    if cuda:
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS if cuda else CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _compile(name: str) -> Path:
    out = _library_path(name)
    if out.exists():
        build_seconds[name] = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src, cuda = _source(name)
    cmd = [find_nvcc(), *NVCC_FLAGS] if cuda else [find_cxx(), *CXX_FLAGS]
    cmd += ["-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {src.name} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    build_seconds[name] = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def build(names: tuple[str, ...]) -> dict[str, ctypes.CDLL]:
    """Compile (one compiler process per source, all started together) and
    load the named ``csrc/`` libraries; already-loaded ones are reused."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            with ThreadPoolExecutor(max_workers=len(todo)) as pool:
                paths = list(pool.map(_compile, todo))
            for name, path in zip(todo, paths):
                _libs[name] = ctypes.CDLL(str(path))
        return {n: _libs[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on
    first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build((name,))[name]
