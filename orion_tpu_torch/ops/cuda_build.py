"""Build and load the port's CUDA kernels (``orion_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds, not minutes.
Libraries land in ``csrc/_build/`` (git-ignored) under a name that
carries a hash of the sources, so an edited source rebuilds and a
finished build is reused by every later process.  A failed build
raises; nothing falls back.

Nothing here runs at import: the CPU test suite imports every module on
a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
KERNELS = ("flash_fwd", "paged_decode", "flash_bwd_dq", "flash_bwd_dkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "cannot be built")


def _source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    for path in (_source(name), os.path.join(CSRC, "common.cuh")):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes started together.  Returns {name: build seconds} (0.0
    for a library already built).  Raises RuntimeError with the
    compiler's output on any failure.  The compiler's resource report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside
    each library as ``<library>.ptxas.txt``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    started = {}
    times = {}
    for name in names:
        out = _library_path(name)
        if os.path.exists(out):
            times[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        with open(out + ".ptxas.txt", "w") as f:
            f.write(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" +
                           "\n".join(failures))
    return times


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_library_path(name))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
