"""Build and load the port's CUDA kernels (route (b): nvcc → plain-C
shared libraries loaded with ctypes).

Every `csrc/*.cu` is compiled into its own shared library under
build/torch_kernels/<tag>/ at the repository root, where <tag> hashes all
sources, headers and flags together: one edit anywhere rebuilds
everything, and a checkout never loads a stale library. At first use all
sources are compiled at once, one nvcc process each, so the build takes as
long as the slowest source. `build()` forces that and returns the seconds
it took; `library(stem)` returns the loaded library of `csrc/<stem>.cu`.

Nothing here runs when a module is imported: a CPU-only host (no nvcc)
imports the port and never builds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def _lib_path(src: str) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(), f"libmdl_{stem}.so")


def build() -> float:
    """Compile every source whose library is missing, all in parallel, and
    load them all; returns build seconds (0.0 when nothing was compiled)."""
    if _libs:
        return 0.0
    t0 = time.perf_counter()
    todo = [s for s in sources() if not os.path.exists(_lib_path(s))]
    if todo:
        os.makedirs(build_dir(), exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = f"{_lib_path(src)}.tmp{os.getpid()}"
            procs.append((src, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for src, tmp, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{err}")
            else:
                os.replace(tmp, _lib_path(src))
        if failed:
            raise RuntimeError("\n".join(failed))
    built = time.perf_counter() - t0 if todo else 0.0
    for src in sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        _libs[stem] = ctypes.CDLL(_lib_path(src))
    return built


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of csrc/<stem>.cu (building all at first use)."""
    build()
    return _libs[stem]
