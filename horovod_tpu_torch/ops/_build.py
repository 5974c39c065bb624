"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each source under ``horovod_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process (all started together) into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The libraries land in ``build/horovod_tpu_torch/`` beside the package
(a directory ``.gitignore`` lists), named by a hash of the source, so an
edited source is rebuilt and an unchanged one is loaded as is.  Nothing
here runs at import: the CPU tests import every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "horovod_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the kernel sources this package builds (one library each)
SOURCES = ("flash_fwd.cu",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: wall seconds of the last build that compiled anything, and the
#: compiler's messages (``-Xptxas -v``: registers, shared memory, spills)
build_seconds = 0.0
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): the "
        "port's CUDA kernels are built at first use on a machine with the "
        "CUDA toolkit")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, ctypes.CDLL]:
    """Compile every missing library (one ``nvcc`` per source, in
    parallel) and load all of them; returns ``{source name: CDLL}``.
    Raises ``RuntimeError`` with the compiler's output on failure."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs: List[tuple] = []
        for name in SOURCES:
            src = CSRC / name
            out = _lib_path(src)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if procs:
            build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in SOURCES:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_lib_path(CSRC / name)))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>`` (building all
    sources first if needed)."""
    return build_all()[name]
