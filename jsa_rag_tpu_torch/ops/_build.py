"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library at first use, into
``csrc/build/`` (listed in ``.gitignore``), and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. A library newer than its source is
reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


def load_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` -> loaded ``csrc/build/lib<name>.so``."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, f"{name}.cu")
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build beside the target and rename: a concurrent loader never
            # sees a half-written library
            tmp = os.path.join(BUILD_DIR, f"lib{name}.{os.getpid()}.tmp.so")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        _libs[name] = ctypes.CDLL(so)
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers / shared memory / spills) of the last
    build of ``name``, or '' when the library was reused."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
