"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point (sharing
``csrc/*.cuh`` headers). It is compiled by ``nvcc`` for ``sm_90a`` into a
shared library at first use, into ``csrc/build/`` (listed in
``.gitignore``), and loaded with ``ctypes`` — no PyTorch headers, so a build
takes seconds. A library newer than its source and the headers is reused.
``load_libraries`` starts one ``nvcc`` per stale source, all at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import glob
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


def _stale(name: str) -> bool:
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu"),
            *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return os.path.getmtime(so) < max(os.path.getmtime(p) for p in deps)


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """``csrc/<name>.cu`` -> loaded ``csrc/build/lib<name>.so`` for each
    name; the stale ones are compiled concurrently."""
    with _lock:
        todo = [n for n in names if n not in _libs and _stale(n)]
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            # build beside the target and rename: a concurrent loader never
            # sees a half-written library
            procs = {}
            for name in todo:
                tmp = os.path.join(BUILD_DIR,
                                   f"lib{name}.{os.getpid()}.tmp.so")
                src = os.path.join(CSRC, f"{name}.cu")
                procs[name] = (tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
                    f.write(out)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {name}.cu:\n{out}")
                else:
                    os.replace(tmp, os.path.join(BUILD_DIR,
                                                 f"lib{name}.so"))
            if failed:
                raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(
                    os.path.join(BUILD_DIR, f"lib{name}.so"))
        return {name: _libs[name] for name in names}


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers / shared memory / spills) of the last
    build of ``name``, or '' when the library was reused."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
