"""ctypes bindings for the native mmap passage store (counterpart of
``jsa_rag_tpu/data/native_store.py``).

The C++ source, ``native/passage_store.cpp``, sits outside both packages and
is framework-neutral: it is compiled here with g++ at first use into
``native/_build/`` (outside the Python package: a ctypes library inside a
package directory looks like a broken CPython extension to import scanners)
under a name of its own, so the two packages never race on one file.

Built from a jsonl corpus (one ``{"id", "title", "text"}`` row a line) on
the command line, the counterpart of ``scripts/build_passage_store.py``::

    python -m jsa_rag_tpu_torch.data.native_store corpus.jsonl corpus.bin
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
import time

_lock = threading.Lock()
_lib = None

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                    "passage_store.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "_build",
                   "libpassage_store_torch.so")


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = os.path.abspath(_SRC)
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(src)):
            tmp = _SO.replace(".so", f".{os.getpid()}.tmp.so")
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                 "-o", tmp],
                check=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        lib.ps_build_from_jsonl.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.ps_build_from_jsonl.restype = ctypes.c_long
        lib.ps_open.argtypes = [ctypes.c_char_p]
        lib.ps_open.restype = ctypes.c_void_p
        lib.ps_count.argtypes = [ctypes.c_void_p]
        lib.ps_count.restype = ctypes.c_long
        lib.ps_get.argtypes = [
            ctypes.c_void_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
        ]
        lib.ps_get.restype = ctypes.c_int
        lib.ps_close.argtypes = [ctypes.c_void_p]
        lib.ps_close.restype = None
        _lib = lib
        return lib


def build_store(jsonl_path: str, out_path: str) -> int:
    """jsonl corpus -> binary store; returns record count."""
    lib = _load()
    n = lib.ps_build_from_jsonl(jsonl_path.encode(), out_path.encode())
    if n < 0:
        raise IOError(f"failed to build passage store from {jsonl_path}")
    return int(n)


class NativePassageStore:
    """O(1) mmap'd id -> {id,title,text} lookup; near-zero resident memory."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.ps_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open passage store {path}")
        self._n = self._lib.ps_count(self._h)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> dict:
        bufs = [ctypes.c_char_p() for _ in range(3)]
        lens = [ctypes.c_long() for _ in range(3)]
        rc = self._lib.ps_get(
            self._h, idx,
            ctypes.byref(bufs[0]), ctypes.byref(lens[0]),
            ctypes.byref(bufs[1]), ctypes.byref(lens[1]),
            ctypes.byref(bufs[2]), ctypes.byref(lens[2]))
        if rc != 0:
            raise IndexError(idx)
        vals = [
            ctypes.string_at(bufs[i], lens[i].value).decode("utf-8")
            for i in range(3)
        ]
        return {"id": vals[0], "title": vals[1], "text": vals[2]}

    def close(self) -> None:
        if self._h:
            self._lib.ps_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def main(argv=None) -> int:
    """Build the store named by ``argv`` (jsonl path, store path); -> its
    record count."""
    src, dst = argv if argv is not None else sys.argv[1:3]
    t0 = time.time()
    n = build_store(src, dst)
    dt = time.time() - t0
    print(f"built {dst}: {n} passages in {dt:.1f}s ({n / max(dt, 1e-9):.0f}"
          "/s)", flush=True)
    return n


if __name__ == "__main__":
    main()
