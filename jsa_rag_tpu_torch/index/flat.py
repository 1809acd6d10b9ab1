"""Device-resident flat MIPS index: float16, residual-int8 (int8r), int8,
hybrid or dense (bfloat16 / float32) storage.

Counterpart of ``jsa_rag_tpu/index/flat.py::ShardedFlatIndex``, kept under
the same class name. It holds one shard on one device (several devices are
ROADMAP queue A item 13). Storage modes:

- ``float16`` (the class's default, as in the JAX package; the reference's
  own storage, src/index.py:52): ``embeddings`` (n_padded, d)
  ``torch.float16``, written as ``x.to(float16)`` (round to nearest, the
  JAX package's ``f16_to_bits``), searched through ``ops.mips.mips_topk_t``
  with ``refine_r`` (on the card: kernel B4 and the f32 rescore, or B5 for
  ``refine_r = 0``);
- ``int8r`` (the default of ``--index_dtype``), 2 bytes per element as in
  the JAX package, searched with ``int8r_refine`` "rows" (kernel B1),
  "rows1" or "cols" (kernel B2): ``embeddings`` plane 1, (n_padded, d) int8;
  ``scales`` (1, n_padded) f32 plane-1 row scales; ``res`` (n_padded, d)
  int8 plane 2; ``res_scales`` (1, n_padded) f32;
- ``int8``: ``embeddings`` (n_padded, d) int8 and ``scales`` (1, n_padded)
  f32, searched by kernel B2 with no refine;
- ``hybrid``: ``embeddings`` (n_padded, d) ``torch.float16``, the primary
  rows, plus an int8 coarse copy and its scales derived from them
  (``hybrid_int8_from_f16``) at the first search after any write; kernel B2
  scans the copy and ``_f16_refine`` rescores the top-(refine_r*k) from the
  fp16 rows;
- ``bfloat16`` / ``float32``: ``embeddings`` (n_padded, d) in that type,
  searched through ``ops.mips.mips_topk_t`` (kernel B3 on the card).

All planes are ROW-major (N, d): the JAX package keeps them (d, N) because
the TPU's MXU wants the contraction dim leading, while ``wgmma`` wants
both operands K-major (its 8-bit forms take no other), which rows are; rows
are also the on-disk layout.
The JAX package's ``refine_gather="rows"`` copy of a float16 index is
therefore the store itself, and the option is gone.

Rows are allocated in multiples of 2048 once the index exceeds one such
block (8 below that) and a runtime valid count masks the tail, so a search
never copies the index to pad it. Writes update the buffers in place;
``swap_in`` replaces them whole (the double-buffered refresh,
``index/refresh.py``).
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import torch

from ..device import resolve_device
from ..ops.mips import mips_topk_t
from ..ops.mips_topt import (hybrid_int8_from_f16, mips_topk_int8_t,
                             quantize_int8, quantize_int8_residual)
from ._npio import np_load, np_save

DENSE = {"float16": torch.float16, "bfloat16": torch.bfloat16,
         "float32": torch.float32}
STORAGES = ("int8r", "int8", "hybrid", *DENSE)
HYBRID_CHUNK = 16384  # rows per step of the coarse-copy derivation


def _search_int8(q, emb, scales, *aux, k, n_true, shard_rows, n_padded,
                 refine_r, storage, int8r_refine):
    """One shard's search (the JAX package's ``shard_map`` body, the int8r,
    hybrid and int8 branches). ``aux`` is (res, res_scales) for int8r and
    (fp16 rows,) for hybrid. Pad rows at or past ``n_true`` are masked by
    the runtime valid count, and ``pool_n`` sizes the per-tile pool from the
    valid rows. With one shard, the JAX body's id offset, its out-of-range
    mask (the refines already mask ids outside [0, n_true); int8 storage's
    scan emits -1 for masked rows) and its cross-shard merge are
    identities."""
    n_valid = min(n_true, shard_rows)
    max_pads = min(shard_rows, n_padded - n_true)
    kw = {}
    if storage == "int8r":
        kw = dict(refine=refine_r, res_rows=aux[0], res_scale=aux[1],
                  int8r_refine=int8r_refine)
    elif storage == "hybrid":
        kw = dict(refine=refine_r, f16_rows=aux[0])
    return mips_topk_int8_t(
        q, emb, scales, min(shard_rows, k), valid_n=n_valid,
        pool_n=max(1, shard_rows - max_pads), **kw)


def _search_dense(q, emb, *, k, n_true, shard_rows, n_padded, method,
                  refine_r):
    """One shard's search, dense and fp16 branch (``flat.py:131-155``): the
    scan masks pad rows by the runtime valid count and emits id -1 for
    exhausted tile slots with a NEG_INF score (the fp16 rescore masks ids
    outside [0, n_true)), so with one shard the JAX body's out-of-range mask
    and merge are identities here too."""
    n_valid = min(n_true, shard_rows)
    max_pads = min(shard_rows, n_padded - n_true)
    return mips_topk_t(q, emb, min(shard_rows, k), method=method,
                       valid_n=n_valid,
                       pool_n=max(1, shard_rows - max_pads), refine=refine_r)


class ShardedFlatIndex:
    """Flat MIPS index on one device."""

    def __init__(self, n_passages: int, dim: int, dtype: str = "float16", *,
                 device: str | torch.device = "cuda", method: str = "auto",
                 int8r_refine: str = "rows"):
        if int8r_refine not in ("rows", "rows1", "cols"):
            raise ValueError(
                f"int8r_refine must be rows|rows1|cols, got {int8r_refine!r}")
        if dtype not in STORAGES:
            raise ValueError(f"index dtype must be one of {STORAGES}, got "
                             f"{dtype!r}")
        self.device = resolve_device(device)
        self.dim = dim
        self.n_passages = n_passages
        self.storage = dtype
        self.store_int8r = dtype == "int8r"
        self.store_int8 = dtype == "int8"
        self.store_hybrid = dtype == "hybrid"
        self.dtype = (torch.float16 if self.store_hybrid else
                      DENSE.get(dtype, torch.int8))
        self.method = method
        self.int8r_refine = int8r_refine
        self.refine_r = 4
        self.n_shards = 1
        base = int(math.ceil(n_passages / 8) * 8)
        align = 2048 if base >= 2048 else 8
        self.shard_rows = int(math.ceil(n_passages / align) * align)
        self.n_padded = self.shard_rows
        zeros = functools.partial(torch.zeros, device=self.device)
        self.embeddings = zeros((self.n_padded, dim), dtype=self.dtype)
        self.scales = self.res = self.res_scales = None
        if self.store_int8r or self.store_int8:
            self.scales = zeros((1, self.n_padded), dtype=torch.float32)
        if self.store_int8r:
            self.res = zeros((self.n_padded, dim), dtype=torch.int8)
            self.res_scales = zeros((1, self.n_padded), dtype=torch.float32)
        # hybrid: the derived coarse copy, tagged with the write count it
        # was derived at; every write bumps the count
        self._writes = 0
        self._hybrid_cache = None
        self.hybrid_derivations = 0

    # ------------------------------------------------------------------ build
    def set_embeddings(self, start: int, block) -> None:
        """Write a float (rows, d) block at rows [start, start + rows):
        quantised (int8r, int8) or cast (float16, dense, hybrid's fp16
        rows)."""
        aux = ((self.scales, self.res, self.res_scales) if self.store_int8r
               else self.scales)
        self.embeddings, aux = self.write_block(self.embeddings, aux, start,
                                                block)
        if self.store_int8r:
            self.scales, self.res, self.res_scales = aux
        self._writes += 1

    def write_block(self, buf_emb, buf_aux, start: int, block_rows):
        """Storage-transform ``block_rows`` and write it into ``buf_emb``
        (and ``buf_aux``: the ``(scales, res, res_scales)`` tuple for int8r,
        the scales for int8) at row ``start``, in place; returns the
        buffers."""
        x = torch.as_tensor(block_rows).to(self.device, torch.float32)
        rows = x.shape[0]
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"block must be (rows, {self.dim}), got "
                             f"{tuple(x.shape)}")
        if start < 0 or start + rows > buf_emb.shape[0]:
            raise ValueError(f"rows [{start}, {start + rows}) outside the "
                             f"index's {buf_emb.shape[0]}")
        if self.store_int8:
            v, sc = quantize_int8(x)
            buf_emb[start:start + rows] = v
            buf_aux[0, start:start + rows] = sc[:, 0]
            return buf_emb, buf_aux
        if not self.store_int8r:
            buf_emb[start:start + rows] = x.to(self.dtype)
            return buf_emb, buf_aux
        v1, s1, v2, s2 = quantize_int8_residual(x)
        scales, res, res_scales = buf_aux
        buf_emb[start:start + rows] = v1
        scales[0, start:start + rows] = s1[:, 0]
        res[start:start + rows] = v2
        res_scales[0, start:start + rows] = s2[:, 0]
        return buf_emb, (scales, res, res_scales)

    def swap_in(self, buf_emb, buf_aux) -> None:
        """Make ``buf_emb``/``buf_aux`` (filled by ``write_block``) the live
        store, dropping the old buffers and hybrid's derived copy: the next
        search re-derives it from the new rows."""
        self.embeddings = buf_emb
        if self.store_int8r:
            self.scales, self.res, self.res_scales = buf_aux
        elif self.store_int8:
            self.scales = buf_aux
        self._hybrid_cache = None
        self._writes += 1

    # ----------------------------------------------------------------- search
    def search(self, queries, k: int):
        """Top-k over the corpus: queries (B, d) -> (scores (B, k) f32,
        ids (B, k) int32), both on the index's device."""
        k = min(k, self.n_passages)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        fn, ops = self.fused_search_fn(k)
        return fn(q, *ops)

    def fused_search_fn(self, k: int):
        """(search fn, storage operands): call ``fn(queries, *operands)``.
        Re-fetch the operands after any buffer swap."""
        geometry = dict(k=k, n_true=self.n_passages,
                        shard_rows=self.shard_rows, n_padded=self.n_padded)
        if self.storage in DENSE:
            return (functools.partial(_search_dense, method=self.method,
                                      refine_r=self.refine_r, **geometry),
                    (self.embeddings,))
        fn = functools.partial(_search_int8, refine_r=self.refine_r,
                               storage=self.storage,
                               int8r_refine=self.int8r_refine, **geometry)
        if self.store_int8r:
            return fn, (self.embeddings, self.scales, self.res,
                        self.res_scales)
        if self.store_hybrid:
            return fn, (*self.hybrid_copies(), self.embeddings)
        return fn, (self.embeddings, self.scales)

    def hybrid_copies(self):
        """The hybrid index's coarse copy, (codes (n_padded, d) int8, scales
        (1, n_padded) f32), derived from the fp16 rows in chunks of
        ``HYBRID_CHUNK`` rows (bounding the f32 intermediate) at the first
        call after any write (``flat.py:411-448``); the stale copy is freed
        first."""
        if self._hybrid_cache is None or self._hybrid_cache[0] != self._writes:
            self._hybrid_cache = None
            codes = torch.empty((self.n_padded, self.dim), dtype=torch.int8,
                                device=self.device)
            scales = torch.empty((1, self.n_padded), dtype=torch.float32,
                                 device=self.device)
            for lo in range(0, self.n_padded, HYBRID_CHUNK):
                hi = min(lo + HYBRID_CHUNK, self.n_padded)
                codes[lo:hi], scales[0, lo:hi] = hybrid_int8_from_f16(
                    self.embeddings[lo:hi])
            self._hybrid_cache = (self._writes, (codes, scales))
            self.hybrid_derivations += 1
        return self._hybrid_cache[1]

    # --------------------------------------------------------------- save/load
    def save(self, path: str, n_files: int = 16) -> None:
        """The JAX package's format: ``n_files`` row-major npy shards per
        array and a meta json. int8r writes plane 1 (N, d), scales (N, 1),
        plane 2 (N, d) and residual scales (N, 1); int8 the codes and
        scales; float16 and hybrid their fp16 rows as int16 bit patterns
        (hybrid's derived int8 copy is not saved); bf16 and f32 write the
        rows, bf16 as its uint16 bit pattern."""
        n = self.n_passages
        os.makedirs(path, exist_ok=True)
        arrays = {"embeddings": self.embeddings[:n]}
        if self.store_int8r or self.store_int8:
            arrays["scales"] = self.scales[0, :n].reshape(n, 1)
        if self.store_int8r:
            arrays["res"] = self.res[:n]
            arrays["res_scales"] = self.res_scales[0, :n].reshape(n, 1)
        for name, arr in arrays.items():
            host = arr.cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16).numpy().view(np.uint16)
            elif host.dtype == torch.float16:
                host = host.view(torch.int16).numpy()
            else:
                host = host.numpy()
            for i, r in enumerate(np.array_split(host, n_files, axis=0)):
                np_save(os.path.join(path, f"{name}.{i}.npy"), r)
        meta = {
            "n_passages": n,
            "dim": self.dim,
            "dtype": ("int8" if self.store_int8r else
                      "int16" if self.dtype == torch.float16 else
                      self.storage),
            # JAX records int8r as both int8 and int8r
            "store_int8": self.store_int8r or self.store_int8,
            "store_int8r": self.store_int8r,
            "store_f16_bits": self.dtype == torch.float16,
            "store_hybrid": self.store_hybrid,
            "n_files": n_files,
            "kind": "flat",
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cuda",
             method: str = "auto", int8r_refine: str = "rows"):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        kind = meta.get("kind", "flat")
        if kind != "flat":
            raise NotImplementedError(
                f"{kind} index at {path}: IVF is ROADMAP queue A item 14")
        if meta.get("store_int8r"):
            name = "int8r"
        elif meta.get("store_hybrid"):
            name = "hybrid"
        elif meta.get("store_f16_bits"):
            name = "float16"
        else:
            name = meta["dtype"]
        idx = cls(meta["n_passages"], meta["dim"], name, device=device,
                  method=method, int8r_refine=int8r_refine)
        start = 0
        for i in range(meta["n_files"]):
            def part(array):
                a = np_load(os.path.join(path, f"{array}.{i}.npy"))
                t = torch.from_numpy(np.ascontiguousarray(a))
                if a.dtype == np.uint16:  # bf16 bits
                    t = t.view(torch.int16).view(torch.bfloat16)
                elif a.dtype == np.int16 and idx.dtype == torch.float16:
                    t = t.view(torch.float16)
                return t.to(idx.device)

            block = part("embeddings")
            rows = block.shape[0]
            if start + rows > meta["n_passages"]:
                raise ValueError(f"{path} holds more rows than its meta")
            if block.dtype != idx.dtype:
                raise ValueError(f"{path} shard {i} is {block.dtype}, its "
                                 f"meta says {idx.dtype}")
            idx.embeddings[start:start + rows] = block
            if idx.store_int8r or idx.store_int8:
                idx.scales[0, start:start + rows] = part("scales").reshape(-1)
            if idx.store_int8r:
                idx.res[start:start + rows] = part("res")
                idx.res_scales[0, start:start + rows] = part(
                    "res_scales").reshape(-1)
            start += rows
        if start != meta["n_passages"]:
            raise ValueError(f"{path} holds {start} rows, its meta "
                             f"{meta['n_passages']}")
        idx._writes += 1
        return idx

    def embeddings_as_float(self) -> torch.Tensor:
        """Stored rows decoded to (n_passages, d) f32 (int8r: v1*s1 +
        v2*s2; int8: v*s; float16, hybrid, bf16, f32: the rows, converted
        exactly)."""
        n = self.n_passages
        if self.store_int8:
            return self.embeddings[:n].to(torch.float32) * self.scales[0, :n,
                                                                       None]
        if not self.store_int8r:
            return self.embeddings[:n].to(torch.float32)
        return (self.embeddings[:n].to(torch.float32)
                * self.scales[0, :n, None]
                + self.res[:n].to(torch.float32) * self.res_scales[0, :n, None])
