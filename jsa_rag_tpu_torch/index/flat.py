"""Device-resident flat MIPS index: float16, residual-int8 (int8r), int8,
hybrid or dense (bfloat16 / float32) storage.

Counterpart of ``jsa_rag_tpu/index/flat.py::ShardedFlatIndex``, kept under
the same class name; each process holds one shard on its device. Storage
modes:

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

Sharding (``flat.py:83-166``, ``:465``): the rows are split over every
process of the grid, both axes flattened (W = the world size). Each shard
holds ``shard_rows = ceil(n / W / align) * align`` rows, aligned to 2048
once a shard exceeds one such block (8 below that); rank ``r`` holds global
rows ``[r * shard_rows, (r + 1) * shard_rows)`` and a runtime valid count
masks its tail, so a search never copies the index to pad it. A search
gathers every rank's (ragged) query rows, scans the rank's shard with the
kernels, offsets its ids to global rows (keeping the -1 placeholders) and
masks any out of range, gathers every shard's (B, k) candidates and merges
them in ``lax.top_k``'s order; each rank takes back its own rows. One
process is W = 1 through the same code. Writes take global row ranges and
each rank writes the part in its shard, in place; ``swap_in`` replaces the
buffers whole (the double-buffered refresh, ``index/refresh.py``). A save
gathers the shards (``fetch_global``) and rank 0 writes; a load gives each
rank its rows.
"""

from __future__ import annotations

import functools
import json
import math
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models.lm import top_k_lax
from ..ops.mips import mips_topk_t
from ..ops.mips_topt import (NEG_INF, hybrid_int8_from_f16,
                             mips_topk_int8_t, quantize_int8,
                             quantize_int8_residual)
from ..parallel import mesh
from ..utils import trace
from ._npio import np_save, to_host

DENSE = {"float16": torch.float16, "bfloat16": torch.bfloat16,
         "float32": torch.float32}
STORAGES = ("int8r", "int8", "hybrid", *DENSE)
HYBRID_CHUNK = 16384  # rows per step of the coarse-copy derivation


def fetch_global(t: torch.Tensor) -> torch.Tensor:
    """Every rank's shard of a row-sharded tensor, concatenated in rank
    order along dim 0 (``flat.py:51``): a collective that every rank must
    call; with one process, ``t``'s rows."""
    return mesh.all_gather(t).reshape(-1, *t.shape[1:])


def _shard_search(q, *ops, scan, k, n_true, shard, shard_rows, n_padded):
    """One shard's search and the cross-shard merge (the JAX package's
    ``_search_one_shard`` under ``shard_map``, ``flat.py:83-166``): the
    scan over this rank's rows with ``n_valid = clip(n_true - shard *
    shard_rows, 0, shard_rows)`` and ``pool_n`` from the worst-case pads;
    the ids offset to global rows, placeholders (-1) kept, anything out of
    range masked; then ``merge_shards``."""
    with trace.span("index.shard_search"):
        n_valid = min(max(n_true - shard * shard_rows, 0), shard_rows)
        max_pads = min(shard_rows, n_padded - n_true)
        scores, local = scan(q, *ops, kk=min(shard_rows, k), valid_n=n_valid,
                             pool_n=max(1, shard_rows - max_pads))
        local = local.to(torch.int32)
        gidx = torch.where(local < 0, -1, local + shard * shard_rows)
        scores = torch.where((gidx >= 0) & (gidx < n_true), scores, NEG_INF)
        return merge_shards(scores, gidx, k)


def merge_shards(scores, ids, k: int):
    """Every shard's (B, k_local) candidates gathered, shard after shard
    (``all_gather(axis=1, tiled=True)``), and the top k of the (B, W *
    k_local) in ``lax.top_k``'s order (``flat.py:162-166``)."""
    b = scores.shape[0]
    all_s = mesh.all_gather(scores).permute(1, 0, 2).reshape(b, -1)
    all_i = mesh.all_gather(ids).permute(1, 0, 2).reshape(b, -1)
    v, a = top_k_lax(all_s, k)
    return v, torch.gather(all_i, 1, a)


def _scan_int8(q, emb, scales, *aux, kk, valid_n, pool_n, refine_r, storage,
               int8r_refine):
    """The int8r, hybrid and int8 branches of the shard body. ``aux`` is
    (res, res_scales) for int8r and (fp16 rows,) for hybrid. The refines
    mask ids outside [0, valid_n); int8 storage's scan emits -1 for masked
    rows."""
    kw = {}
    if storage == "int8r":
        kw = dict(refine=refine_r, res_rows=aux[0], res_scale=aux[1],
                  int8r_refine=int8r_refine)
    elif storage == "hybrid":
        kw = dict(refine=refine_r, f16_rows=aux[0])
    return mips_topk_int8_t(q, emb, scales, kk, valid_n=valid_n,
                            pool_n=pool_n, **kw)


def _scan_dense(q, emb, *, kk, valid_n, pool_n, method, refine_r):
    """The dense and fp16 branch of the shard body (``flat.py:131-155``):
    the scan masks pad rows by the runtime valid count and emits id -1 for
    exhausted tile slots with a NEG_INF score (the fp16 rescore masks ids
    outside [0, valid_n))."""
    return mips_topk_t(q, emb, kk, method=method, valid_n=valid_n,
                       pool_n=pool_n, refine=refine_r)


class ShardedFlatIndex:
    """Flat MIPS index, one shard per process of the grid."""

    def __init__(self, n_passages: int, dim: int, dtype: str = "float16", *,
                 device: str | torch.device = "cuda", method: str = "auto",
                 int8r_refine: str = "rows", grid: mesh.Grid | None = None):
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
        # the rows shard over every process, both grid axes flattened
        self.n_shards = mesh.process_count() if grid is None else grid.world
        self.shard = mesh.process_index() if grid is None else grid.rank
        if self.n_shards != mesh.process_count():
            raise ValueError(f"a grid of {self.n_shards} shards under "
                             f"{mesh.process_count()} process(es)")
        base = int(math.ceil(n_passages / self.n_shards / 8) * 8)
        align = 2048 if base >= 2048 else 8
        self.shard_rows = int(math.ceil(n_passages / self.n_shards / align)
                              * align)
        self.n_padded = self.shard_rows * self.n_shards
        self.row_offset = self.shard * self.shard_rows
        # this shard's valid rows: [row_offset, row_offset + local_rows)
        self.local_rows = min(max(n_passages - self.row_offset, 0),
                              self.shard_rows)
        zeros = functools.partial(torch.zeros, device=self.device)
        self.embeddings = zeros((self.shard_rows, dim), dtype=self.dtype)
        self.scales = self.res = self.res_scales = None
        if self.store_int8r or self.store_int8:
            self.scales = zeros((1, self.shard_rows), dtype=torch.float32)
        if self.store_int8r:
            self.res = zeros((self.shard_rows, dim), dtype=torch.int8)
            self.res_scales = zeros((1, self.shard_rows), dtype=torch.float32)
        # hybrid: the derived coarse copy, tagged with the write count it
        # was derived at; every write bumps the count
        self._writes = 0
        self._hybrid_cache = None
        self.hybrid_derivations = 0

    # ------------------------------------------------------------------ build
    def set_embeddings(self, start: int, block) -> None:
        """Write a float (rows, d) block at global rows [start, start +
        rows): this rank stores the part in its shard, quantised (int8r,
        int8) or cast (float16, dense, hybrid's fp16 rows)."""
        aux = ((self.scales, self.res, self.res_scales) if self.store_int8r
               else self.scales)
        self.embeddings, aux = self.write_block(self.embeddings, aux, start,
                                                block)
        if self.store_int8r:
            self.scales, self.res, self.res_scales = aux
        self._writes += 1

    def write_block(self, buf_emb, buf_aux, start: int, block_rows):
        """Storage-transform the rows of ``block_rows`` (global rows from
        ``start``) that fall in this shard and write them into ``buf_emb``
        (and ``buf_aux``: the ``(scales, res, res_scales)`` tuple for int8r,
        the scales for int8), shard-shaped buffers, in place; returns the
        buffers."""
        rows = block_rows.shape[0]
        if len(block_rows.shape) != 2 or block_rows.shape[1] != self.dim:
            raise ValueError(f"block must be (rows, {self.dim}), got "
                             f"{tuple(block_rows.shape)}")
        if start < 0 or start + rows > self.n_padded:
            raise ValueError(f"rows [{start}, {start + rows}) outside the "
                             f"index's {self.n_padded}")
        lo = max(start, self.row_offset)
        hi = min(start + rows, self.row_offset + self.shard_rows)
        if lo >= hi:
            return buf_emb, buf_aux
        x = torch.as_tensor(block_rows[lo - start:hi - start]).to(
            self.device, torch.float32)
        a, b = lo - self.row_offset, hi - self.row_offset
        if self.store_int8:
            v, sc = quantize_int8(x)
            buf_emb[a:b] = v
            buf_aux[0, a:b] = sc[:, 0]
            return buf_emb, buf_aux
        if not self.store_int8r:
            buf_emb[a:b] = x.to(self.dtype)
            return buf_emb, buf_aux
        v1, s1, v2, s2 = quantize_int8_residual(x)
        scales, res, res_scales = buf_aux
        buf_emb[a:b] = v1
        scales[0, a:b] = s1[:, 0]
        res[a:b] = v2
        res_scales[0, a:b] = s2[:, 0]
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
        """Top-k over the whole corpus: this rank's queries (B, d) ->
        (scores (B, k) f32, global ids (B, k) int32), both on the index's
        device. Every rank calls it together; B may differ between ranks
        (the rows are gathered, padded to the largest B, searched as one
        batch, and each rank takes back its own, ``_search_multiprocess``,
        ``flat.py:465``)."""
        with trace.span("index.search"):
            k = min(k, self.n_passages)
            q = torch.as_tensor(queries).to(self.device, torch.float32)
            all_q, counts = mesh.all_gather_ragged(q)
            lo = self.shard * all_q.shape[1]
            fn, ops = self.fused_search_fn(k)
            s, i = fn(all_q.reshape(-1, self.dim), *ops)
            return s[lo:lo + q.shape[0]], i[lo:lo + q.shape[0]]

    def fused_search_fn(self, k: int):
        """(search fn, storage operands): ``fn(queries, *operands)`` runs
        the shard scan and the merge over queries every rank holds (one
        collective). Re-fetch the operands after any buffer swap."""
        geometry = dict(k=k, n_true=self.n_passages, shard=self.shard,
                        shard_rows=self.shard_rows, n_padded=self.n_padded)
        if self.storage in DENSE:
            scan = functools.partial(_scan_dense, method=self.method,
                                     refine_r=self.refine_r)
            return (functools.partial(_shard_search, scan=scan, **geometry),
                    (self.embeddings,))
        scan = functools.partial(_scan_int8, refine_r=self.refine_r,
                                 storage=self.storage,
                                 int8r_refine=self.int8r_refine)
        fn = functools.partial(_shard_search, scan=scan, **geometry)
        if self.store_int8r:
            return fn, (self.embeddings, self.scales, self.res,
                        self.res_scales)
        if self.store_hybrid:
            return fn, (*self.hybrid_copies(), self.embeddings)
        return fn, (self.embeddings, self.scales)

    def hybrid_copies(self):
        """The hybrid index's coarse copy of this shard, (codes (shard_rows,
        d) int8, scales (1, shard_rows) f32), derived from the fp16 rows in
        chunks of ``HYBRID_CHUNK`` rows (bounding the f32 intermediate) at
        the first call after any write (``flat.py:411-448``); the stale copy
        is freed first."""
        if self._hybrid_cache is None or self._hybrid_cache[0] != self._writes:
            self._hybrid_cache = None
            rows = self.shard_rows
            codes = torch.empty((rows, self.dim), dtype=torch.int8,
                                device=self.device)
            scales = torch.empty((1, rows), dtype=torch.float32,
                                 device=self.device)
            for lo in range(0, rows, HYBRID_CHUNK):
                hi = min(lo + HYBRID_CHUNK, rows)
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
        rows, bf16 as its uint16 bit pattern. Every rank calls it: the
        shards are gathered (``fetch_global``), rank 0 writes, and the
        others wait until the files are there."""
        n = self.n_passages
        arrays = {"embeddings": self.embeddings}
        if self.store_int8r or self.store_int8:
            arrays["scales"] = self.scales.reshape(-1, 1)
        if self.store_int8r:
            arrays["res"] = self.res
            arrays["res_scales"] = self.res_scales.reshape(-1, 1)
        if self.shard == 0:
            os.makedirs(path, exist_ok=True)
        for name, arr in arrays.items():
            host = fetch_global(arr)[:n]
            if self.shard != 0:
                continue
            host = to_host(host)
            for i, r in enumerate(np.array_split(host, n_files, axis=0)):
                np_save(os.path.join(path, f"{name}.{i}.npy"), r)
        if self.shard == 0:
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
        mesh.barrier()

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cuda",
             method: str = "auto", int8r_refine: str = "rows",
             grid: mesh.Grid | None = None):
        """A saved flat index (either package's); each rank reads the rows
        of its shard from the files that hold them."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        kind = meta.get("kind", "flat")
        if kind != "flat":
            raise ValueError(f"{path} holds a {kind} index, not a flat one: "
                             "load it with index.load_index")
        if meta.get("store_int8r"):
            name = "int8r"
        elif meta.get("store_hybrid"):
            name = "hybrid"
        elif meta.get("store_f16_bits"):
            name = "float16"
        else:
            name = meta["dtype"]
        idx = cls(meta["n_passages"], meta["dim"], name, device=device,
                  method=method, int8r_refine=int8r_refine, grid=grid)
        mine_lo = idx.row_offset
        mine_hi = idx.row_offset + idx.local_rows
        start = 0
        for i in range(meta["n_files"]):
            rows = _npy_rows(os.path.join(path, f"embeddings.{i}.npy"))
            if start + rows > meta["n_passages"]:
                raise ValueError(f"{path} holds more rows than its meta")
            lo, hi = max(start, mine_lo), min(start + rows, mine_hi)
            if lo < hi:
                a, b = lo - start, hi - start
                at = slice(lo - mine_lo, hi - mine_lo)

                def part(array):
                    x = np.load(os.path.join(path, f"{array}.{i}.npy"),
                                mmap_mode="r")
                    if x.dtype.kind == "V" and x.dtype.itemsize == 2:
                        x = x.view(np.uint16)
                    t = torch.from_numpy(np.array(x[a:b]))
                    if x.dtype == np.uint16:  # bf16 bits
                        t = t.view(torch.int16).view(torch.bfloat16)
                    elif x.dtype == np.int16 and idx.dtype == torch.float16:
                        t = t.view(torch.float16)
                    return t.to(idx.device)

                block = part("embeddings")
                if block.dtype != idx.dtype:
                    raise ValueError(f"{path} shard {i} is {block.dtype}, "
                                     f"its meta says {idx.dtype}")
                idx.embeddings[at] = block
                if idx.store_int8r or idx.store_int8:
                    idx.scales[0, at] = part("scales").reshape(-1)
                if idx.store_int8r:
                    idx.res[at] = part("res")
                    idx.res_scales[0, at] = part("res_scales").reshape(-1)
            start += rows
        if start != meta["n_passages"]:
            raise ValueError(f"{path} holds {start} rows, its meta "
                             f"{meta['n_passages']}")
        idx._writes += 1
        return idx

    def embeddings_as_float(self) -> torch.Tensor:
        """Stored rows decoded to (n_passages, d) f32 (int8r: v1*s1 +
        v2*s2; int8: v*s; float16, hybrid, bf16, f32: the rows, converted
        exactly); a collective over the shards (``fetch_global``)."""
        e = self.embeddings.to(torch.float32)
        if self.store_int8:
            e = e * self.scales[0, :, None]
        elif self.store_int8r:
            e = (e * self.scales[0, :, None]
                 + self.res.to(torch.float32) * self.res_scales[0, :, None])
        return fetch_global(e)[:self.n_passages]


def _npy_rows(path: str) -> int:
    """The first dimension of a saved array, from its header."""
    return np.load(path, mmap_mode="r").shape[0]
