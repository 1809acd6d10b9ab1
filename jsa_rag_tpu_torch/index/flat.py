"""Device-resident flat MIPS index: residual-int8 (int8r) or dense
(bfloat16 / float32) storage.

Counterpart of ``jsa_rag_tpu/index/flat.py::ShardedFlatIndex``, kept under
the same class name. It holds one shard on one device (several devices are
ROADMAP queue A item 13). Storage modes:

- ``int8r`` (the default of ``--index_dtype``), 2 bytes per element as in
  the JAX package, searched with its default ``int8r_refine="rows"``:
  ``embeddings`` plane 1, (n_padded, d) int8; ``scales`` (1, n_padded) f32
  plane-1 row scales; ``res`` (n_padded, d) int8 plane 2 (the rows refine
  gathers from it); ``res_scales`` (1, n_padded) f32;
- ``bfloat16`` / ``float32``: ``embeddings`` (n_padded, d) in that type,
  searched through ``ops.mips.mips_topk_t`` (kernel B3 on the card).

All planes are ROW-major (N, d): the JAX package keeps them (d, N) because
the TPU's MXU wants the contraction dim leading, while ``mma.sync`` wants
both operands K-contiguous, which rows are; rows are also the on-disk layout.
``float16``, ``int8`` and ``hybrid`` storage and the int8r ``rows1``/``cols``
refines raise ``NotImplementedError`` naming the kernels they wait for.

Rows are allocated in multiples of 2048 once the index exceeds one such
block (8 below that) and a runtime valid count masks the tail, so a search
never copies the index to pad it. Writes update the buffers in place.
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
from ..ops.mips_topt import mips_topk_int8r_t, quantize_int8_residual
from ._npio import np_load, np_save

DENSE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
NOT_PORTED = {
    "float16": "ROADMAP queue B items 4-5 (fp16 scan kernels)",
    "int8": "ROADMAP queue B item 2 (single-plane int8 scan kernel)",
    "hybrid": "ROADMAP queue B items 2 and 4 (int8 coarse scan, fp16 "
              "refine)",
    "rows1": "ROADMAP queue B item 2 (single-plane int8 scan kernel)",
    "cols": "ROADMAP queue B item 2 (single-plane int8 scan kernel)",
}


def _not_ported(what: str, name: str):
    return NotImplementedError(f"{what} {name!r} is not ported yet: "
                               f"{NOT_PORTED.get(name, 'unknown storage')}")


def _search_int8r(q, emb, scales, res, res_scales, *, k, n_true,
                  shard_rows, n_padded, refine_r):
    """One shard's search (the JAX package's ``shard_map`` body, int8r
    branch). Pad rows at or past ``n_true`` are masked by the runtime valid
    count, and ``pool_n`` sizes the per-tile pool from the valid rows. With
    one shard, the JAX body's id offset, its out-of-range mask (the refine
    already masks ids outside [0, n_true)) and its cross-shard merge are
    identities."""
    n_valid = min(n_true, shard_rows)
    max_pads = min(shard_rows, n_padded - n_true)
    return mips_topk_int8r_t(
        q, emb, scales, min(shard_rows, k), valid_n=n_valid,
        pool_n=max(1, shard_rows - max_pads), refine=refine_r,
        res_rows=res, res_scale=res_scales)


def _search_dense(q, emb, *, k, n_true, shard_rows, n_padded, method):
    """One shard's search, dense branch (``flat.py:131-155``): the scan
    masks pad rows by the runtime valid count and emits id -1 for exhausted
    tile slots with a NEG_INF score, so with one shard the JAX body's
    out-of-range mask and merge are identities here too."""
    n_valid = min(n_true, shard_rows)
    max_pads = min(shard_rows, n_padded - n_true)
    return mips_topk_t(q, emb, min(shard_rows, k), method=method,
                       valid_n=n_valid,
                       pool_n=max(1, shard_rows - max_pads))


class ShardedFlatIndex:
    """Flat MIPS index on one device."""

    def __init__(self, n_passages: int, dim: int, dtype: str = "int8r", *,
                 device: str | torch.device = "cuda", method: str = "auto",
                 int8r_refine: str = "rows"):
        if int8r_refine not in ("rows", "rows1", "cols"):
            raise ValueError(
                f"int8r_refine must be rows|rows1|cols, got {int8r_refine!r}")
        if dtype != "int8r" and dtype not in DENSE:
            raise _not_ported("index dtype", dtype)
        if dtype == "int8r" and int8r_refine != "rows":
            raise _not_ported("int8r_refine", int8r_refine)
        self.device = resolve_device(device)
        self.dim = dim
        self.n_passages = n_passages
        self.storage = dtype
        self.store_int8r = dtype == "int8r"
        self.dtype = torch.int8 if self.store_int8r else DENSE[dtype]
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
        if self.store_int8r:
            self.scales = zeros((1, self.n_padded), dtype=torch.float32)
            self.res = zeros((self.n_padded, dim), dtype=torch.int8)
            self.res_scales = zeros((1, self.n_padded), dtype=torch.float32)

    # ------------------------------------------------------------------ build
    def set_embeddings(self, start: int, block) -> None:
        """Write a float (rows, d) block at rows [start, start + rows):
        quantised (int8r) or cast (dense)."""
        aux = ((self.scales, self.res, self.res_scales) if self.store_int8r
               else None)
        self.embeddings, aux = self.write_block(self.embeddings, aux, start,
                                                block)
        if self.store_int8r:
            self.scales, self.res, self.res_scales = aux

    def write_block(self, buf_emb, buf_aux, start: int, block_rows):
        """Storage-transform ``block_rows`` and write it into ``buf_emb``
        (and, for int8r, the ``(scales, res, res_scales)`` tuple
        ``buf_aux``) at row ``start``, in place; returns the buffers."""
        x = torch.as_tensor(block_rows).to(self.device, torch.float32)
        rows = x.shape[0]
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"block must be (rows, {self.dim}), got "
                             f"{tuple(x.shape)}")
        if start < 0 or start + rows > buf_emb.shape[0]:
            raise ValueError(f"rows [{start}, {start + rows}) outside the "
                             f"index's {buf_emb.shape[0]}")
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
        if self.store_int8r:
            return (functools.partial(_search_int8r, refine_r=self.refine_r,
                                      **geometry),
                    (self.embeddings, self.scales, self.res,
                     self.res_scales))
        return (functools.partial(_search_dense, method=self.method,
                                  **geometry), (self.embeddings,))

    # --------------------------------------------------------------- save/load
    def save(self, path: str, n_files: int = 16) -> None:
        """The JAX package's format: ``n_files`` row-major npy shards per
        array and a meta json. int8r writes plane 1 (N, d), scales (N, 1),
        plane 2 (N, d) and residual scales (N, 1); dense writes the rows,
        bf16 as its uint16 bit pattern."""
        n = self.n_passages
        os.makedirs(path, exist_ok=True)
        if self.store_int8r:
            arrays = {
                "embeddings": self.embeddings[:n],
                "scales": self.scales[0, :n].reshape(n, 1),
                "res": self.res[:n],
                "res_scales": self.res_scales[0, :n].reshape(n, 1),
            }
        else:
            arrays = {"embeddings": self.embeddings[:n]}
        for name, arr in arrays.items():
            host = arr.cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16).numpy().view(np.uint16)
            else:
                host = host.numpy()
            for i, r in enumerate(np.array_split(host, n_files, axis=0)):
                np_save(os.path.join(path, f"{name}.{i}.npy"), r)
        meta = {
            "n_passages": n,
            "dim": self.dim,
            "dtype": "int8" if self.store_int8r else self.storage,
            "store_int8": self.store_int8r,  # JAX records int8r as both
            "store_int8r": self.store_int8r,
            "store_f16_bits": False,
            "store_hybrid": False,
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
                return t.to(idx.device)

            block = part("embeddings")
            rows = block.shape[0]
            if start + rows > meta["n_passages"]:
                raise ValueError(f"{path} holds more rows than its meta")
            if block.dtype != idx.dtype:
                raise ValueError(f"{path} shard {i} is {block.dtype}, its "
                                 f"meta says {idx.dtype}")
            idx.embeddings[start:start + rows] = block
            if idx.store_int8r:
                idx.scales[0, start:start + rows] = part("scales").reshape(-1)
                idx.res[start:start + rows] = part("res")
                idx.res_scales[0, start:start + rows] = part(
                    "res_scales").reshape(-1)
            start += rows
        if start != meta["n_passages"]:
            raise ValueError(f"{path} holds {start} rows, its meta "
                             f"{meta['n_passages']}")
        return idx

    def embeddings_as_float(self) -> torch.Tensor:
        """Stored rows decoded to (n_passages, d) f32 (int8r: v1*s1 +
        v2*s2)."""
        n = self.n_passages
        if not self.store_int8r:
            return self.embeddings[:n].to(torch.float32)
        return (self.embeddings[:n].to(torch.float32)
                * self.scales[0, :n, None]
                + self.res[:n].to(torch.float32) * self.res_scales[0, :n, None])
