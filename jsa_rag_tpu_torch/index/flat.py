"""Device-resident flat MIPS index with residual-int8 (int8r) storage.

Counterpart of ``jsa_rag_tpu/index/flat.py::ShardedFlatIndex``, kept under
the same class name. This slice holds one shard on one device and int8r
storage only — the default of ``--index_dtype`` — and its default
``int8r_refine="rows"`` search; the other storage modes and strategies raise
``NotImplementedError`` (ROADMAP queue A item 11), several devices are item
13.

Storage, 2 bytes per element as in the JAX package:

- ``embeddings``: plane 1, (n_padded, d) int8, ROW-major. The JAX package
  keeps plane 1 as (d, N) because the TPU's MXU wants the contraction dim
  leading; the CUDA kernel's ``mma.sync`` s8 form wants both operands
  K-contiguous, which rows are, and rows are also the on-disk layout;
- ``scales``: (1, n_padded) f32 plane-1 row scales;
- ``res``: (n_padded, d) int8 plane 2 (the rows refine gathers from it);
- ``res_scales``: (1, n_padded) f32 plane-2 row scales.

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
from ..ops.mips_topt import mips_topk_int8r_t, quantize_int8_residual
from ._npio import np_load, np_save

NOT_PORTED = ("not ported yet: this slice stores int8r with the 'rows' "
              "refine only (ROADMAP queue A item 11)")


def _search_one_shard(q, emb, scales, res, res_scales, *, k, n_true,
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


class ShardedFlatIndex:
    """Flat int8r MIPS index on one device."""

    def __init__(self, n_passages: int, dim: int, dtype: str = "int8r", *,
                 device: str | torch.device = "cuda",
                 int8r_refine: str = "rows"):
        if int8r_refine not in ("rows", "rows1", "cols"):
            raise ValueError(
                f"int8r_refine must be rows|rows1|cols, got {int8r_refine!r}")
        if dtype != "int8r":
            raise NotImplementedError(f"index dtype {dtype!r} {NOT_PORTED}")
        if int8r_refine != "rows":
            raise NotImplementedError(
                f"int8r_refine {int8r_refine!r} {NOT_PORTED}")
        self.device = resolve_device(device)
        self.dim = dim
        self.n_passages = n_passages
        self.store_int8r = True
        self.int8r_refine = int8r_refine
        self.refine_r = 4
        self.n_shards = 1
        base = int(math.ceil(n_passages / 8) * 8)
        align = 2048 if base >= 2048 else 8
        self.shard_rows = int(math.ceil(n_passages / align) * align)
        self.n_padded = self.shard_rows
        zeros = functools.partial(torch.zeros, device=self.device)
        self.embeddings = zeros((self.n_padded, dim), dtype=torch.int8)
        self.scales = zeros((1, self.n_padded), dtype=torch.float32)
        self.res = zeros((self.n_padded, dim), dtype=torch.int8)
        self.res_scales = zeros((1, self.n_padded), dtype=torch.float32)

    # ------------------------------------------------------------------ build
    def set_embeddings(self, start: int, block) -> None:
        """Quantise a float (rows, d) block and write it at rows
        [start, start + rows)."""
        self.embeddings, aux = self.write_block(
            self.embeddings, (self.scales, self.res, self.res_scales),
            start, block)
        self.scales, self.res, self.res_scales = aux

    def write_block(self, buf_emb, buf_aux, start: int, block_rows):
        """Quantise ``block_rows`` and write both planes and their scales
        into ``buf_emb`` and the ``(scales, res, res_scales)`` tuple
        ``buf_aux`` at row ``start``, in place; returns the buffers."""
        x = torch.as_tensor(block_rows).to(self.device, torch.float32)
        rows = x.shape[0]
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"block must be (rows, {self.dim}), got "
                             f"{tuple(x.shape)}")
        if start < 0 or start + rows > buf_emb.shape[0]:
            raise ValueError(f"rows [{start}, {start + rows}) outside the "
                             f"index's {buf_emb.shape[0]}")
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
        fn = functools.partial(
            _search_one_shard, k=k, n_true=self.n_passages,
            shard_rows=self.shard_rows, n_padded=self.n_padded,
            refine_r=self.refine_r)
        return fn, (self.embeddings, self.scales, self.res, self.res_scales)

    # --------------------------------------------------------------- save/load
    def save(self, path: str, n_files: int = 16) -> None:
        """The JAX package's format: ``n_files`` row-major npy shards per
        array (plane 1 (N, d), scales (N, 1), plane 2 (N, d), residual
        scales (N, 1)) and a meta json."""
        n = self.n_passages
        os.makedirs(path, exist_ok=True)
        arrays = {
            "embeddings": self.embeddings[:n],
            "scales": self.scales[0, :n].reshape(n, 1),
            "res": self.res[:n],
            "res_scales": self.res_scales[0, :n].reshape(n, 1),
        }
        for name, arr in arrays.items():
            host = arr.cpu().numpy()
            for i, r in enumerate(np.array_split(host, n_files, axis=0)):
                np_save(os.path.join(path, f"{name}.{i}.npy"), r)
        meta = {
            "n_passages": n,
            "dim": self.dim,
            "dtype": "int8",
            "store_int8": True,  # the JAX package records int8r as both
            "store_int8r": True,
            "store_f16_bits": False,
            "store_hybrid": False,
            "n_files": n_files,
            "kind": "flat",
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cuda",
             int8r_refine: str = "rows"):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("kind", "flat") != "flat" or not meta.get("store_int8r"):
            raise NotImplementedError(
                f"saved index at {path} ({meta.get('kind', 'flat')}, "
                f"dtype {meta.get('dtype')}) is {NOT_PORTED}")
        idx = cls(meta["n_passages"], meta["dim"], "int8r", device=device,
                  int8r_refine=int8r_refine)
        start = 0
        for i in range(meta["n_files"]):
            def part(name):
                return torch.from_numpy(np.ascontiguousarray(np_load(
                    os.path.join(path, f"{name}.{i}.npy")))).to(idx.device)

            block = part("embeddings")
            rows = block.shape[0]
            if start + rows > meta["n_passages"]:
                raise ValueError(f"{path} holds more rows than its meta")
            idx.embeddings[start:start + rows] = block
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
        """Stored rows decoded to (n_passages, d) f32: v1*s1 + v2*s2."""
        n = self.n_passages
        return (self.embeddings[:n].to(torch.float32)
                * self.scales[0, :n, None]
                + self.res[:n].to(torch.float32) * self.res_scales[0, :n, None])
