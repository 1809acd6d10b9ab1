"""IVF (coarse-quantised) MIPS index on one device.

Counterpart of ``jsa_rag_tpu/index/ivf.py::ShardedIVFIndex`` (:88-546),
kept under the same class name, flags and on-disk format; the port of the
reference's FAISS IVF modes (ivfflat / ivfsq / ivfpq):

- lists: ``n_lists`` k-means centroids ``centroids`` (C, d) f32, every row
  in the list of its centroid;
- ``dense`` (ivfflat: bf16 or f32 rows), ``sq8`` (ivfsq: per-row symmetric
  int8 plus an f32 scale) and ``pq`` (ivfpq: residuals against the coarse
  centroid, rotated by a random orthonormal matrix, ``code_size``
  subvectors each coded by a 256-entry L2 codebook: ``code_size`` bytes a
  row); ``refine`` keeps an fp16 copy of every row and rescores the
  quantised scan's top-(refine_r*k) in f32;
- search: the queries score the centroids, take their top-``n_probe``
  lists, and every query is scored against every row of the batch's union
  of lists (a superset of FAISS's per-query probe, so recall at a given
  ``n_probe`` is at least FAISS's).

Layout. The JAX package pads every list to ``cap`` rows (the largest list
rounded up to 8) and stores (C, cap, ...) arrays; that is the on-disk
format here too (``save``/``load``). In memory the port keeps the lists
packed: ``list_rows`` (N, d | code_size) holds the rows list after list
(each list in corpus order: the stable argsort of the assignments),
``offsets`` the C + 1 list bounds. Inner-product k-means on clustered
embeddings leaves lists far from even (on ``chip_smoke.py``'s 1.3M-row
corpus with 1,140 lists the largest holds 24.7 times the mean), and the
padded layout of such lists is mostly padding: memory and scan time then
follow C x cap (66 GB for those rows in bf16), where packed lists follow N
(2.7 GB).

One device and no shard axis (several devices are ROADMAP queue A item
13). The JAX package's ``lax.scan`` visits one list a step; here the union's
lists are scored in groups of up to ``GROUP_BYTES`` of f32 working tile
(the group's rows converted to f32, or pq's decoded rows), one product a
group, each merged into the running top-k. A run of consecutive lists is
read in place; any other group is gathered. Equal scores keep the lower
(list, row) position, as in the JAX scan, so neither the grouping nor the
packing changes a result. Products run in f32 (TF32 off on the card); no
kernel of this module is hand-written (the JAX package computes it in XLA,
outside any Pallas kernel).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

from ..device import exact_f32_matmul, resolve_device
from ..models.lm import top_k_lax
from ..ops.kmeans import kmeans
from ..ops.mips_topt import quantize_int8
from ._npio import np_load, np_save, to_host

NEG_INF = float(torch.finfo(torch.float32).min)
GROUP_BYTES = 1 << 30  # f32 working tile of one scan group
PQ_ENCODE_ROWS = 16384  # rows a PQ encode product takes at a time
SCATTER_ROWS = 262144   # rows quantised and written at a time in train
DENSE = {"bfloat16": torch.bfloat16, "float32": torch.float32}
STORE_DTYPE = {"sq8": torch.int8, "pq": torch.uint8}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pq_encode(residuals: torch.Tensor, codebooks: torch.Tensor
               ) -> torch.Tensor:
    """(rows, d) residuals -> (rows, m) uint8 codes: per subvector the
    codeword of least L2 distance, i.e. the largest r·c - |c|²/2, against
    the (m, K, ds) codebooks (``ivf.py:56-65``), ``PQ_ENCODE_ROWS`` rows a
    product."""
    rows = residuals.shape[0]
    m, _, ds = codebooks.shape
    half_sq = 0.5 * codebooks.square().sum(-1)  # (m, K)
    out = torch.empty((rows, m), dtype=torch.uint8, device=residuals.device)
    for lo in range(0, rows, PQ_ENCODE_ROWS):
        r = residuals[lo:lo + PQ_ENCODE_ROWS].to(torch.float32)
        r = r.reshape(-1, m, ds).transpose(0, 1)  # (m, rows, ds)
        s = torch.bmm(r, codebooks.transpose(1, 2)) - half_sq[:, None, :]
        out[lo:lo + PQ_ENCODE_ROWS] = s.argmax(-1).T.to(torch.uint8)
    return out


def _pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(rows, m) codes -> (rows, d) f32 reconstructed (rotated) residuals."""
    m = codebooks.shape[0]
    rec = codebooks[torch.arange(m, device=codes.device)[None, :],
                    codes.long()]
    return rec.reshape(codes.shape[0], -1)


def auto_n_lists(n: int) -> int:
    return int(min(max(int(math.sqrt(max(n, 1))), 16), 2048))


class ShardedIVFIndex:
    """IVF index on one device (the JAX class without its mesh)."""

    def __init__(self, n_passages: int, dim: int, dtype="bfloat16", *,
                 device: str | torch.device = "cuda",
                 n_lists: int | None = None, n_probe: int | None = None,
                 storage: str = "dense", code_size: int = 32,
                 refine: bool = False):
        self.device = resolve_device(device)
        self.n_passages = n_passages
        self.dim = dim
        name = _dtype_name(dtype)
        if name in ("hybrid", "int8r"):
            # the IVF analogue of both flat schemes: a quantised probe scan
            # and an exact rescore (ivf.py:97-106)
            refine = True
            if storage == "dense":
                storage = "sq8"
            name = "bfloat16"
        if name == "int8" and storage == "dense":
            # --index_dtype int8 with --index_mode ivf is the reference's
            # ivfsq; an explicit pq request stays pq
            storage, name = "sq8", "bfloat16"
        elif name in ("int8", "float16", "int16"):
            # no raw-bits list storage: fp16 requests become bf16 dense
            name = "bfloat16"
        if name not in DENSE:
            raise ValueError(f"IVF dtype must be one of {sorted(DENSE)} "
                             f"(or a flat one it maps), got {dtype!r}")
        if storage not in ("dense", "sq8", "pq"):
            raise ValueError(f"unknown IVF storage {storage!r}")
        if storage == "pq" and dim % code_size != 0:
            raise ValueError(f"code_size {code_size} must divide dim {dim}")
        self.storage = storage
        self.code_size = code_size  # PQ: subvectors a row == bytes a row
        self.dtype = DENSE[name]
        self.store_dtype = STORE_DTYPE.get(storage, self.dtype)
        self.n_shards = 1
        self.n_lists = n_lists or auto_n_lists(n_passages)
        self.n_probe = n_probe or max(self.n_lists // 16, 1)
        # dense rows are already full precision: refine only for sq8 / pq
        self.refine = bool(refine) and storage in ("sq8", "pq")
        self.refine_r = 4
        self.cap = 0            # the largest list rounded up to 8 (train)
        self.centroids = None   # (C, d) f32
        self.offsets = None     # C + 1 list bounds in the packed rows (host)
        self.row_list = None    # (N,) int64: each packed row's list
        self.list_rows = None   # (N, d | code_size) packed, list after list
        self.list_ids = None    # (N,) int32 passage ids
        self.list_scales = None  # sq8: (N,) f32 row scales
        self.list_rows_f16 = None  # refine: (N, d) float16
        self.codebooks = None   # pq: (m, 256, d / m) f32
        self.pq_rotation = None  # pq: (d, d) orthonormal
        self.build_s = {}       # the last train()'s seconds by stage
        self._staging = None

    # ------------------------------------------------------------------ build
    def _set_lists(self, row_list: torch.Tensor) -> None:
        """Offsets and ``cap`` from each packed row's list (ascending)."""
        counts = torch.bincount(row_list, minlength=self.n_lists)
        self.offsets = [0] + torch.cumsum(counts, 0).tolist()
        self.cap = max(int(((int(counts.max()) + 7) // 8) * 8), 8)
        self.row_list = row_list

    def train(self, embeddings, *, generator: torch.Generator | None = None,
              iters: int = 10, chunk: int = 65536) -> None:
        """k-means, the list layout (each list's rows in corpus order: the
        stable argsort of the assignments) and, for pq, the codebooks;
        then every row quantised into its list. ``embeddings``: (N, d) rows
        in global passage order; ``generator`` (on the index's device)
        draws the k-means init, the split noise and the rotation; seeded
        with 0 when None."""
        dev = self.device
        n = self.n_passages
        emb = torch.as_tensor(embeddings)[:n].to(dev)
        if dev.type == "cuda":
            exact_f32_matmul()
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        centroids, assign = kmeans(emb, self.n_lists, iters=iters,
                                   chunk=min(chunk, max(n, 8)),
                                   generator=generator)
        a = assign.long()
        order = torch.argsort(a, stable=True)
        self._set_lists(a[order])
        self.build_s = {"kmeans": time.perf_counter() - t0}
        if self.storage == "pq":
            t0 = time.perf_counter()
            self._train_codebooks(emb, a, centroids, generator, iters)
            _sync(dev)
            self.build_s["codebooks"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        row_dim = self.code_size if self.storage == "pq" else self.dim
        rows = torch.empty((n, row_dim), dtype=self.store_dtype, device=dev)
        scales = (torch.empty(n, dtype=torch.float32, device=dev)
                  if self.storage == "sq8" else None)
        rows16 = (torch.empty((n, self.dim), dtype=torch.float16, device=dev)
                  if self.refine else None)
        for s in range(0, n, SCATTER_ROWS):
            t = min(s + SCATTER_ROWS, n)
            e = emb[order[s:t]].to(torch.float32)
            if self.storage == "dense":
                rows[s:t] = e.to(self.dtype)
            elif self.storage == "sq8":
                v, sc = quantize_int8(e)
                rows[s:t] = v
                scales[s:t] = sc[:, 0]
            else:  # rotated residuals against the coarse centroid
                r = (e - centroids[self.row_list[s:t]]) @ self.pq_rotation.T
                rows[s:t] = _pq_encode(r, self.codebooks)
            if rows16 is not None:
                rows16[s:t] = e.to(torch.float16)
        _sync(dev)
        self.build_s["encode_scatter"] = time.perf_counter() - t0
        self.centroids = centroids
        self.list_rows, self.list_scales = rows, scales
        self.list_ids = order.to(torch.int32)
        self.list_rows_f16 = rows16

    def _train_codebooks(self, emb, assign, centroids, generator,
                         iters: int) -> None:
        """256-entry L2 codebooks per subvector, trained on a
        ``linspace`` sample of at most 65,536 coarse residuals, after a
        random orthonormal rotation (the Q of a gaussian matrix's QR): it
        spreads a decaying spectrum's variance over the subvectors, and
        keeps inner products, q·r = (Rq)·(Rr) (``ivf.py:234-267``)."""
        n = emb.shape[0]
        m, ds = self.code_size, self.dim // self.code_size
        dev = self.device
        rot = torch.linalg.qr(torch.randn((self.dim, self.dim),
                                          generator=generator, device=dev))[0]
        self.pq_rotation = rot.contiguous()
        sample_n = min(n, 65536)
        sample = torch.from_numpy(np.linspace(0, n - 1, sample_n).astype(
            np.int64)).to(dev)
        res = (emb[sample].to(torch.float32)
               - centroids[assign[sample]]) @ rot.T
        n_codes = min(256, sample_n)
        self.codebooks = torch.stack([
            kmeans(res[:, j * ds:(j + 1) * ds].contiguous(), n_codes,
                   iters=iters, chunk=min(65536, max(sample_n, 8)),
                   metric="l2", generator=generator)[0]
            for j in range(m)])  # (m, K, ds)

    # --------------------------------------------------- build-pipeline API
    # The embed sweep (index/build.py) writes row blocks in corpus order;
    # IVF stages them in an f32 buffer and clusters on finalize(), as the
    # reference trains FAISS after the fill (src/rag.py:122-130)
    def set_embeddings(self, start: int, block) -> None:
        if self._staging is None:
            rows = int(math.ceil(self.n_passages / 8) * 8)
            self._staging = torch.zeros((rows, self.dim),
                                        dtype=torch.float32,
                                        device=self.device)
        x = torch.as_tensor(block).to(self.device, torch.float32)
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"block must be (rows, {self.dim}), got "
                             f"{tuple(x.shape)}")
        if start < 0 or start + x.shape[0] > self._staging.shape[0]:
            raise ValueError(f"rows [{start}, {start + x.shape[0]}) outside "
                             f"the index's {self.n_passages}")
        self._staging[start:start + x.shape[0]] = x

    def finalize(self, **kw) -> None:
        """Train on the staged rows, then free the staging buffer (keeping
        it would double the index's memory, and a later finalize would
        cluster stale rows)."""
        if self._staging is None:
            raise RuntimeError("set_embeddings must run before finalize()")
        self.train(self._staging[: self.n_passages], **kw)
        self._staging = None

    @classmethod
    def from_flat(cls, flat, n_lists: int | None = None,
                  n_probe: int | None = None, storage: str = "dense",
                  code_size: int = 32, refine: bool = False,
                  **kw) -> "ShardedIVFIndex":
        """An IVF index over a flat index's decoded rows; fp16 and int8
        flat storages become bf16 (the JAX package's int16/int8 rule)."""
        dtype = (torch.bfloat16 if flat.dtype in (torch.float16, torch.int8)
                 else flat.dtype)
        idx = cls(flat.n_passages, flat.dim, dtype, device=flat.device,
                  n_lists=n_lists, n_probe=n_probe, storage=storage,
                  code_size=code_size, refine=refine)
        idx.train(flat.embeddings_as_float(), **kw)
        return idx

    # ----------------------------------------------------------------- search
    def search(self, queries, k: int, n_probe: int | None = None):
        """Top-k over the union of the lists the queries probe: queries
        (B, d) -> (scores (B, k) f32, ids (B, k) int32) on the index's
        device, -1 (and the f32 minimum) where the probed lists hold fewer
        than k rows."""
        n_probe = min(n_probe or self.n_probe, self.n_lists)
        k = min(k, self.n_passages)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.device.type == "cuda":
            exact_f32_matmul()
        return self._run_search(q, k, n_probe)

    def _groups(self, union: list[int]):
        """The union's lists in groups whose rows fit ``GROUP_BYTES`` of
        f32 (a larger list alone) -> [(lists, row index or slice)]."""
        budget = max(1, GROUP_BYTES // (self.dim * 4))
        off = self.offsets
        groups, cur, rows = [], [], 0
        for c in union:
            n = off[c + 1] - off[c]
            if cur and rows + n > budget:
                groups.append(cur)
                cur, rows = [], 0
            if n:
                cur.append(c)
                rows += n
        if cur:
            groups.append(cur)
        out = []
        for lists in groups:
            if lists[-1] - lists[0] == len(lists) - 1:  # read in place
                out.append(slice(off[lists[0]], off[lists[-1] + 1]))
            else:
                out.append(torch.from_numpy(np.concatenate(
                    [np.arange(off[c], off[c + 1]) for c in lists])).to(
                        self.device))
        return out

    def _group_scores(self, q, q_rot, c_scores, sel):
        """(B, R) scores of every query against the R packed rows ``sel``
        (a slice or an index) and their row positions."""
        if isinstance(sel, slice):
            rows = self.list_rows[sel]
            pos = torch.arange(sel.start, sel.stop, device=q.device)
        else:
            rows = self.list_rows.index_select(0, sel)
            pos = sel
        if self.storage == "dense":
            s = q @ rows.to(torch.float32).T
        elif self.storage == "sq8":
            s = (q @ rows.to(torch.float32).T) * self.list_scales[pos][None]
        else:  # decode and multiply; the coarse term from the probe
            s = (q_rot @ _pq_decode(rows, self.codebooks).T
                 + c_scores[:, self.row_list[pos]])
        return s, pos

    def _run_search(self, q, k: int, n_probe: int):
        b = q.shape[0]
        dev = q.device
        n_sel = min(self.n_lists, b * n_probe)
        c_scores = q @ self.centroids.T  # (B, C)
        q_rot = q @ self.pq_rotation.T if self.storage == "pq" else None
        _, probed = top_k_lax(c_scores, n_probe)  # (B, n_probe)
        union = torch.unique(probed).tolist()  # ascending, <= n_sel lists
        # with refine, a wider pool for the exact rescore
        k_local = min(self.refine_r * k if self.refine else k,
                      self.cap * n_sel)
        cs = torch.full((b, k_local), NEG_INF, dtype=torch.float32,
                        device=dev)
        ci = torch.full((b, k_local), -1, dtype=torch.int32, device=dev)
        cp = torch.zeros((b, k_local), dtype=torch.int64, device=dev)
        for sel in self._groups(union):
            s, pos = self._group_scores(q, q_rot, c_scores, sel)
            # the carry first: equal scores keep the earlier position
            cs, a = top_k_lax(torch.cat([cs, s], dim=1), k_local)
            ci = torch.gather(torch.cat(
                [ci, self.list_ids[pos].expand(b, -1)], dim=1), 1, a)
            cp = torch.gather(torch.cat([cp, pos.expand(b, -1)], dim=1), 1,
                              a)
        if self.refine:
            # exact rescore of the pool from the fp16 copy, f32 products
            x = self.list_rows_f16[cp.reshape(-1)].reshape(
                b, k_local, self.dim).to(torch.float32)
            s_r = torch.bmm(x, q[:, :, None])[:, :, 0]
            cs = torch.where(ci >= 0, s_r, NEG_INF)
        kk = min(k, k_local)
        scores, a = top_k_lax(cs, kk)
        ids = torch.gather(ci, 1, a)
        if kk < k:  # fewer candidates than k: the slots stay unfilled
            scores = torch.cat([scores, scores.new_full((b, k - kk),
                                                        NEG_INF)], dim=1)
            ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], dim=1)
        return scores, ids

    # -------------------------------------------------------------- save/load
    def _padded(self, packed: torch.Tensor, fill) -> np.ndarray:
        """The packed rows laid out (C, cap, ...) as the JAX package stores
        them, pads ``fill``."""
        a = to_host(packed)
        out = np.full((self.n_lists, self.cap, *a.shape[1:]), fill,
                      dtype=a.dtype)
        lists = self.row_list.cpu().numpy()
        off = np.asarray(self.offsets, np.int64)
        out[lists, np.arange(a.shape[0]) - off[lists]] = a
        return out

    def save(self, path: str, n_files: int = 8) -> None:
        """The JAX package's format (``ivf.py:429-477``): ``centroids``,
        ``n_files`` shards of ``clusters``/``ids`` (C, cap, ...) (and the
        refine copy ``clusters_f16`` as int16 bits) split with
        ``np.array_split``, ``scales`` (sq8), ``codebooks`` and
        ``pq_rotation`` (pq), and ``meta.json``; bf16 rows as uint16
        bits; pads are zeros with id -1."""
        os.makedirs(path, exist_ok=True)
        np_save(os.path.join(path, "centroids.npy"), to_host(self.centroids))
        splits = {"clusters": self._padded(self.list_rows, 0),
                  "ids": self._padded(self.list_ids, -1)}
        if self.refine:
            splits["clusters_f16"] = self._padded(self.list_rows_f16, 0)
        for name, arr in splits.items():
            for i, part in enumerate(np.array_split(arr, n_files)):
                np_save(os.path.join(path, f"{name}.{i}.npy"), part)
        if self.storage == "sq8":
            np_save(os.path.join(path, "scales.npy"),
                    self._padded(self.list_scales, 0))
        elif self.storage == "pq":
            np_save(os.path.join(path, "codebooks.npy"),
                    to_host(self.codebooks))
            np_save(os.path.join(path, "pq_rotation.npy"),
                    to_host(self.pq_rotation))
        meta = {"n_passages": self.n_passages, "dim": self.dim,
                "dtype": _dtype_name(self.dtype),
                "n_lists": self.n_lists, "n_probe": self.n_probe,
                "cap": self.cap, "n_files": n_files, "kind": "ivf",
                "storage": self.storage, "code_size": self.code_size,
                "refine": self.refine}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, *, device: str | torch.device = "cuda"
             ) -> "ShardedIVFIndex":
        """A directory either package saved; the (C, cap) lists are packed
        on load (the rows whose id is not -1, list after list)."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["n_passages"], meta["dim"], meta["dtype"],
                  device=device, n_lists=meta["n_lists"],
                  n_probe=meta["n_probe"],
                  storage=meta.get("storage", "dense"),
                  code_size=meta.get("code_size", 32),
                  refine=meta.get("refine", False))
        dev = idx.device

        def shards(name, dtype=None):
            parts = [np_load(os.path.join(path, f"{name}.{i}.npy"), dtype)
                     for i in range(meta["n_files"])]
            return torch.cat([p if isinstance(p, torch.Tensor)
                              else torch.from_numpy(np.ascontiguousarray(p))
                              for p in parts])

        def array(name):
            return torch.from_numpy(np.ascontiguousarray(
                np_load(os.path.join(path, f"{name}.npy"))))

        ids = shards("ids").to(torch.int32)
        c, cap = ids.shape
        keep = (ids >= 0).reshape(-1)
        flat = torch.arange(c * cap)[keep]
        # dense bf16 clusters are uint16 bit views: np_load re-views them
        dense = idx.storage == "dense"
        clusters = shards("clusters", idx.dtype if dense else None)
        idx.list_rows = clusters.reshape(c * cap, -1)[flat].to(
            dev, idx.store_dtype)
        idx.list_ids = ids.reshape(-1)[flat].to(dev)
        idx._set_lists((flat // cap).to(dev))
        idx.cap = meta["cap"]
        idx.centroids = array("centroids").to(dev, torch.float32)
        if idx.storage == "sq8":
            idx.list_scales = array("scales").reshape(-1)[flat].to(
                dev, torch.float32)
        elif idx.storage == "pq":
            idx.codebooks = array("codebooks").to(dev, torch.float32)
            idx.pq_rotation = array("pq_rotation").to(dev, torch.float32)
        if idx.refine:
            idx.list_rows_f16 = shards("clusters_f16").view(
                torch.float16).reshape(c * cap, -1)[flat].to(dev)
        return idx
