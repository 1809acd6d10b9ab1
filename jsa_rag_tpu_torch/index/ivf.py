"""IVF (coarse-quantised) MIPS index, its lists sharded over the
processes.

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

Shards (``ivf.py:123-127, 160-167, 349-437``): the lists split over every
process of the grid (both axes), ``n_lists`` padded to a multiple of the
world size W; rank r owns lists [r C/W, (r+1) C/W). ``set_embeddings``
stages the rows of the rank's row range (the flat index's split), and the
build runs from each rank's own rows: the distributed k-means
(``ops/kmeans.py``), an all-gather of the assignments (every rank then
computes the same list plan), and one exchange in which each row's codes,
sq8 scale and refine copy travel once, to the rank that owns its list.
A search gathers every rank's queries (the JAX package's collective
search), scores the centroids on every rank, scans the probed lists the
rank owns with the same ``k_local`` (each rank rescoring its own pool under
refine), and merges the ranks' candidates as the flat index does
(``flat.merge_shards``); each rank takes back its own queries' rows.
``save`` gathers the lists to rank 0 in the one-process format; ``load``
keeps the rank's lists. One process is the case W = 1.

The JAX package's ``lax.scan`` visits one list a step; here the union's
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
from ..parallel import mesh
from ._npio import np_load, np_save, to_host
from .flat import merge_shards

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
    """IVF index, one shard of its lists per process of the grid."""

    def __init__(self, n_passages: int, dim: int, dtype="bfloat16", *,
                 device: str | torch.device = "cuda",
                 n_lists: int | None = None, n_probe: int | None = None,
                 storage: str = "dense", code_size: int = 32,
                 refine: bool = False, grid: mesh.Grid | None = None):
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
        self.n_shards = mesh.process_count() if grid is None else grid.world
        self.shard = mesh.process_index() if grid is None else grid.rank
        if self.n_shards != mesh.process_count():
            raise ValueError(f"a grid of {self.n_shards} shards under "
                             f"{mesh.process_count()} processes")
        c = n_lists or auto_n_lists(n_passages)
        w = self.n_shards
        self.n_lists = (c + w - 1) // w * w
        self.c_local = self.n_lists // w  # lists a rank owns
        self.list_lo = self.shard * self.c_local
        # the rows a rank stages and clusters: the JAX staging split
        self.shard_rows = int(math.ceil(n_passages / w / 8) * 8)
        self.row_offset = self.shard * self.shard_rows
        self.local_rows = min(max(n_passages - self.row_offset, 0),
                              self.shard_rows)
        self.n_probe = n_probe or max(self.n_lists // 16, 1)
        # dense rows are already full precision: refine only for sq8 / pq
        self.refine = bool(refine) and storage in ("sq8", "pq")
        self.refine_r = 4
        self.cap = 0            # the largest list rounded up to 8 (train)
        self.centroids = None   # (C, d) f32, on every rank
        # this rank's lists, packed: n rows of them
        self.offsets = None     # c_local + 1 list bounds (host)
        self.row_list = None    # (n,) int64: each packed row's (global) list
        self.list_rows = None   # (n, d | code_size) packed, list after list
        self.list_ids = None    # (n,) int32 passage ids
        self.list_scales = None  # sq8: (n,) f32 row scales
        self.list_rows_f16 = None  # refine: (n, d) float16
        self.codebooks = None   # pq: (m, 256, d / m) f32
        self.pq_rotation = None  # pq: (d, d) orthonormal
        self.build_s = {}       # the last train()'s seconds by stage
        self._staging = None

    # ------------------------------------------------------------------ build
    def _set_lists(self, row_list: torch.Tensor, cap: int) -> None:
        """Offsets from each packed row's (global, ascending) list."""
        counts = torch.bincount(row_list - self.list_lo,
                                minlength=self.c_local)
        self.offsets = [0] + torch.cumsum(counts, 0).tolist()
        self.cap = cap
        self.row_list = row_list

    def train(self, embeddings, *, generator: torch.Generator | None = None,
              iters: int = 10, chunk: int = 65536) -> None:
        """k-means, the list layout (each list's rows in corpus order) and,
        for pq, the codebooks; then every row quantised into its list, on
        the rank that owns it. ``embeddings``: this rank's rows, rows
        [``row_offset``, ``row_offset + local_rows``) of the corpus (all N
        in one process), in passage order; ``generator`` (on the index's
        device, seeded alike on every rank) draws the k-means init, the
        split noise and the rotation; seeded with 0 when None. Collective
        over several processes."""
        dev = self.device
        n = self.local_rows
        emb = torch.as_tensor(embeddings)[:n].to(dev)
        if dev.type == "cuda":
            exact_f32_matmul()
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        w = self.n_shards
        t0 = time.perf_counter()
        centroids, assign = kmeans(
            emb, self.n_lists, iters=iters,
            chunk=min(chunk, max(self.n_passages, 8)), generator=generator,
            group=torch.distributed.group.WORLD if w > 1 else None,
            n_total=self.n_passages, row_offset=self.row_offset)
        assign = assign.long()
        _sync(dev)
        self.build_s = {"kmeans": time.perf_counter() - t0}
        # every rank's assignments: the same list plan everywhere
        t0 = time.perf_counter()
        parts, counts = mesh.all_gather_ragged(assign)
        every = torch.cat([p[:c] for p, c in zip(parts, counts)])
        sizes = torch.bincount(every, minlength=self.n_lists)
        cap = max(int(((int(sizes.max()) + 7) // 8) * 8), 8)
        _sync(dev)
        if w > 1:
            self.build_s["allgather"] = time.perf_counter() - t0
        if self.storage == "pq":
            t0 = time.perf_counter()
            self._train_codebooks(emb, every, centroids, generator, iters)
            _sync(dev)
            self.build_s["codebooks"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        row_dim = self.code_size if self.storage == "pq" else self.dim
        rows = torch.empty((n, row_dim), dtype=self.store_dtype, device=dev)
        scales = (torch.empty(n, dtype=torch.float32, device=dev)
                  if self.storage == "sq8" else None)
        rows16 = (torch.empty((n, self.dim), dtype=torch.float16, device=dev)
                  if self.refine else None)
        # each rank's rows, grouped by the rank that owns their list
        order = torch.argsort(assign // self.c_local, stable=True)
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
                r = (e - centroids[assign[order[s:t]]]) @ self.pq_rotation.T
                rows[s:t] = _pq_encode(r, self.codebooks)
            if rows16 is not None:
                rows16[s:t] = e.to(torch.float16)
        ids = (order + self.row_offset).to(torch.int32)
        del emb
        _sync(dev)
        self.build_s["encode_scatter"] = time.perf_counter() - t0
        if w > 1:  # each row once, to the owner of its list
            t0 = time.perf_counter()
            dest = torch.bincount(assign // self.c_local, minlength=w)
            dest = dest.tolist()
            rows, ids = (mesh.exchange_rows(x, dest) for x in (rows, ids))
            if scales is not None:
                scales = mesh.exchange_rows(scales, dest)
            if rows16 is not None:
                rows16 = mesh.exchange_rows(rows16, dest)
            _sync(dev)
            self.build_s["exchange"] = time.perf_counter() - t0
        # list after list, each list's rows in corpus order
        lists = every[ids.long()]
        final = torch.argsort(lists * self.n_passages + ids.long())
        self._set_lists(lists[final], cap)
        self.centroids = centroids
        self.list_rows = rows[final]
        self.list_scales = scales[final] if scales is not None else None
        self.list_ids = ids[final]
        self.list_rows_f16 = rows16[final] if rows16 is not None else None

    def _train_codebooks(self, emb, every, centroids, generator,
                         iters: int) -> None:
        """256-entry L2 codebooks per subvector, trained on a
        ``linspace`` sample of at most 65,536 coarse residuals, after a
        random orthonormal rotation (the Q of a gaussian matrix's QR): it
        spreads a decaying spectrum's variance over the subvectors, and
        keeps inner products, q·r = (Rq)·(Rr) (``ivf.py:234-267``). The
        sample is of global row ids (``every``: all N assignments); each rank
        adds the residuals of the rows it holds, so every rank trains the
        same codebooks."""
        n = self.n_passages
        m, ds = self.code_size, self.dim // self.code_size
        dev = self.device
        rot = torch.linalg.qr(torch.randn((self.dim, self.dim),
                                          generator=generator, device=dev))[0]
        self.pq_rotation = rot.contiguous()
        sample_n = min(n, 65536)
        sample = torch.from_numpy(np.linspace(0, n - 1, sample_n).astype(
            np.int64)).to(dev)
        local = sample - self.row_offset
        mine = (local >= 0) & (local < emb.shape[0])
        res = torch.zeros((sample_n, self.dim), dtype=torch.float32,
                          device=dev)
        res[mine] = emb[local[mine]].to(torch.float32)
        if self.n_shards > 1:
            mesh.all_reduce_(res)
        res = (res - centroids[every[sample]]) @ rot.T
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
        """Stage global rows [start, start + rows); this rank keeps those
        of its row range."""
        if self._staging is None:
            self._staging = torch.zeros((self.shard_rows, self.dim),
                                        dtype=torch.float32,
                                        device=self.device)
        x = torch.as_tensor(block)
        if x.dim() != 2 or x.shape[1] != self.dim:
            raise ValueError(f"block must be (rows, {self.dim}), got "
                             f"{tuple(x.shape)}")
        if start < 0 or start + x.shape[0] > self.shard_rows * self.n_shards:
            raise ValueError(f"rows [{start}, {start + x.shape[0]}) outside "
                             f"the index's {self.n_passages}")
        lo = max(start, self.row_offset)
        hi = min(start + x.shape[0], self.row_offset + self.shard_rows)
        if lo < hi:
            self._staging[lo - self.row_offset:hi - self.row_offset] = x[
                lo - start:hi - start].to(self.device, torch.float32)

    def finalize(self, **kw) -> None:
        """Train on the staged rows, then free the staging buffer (keeping
        it would double the index's memory, and a later finalize would
        cluster stale rows)."""
        if self._staging is None:
            raise RuntimeError("set_embeddings must run before finalize()")
        self.train(self._staging[: self.local_rows], **kw)
        self._staging = None

    @classmethod
    def from_flat(cls, flat, n_lists: int | None = None,
                  n_probe: int | None = None, storage: str = "dense",
                  code_size: int = 32, refine: bool = False,
                  **kw) -> "ShardedIVFIndex":
        """An IVF index over a flat index's decoded rows (each rank's own:
        the two indexes split the rows alike); fp16 and int8 flat storages
        become bf16 (the JAX package's int16/int8 rule)."""
        dtype = (torch.bfloat16 if flat.dtype in (torch.float16, torch.int8)
                 else flat.dtype)
        idx = cls(flat.n_passages, flat.dim, dtype, device=flat.device,
                  n_lists=n_lists, n_probe=n_probe, storage=storage,
                  code_size=code_size, refine=refine)
        if idx.shard_rows != flat.shard_rows:
            raise ValueError("the flat index splits its rows otherwise")
        idx.train(flat.embeddings_as_float(), **kw)
        return idx

    # ----------------------------------------------------------------- search
    def search(self, queries, k: int, n_probe: int | None = None):
        """Top-k over the union of the lists the queries probe: this
        rank's queries (B, d) -> (scores (B, k) f32, ids (B, k) int32) on
        the index's device, -1 (and the f32 minimum) where the probed lists
        hold fewer than k rows. Every rank calls it together; B may differ
        between ranks (every rank's queries are searched as one batch, whose
        union of probed lists they share, and each takes back its own)."""
        n_probe = min(n_probe or self.n_probe, self.n_lists)
        k = min(k, self.n_passages)
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        if q.device.type == "cuda":
            exact_f32_matmul()
        if self.n_shards == 1:
            return self._run_search(q, k, n_probe)
        all_q, _ = mesh.all_gather_ragged(q)
        lo = self.shard * all_q.shape[1]
        s, i = self._run_search(all_q.reshape(-1, self.dim), k, n_probe)
        return s[lo:lo + q.shape[0]], i[lo:lo + q.shape[0]]

    def _groups(self, union: list[int]):
        """The union's lists in groups whose rows fit ``GROUP_BYTES`` of
        f32 (a larger list alone) -> [(lists, row index or slice)]."""
        budget = max(1, GROUP_BYTES // (self.dim * 4))
        off = self.offsets
        groups, cur, rows = [], [], 0
        for c in union:  # this rank's lists, local numbers
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
        union = [c - self.list_lo for c in torch.unique(probed).tolist()
                 if self.list_lo <= c < self.list_lo + self.c_local]
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
        if self.refine and self.list_ids.numel():
            # exact rescore of the pool from the fp16 copy, f32 products
            x = self.list_rows_f16[cp.reshape(-1)].reshape(
                b, k_local, self.dim).to(torch.float32)
            s_r = torch.bmm(x, q[:, :, None])[:, :, 0]
            cs = torch.where(ci >= 0, s_r, NEG_INF)
        if self.n_shards > 1:  # every rank's pool, rank after rank
            cs, ci = merge_shards(cs, ci, min(k, k_local * self.n_shards))
            k_local = cs.shape[1]
        kk = min(k, k_local)
        scores, a = top_k_lax(cs, kk)
        ids = torch.gather(ci, 1, a)
        if kk < k:  # fewer candidates than k: the slots stay unfilled
            scores = torch.cat([scores, scores.new_full((b, k - kk),
                                                        NEG_INF)], dim=1)
            ids = torch.cat([ids, ids.new_full((b, k - kk), -1)], dim=1)
        return scores, ids

    # -------------------------------------------------------------- save/load
    def _padded(self, packed: torch.Tensor, fill):
        """This rank's packed rows laid out (c_local, cap, ...), pads
        ``fill``, gathered (collective) to rank 0 into the (C, cap, ...)
        array the JAX package stores; None on the other ranks."""
        a = packed.detach()
        out = torch.full((self.c_local, self.cap, *a.shape[1:]), fill,
                         dtype=a.dtype, device=a.device)
        lists = self.row_list - self.list_lo
        off = torch.as_tensor(self.offsets, device=a.device)
        out[lists, torch.arange(a.shape[0], device=a.device)
            - off[lists]] = a
        every = mesh.gather_to_root(out)
        if every is None:
            return None
        return to_host(every.reshape(self.n_lists, *out.shape[1:]))

    def save(self, path: str, n_files: int = 8) -> None:
        """The JAX package's format (``ivf.py:429-477``): ``centroids``,
        ``n_files`` shards of ``clusters``/``ids`` (C, cap, ...) (and the
        refine copy ``clusters_f16`` as int16 bits) split with
        ``np.array_split``, ``scales`` (sq8), ``codebooks`` and
        ``pq_rotation`` (pq), and ``meta.json``; bf16 rows as uint16
        bits; pads are zeros with id -1. Over several processes every rank
        calls it; the lists gather to rank 0, which writes."""
        splits = {"clusters": self._padded(self.list_rows, 0),
                  "ids": self._padded(self.list_ids, -1)}
        if self.refine:
            splits["clusters_f16"] = self._padded(self.list_rows_f16, 0)
        scales = (self._padded(self.list_scales, 0)
                  if self.storage == "sq8" else None)
        if self.shard != 0:
            return
        os.makedirs(path, exist_ok=True)
        np_save(os.path.join(path, "centroids.npy"), to_host(self.centroids))
        for name, arr in splits.items():
            for i, part in enumerate(np.array_split(arr, n_files)):
                np_save(os.path.join(path, f"{name}.{i}.npy"), part)
        if self.storage == "sq8":
            np_save(os.path.join(path, "scales.npy"), scales)
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
    def load(cls, path: str, *, device: str | torch.device = "cuda",
             grid: mesh.Grid | None = None) -> "ShardedIVFIndex":
        """A directory either package saved; this rank keeps its lists of
        the (C, cap) layout, packed (the rows whose id is not -1, list after
        list). C must divide by the process count."""
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["n_passages"], meta["dim"], meta["dtype"],
                  device=device, n_lists=meta["n_lists"],
                  n_probe=meta["n_probe"],
                  storage=meta.get("storage", "dense"),
                  code_size=meta.get("code_size", 32),
                  refine=meta.get("refine", False), grid=grid)
        if idx.n_lists != meta["n_lists"]:
            raise ValueError(f"{meta['n_lists']} lists do not split over "
                             f"{idx.n_shards} processes")
        dev = idx.device
        mine = slice(idx.list_lo, idx.list_lo + idx.c_local)

        def shards(name, dtype=None):
            parts = [np_load(os.path.join(path, f"{name}.{i}.npy"), dtype)
                     for i in range(meta["n_files"])]
            return torch.cat([p if isinstance(p, torch.Tensor)
                              else torch.from_numpy(np.ascontiguousarray(p))
                              for p in parts])[mine]

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
        idx._set_lists((flat // cap + idx.list_lo).to(dev), meta["cap"])
        idx.centroids = array("centroids").to(dev, torch.float32)
        if idx.storage == "sq8":
            idx.list_scales = array("scales")[mine].reshape(-1)[flat].to(
                dev, torch.float32)
        elif idx.storage == "pq":
            idx.codebooks = array("codebooks").to(dev, torch.float32)
            idx.pq_rotation = array("pq_rotation").to(dev, torch.float32)
        if idx.refine:
            idx.list_rows_f16 = shards("clusters_f16").view(
                torch.float16).reshape(c * cap, -1)[flat].to(dev)
        return idx
