"""k-means (Lloyd's) for IVF coarse quantisation and PQ codebooks.

Counterpart of ``jsa_rag_tpu/ops/kmeans.py`` (:24-119): the assignment is a
chunked product plus ``argmax`` (first index on ties, as ``jnp.argmax``),
the update a segment sum, and an empty cluster is re-seeded by splitting a
populated one (FAISS's ``Clustering::post_process_centroids`` policy).

The segment sum is a one-hot product per chunk: the same cost as the
assignment, and deterministic on the card, where ``index_add_`` sums f32
with atomics and two builds could then assign a near-tie row differently.
The products run in f32 (TF32 off on the card). Randomness comes from an
explicit ``torch.Generator``; it cannot replay the JAX package's threefry
streams, so ``lloyd`` takes the initial centroids (and, optionally, the
split noise) from the caller.
"""

from __future__ import annotations

import torch


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _assign(e: torch.Tensor, centroids: torch.Tensor, metric: str,
            half_sq: torch.Tensor | None) -> torch.Tensor:
    """(rows, d) f32 -> (rows,) int64 nearest centroid: the largest inner
    product, or for ``l2`` the largest x·c - |c|²/2."""
    s = e @ centroids.T
    if metric == "l2":
        s = s - half_sq[None, :]
    return torch.argmax(s, dim=1)


def assign(embeddings: torch.Tensor, centroids: torch.Tensor,
           chunk: int = 65536, metric: str = "ip") -> torch.Tensor:
    """Every row's cluster, ``chunk`` rows a product. -> (N,) int32."""
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown k-means metric {metric!r}")
    half_sq = 0.5 * centroids.square().sum(-1) if metric == "l2" else None
    n = embeddings.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=embeddings.device)
    for lo in range(0, n, chunk):
        e = embeddings[lo:lo + chunk].to(torch.float32)
        out[lo:lo + chunk] = _assign(e, centroids, metric, half_sq)
    return out


def lloyd(embeddings: torch.Tensor, centroids: torch.Tensor, iters: int = 10,
          chunk: int = 65536, metric: str = "ip", spherical: bool = False,
          generator: torch.Generator | None = None,
          noise: torch.Tensor | None = None):
    """``iters`` Lloyd iterations from ``centroids`` (C, d), then the final
    assignment. -> (centroids (C, d) f32, assignments (N,) int32).

    Each iteration sums every cluster's rows (one-hot product per chunk)
    and takes their mean; a cluster left empty keeps no mean: the i-th
    empty slot (in index order) copies the i-th most populated centroid
    plus ``1e-3·|c|·N(0,1)/√d`` (``noise[it]``, (C, d), when given; else
    drawn from ``generator``), so the pair splits that cluster next
    iteration. ``spherical`` re-normalises the centroids each iteration."""
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown k-means metric {metric!r}")
    n, d = embeddings.shape
    dev = embeddings.device
    c = centroids.to(dev, torch.float32).clone()
    n_clusters = c.shape[0]
    if spherical:
        c = _l2n(c)
    for it in range(iters):
        half_sq = 0.5 * c.square().sum(-1) if metric == "l2" else None
        sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=dev)
        counts = torch.zeros(n_clusters, dtype=torch.int64, device=dev)
        for lo in range(0, n, chunk):
            e = embeddings[lo:lo + chunk].to(torch.float32)
            a = _assign(e, c, metric, half_sq)
            onehot = torch.zeros((e.shape[0], n_clusters),
                                 dtype=torch.float32, device=dev)
            onehot.scatter_(1, a[:, None], 1.0)
            sums += onehot.T @ e
            counts += torch.bincount(a, minlength=n_clusters)
        cnt = counts.to(torch.float32)
        new = torch.where(cnt[:, None] > 0,
                          sums / cnt.clamp_min(1.0)[:, None], c)
        empty = counts <= 0
        donors = torch.argsort(-counts, stable=True)
        rank = (torch.cumsum(empty.to(torch.int64), 0) - 1) % n_clusters
        donor = new[donors[rank]]
        scale = donor.norm(dim=1, keepdim=True)
        z = (noise[it].to(dev, torch.float32) if noise is not None
             else torch.randn((n_clusters, d), generator=generator,
                              device=dev))
        cand = donor + 1e-3 * scale * z / (d ** 0.5)
        c = torch.where(empty[:, None], cand, new)
        if spherical:
            c = _l2n(c)
    return c, assign(embeddings, c, chunk, metric)


def kmeans(embeddings: torch.Tensor, n_clusters: int, iters: int = 10,
           chunk: int = 65536, metric: str = "ip", spherical: bool = False,
           generator: torch.Generator | None = None):
    """-> (centroids (C, d) f32, assignments (N,) int32).

    ``metric="ip"``: inner-product assignment (the index is MIPS);
    ``"l2"``: Euclidean (PQ codebooks, which minimise reconstruction
    error). The initial centroids are ``n_clusters`` distinct rows drawn
    by ``generator`` (a fresh one seeded with 0 on the rows' device when
    None). ``spherical`` is opt-in, as in the JAX package."""
    n = embeddings.shape[0]
    if n < n_clusters:
        raise ValueError(
            f"kmeans: {n_clusters} clusters but only {n} points — use fewer "
            "lists (for corpora this small the flat index is the right "
            "tool)")
    dev = embeddings.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    init = torch.randperm(n, generator=generator, device=dev)[:n_clusters]
    return lloyd(embeddings, embeddings[init].to(torch.float32), iters=iters,
                 chunk=chunk, metric=metric, spherical=spherical,
                 generator=generator)
