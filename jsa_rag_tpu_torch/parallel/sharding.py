"""Parameter placement: FSDP over the data axis and Megatron tensor
parallelism over the index axis (counterpart of
``jsa_rag_tpu/parallel/sharding.py``).

The JAX package writes a ``PartitionSpec`` per leaf and lets GSPMD insert
the collectives. The port keeps the same rules as pure functions over
shapes (``lm_tp_specs``, ``fsdp_specs``: for each leaf the dim split over
an axis, or None), and carries them out itself:

- ``Placement`` narrows each leaf of a param tree to this rank's shard, in
  place (``tensor.data``), and gathers it back: FSDP leaves (split over
  ``data``) are gathered before each step and narrowed after the backward;
  tensor-parallel leaves (split over ``index``) stay narrowed, and the
  forward computes on them (``models/lm.py``). AdamW built after the
  placement creates its moments on the shards (the JAX package's
  ``sharded_opt_init``); nothing else is needed for the sharded optimizer.
- the Megatron pair of collectives that carry a gradient
  (``copy_to_group``: identity forward, all-reduce backward;
  ``reduce_from_group``: all-reduce forward, identity backward) and the
  vocab gather for decoding (``gather_last_dim``).

Placed leaves own their storage: no two leaves share one (the posterior
retriever starts as a copy of the prior), and a split leaf never shares
the full tensor's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from . import mesh

DATA, INDEX = "data", "index"
BUCKET_BYTES = 256 << 20  # bytes a gather or reduce-scatter bucket holds
ATTENTION = ("q_w", "k_w", "v_w", "o_w")


class Split(NamedTuple):
    """A leaf split along ``dim`` over the grid axis ``axis``."""

    dim: int
    axis: str


# ------------------------------------------------------------------ specs
def lm_tp_specs(params: dict, size: int, axis: str = INDEX) -> dict:
    """The split of each leaf of an ``lm.py`` param tree under tensor
    parallelism over ``size`` ranks (``sharding.py:30-64``): q/k/v and
    gate/up by output columns, o and down by input rows, ``embed`` by vocab
    rows, ``lm_head`` by vocab columns, each only where the dim divides;
    every other leaf (norms, gpt2's fused qkv and MLP) replicated."""

    def col(w):
        return Split(1, axis) if w.shape[1] % size == 0 else None

    def row(w):
        return Split(0, axis) if w.shape[0] % size == 0 else None

    specs: dict = {}
    for key, val in params.items():
        if key == "embed":
            specs[key] = row(val)
        elif key == "lm_head":
            specs[key] = col(val)
        elif key == "layers":
            specs[key] = []
            for layer in val:
                ls = {}
                for name, w in layer.items():
                    if name in ("q_w", "k_w", "v_w", "gate_w", "up_w"):
                        ls[name] = col(w)
                    elif name in ("o_w", "down_w"):
                        ls[name] = row(w)
                    else:
                        ls[name] = None
                specs[key].append(ls)
        else:
            specs[key] = None
    return specs


def whole_heads(specs: dict, cfg, size: int) -> dict:
    """``lm_tp_specs`` with the llama attention leaves replicated where
    ``heads`` or ``kv_heads`` is not a multiple of ``size``: the JAX rule
    checks only that the flat dim divides and GSPMD re-shards mid-head,
    but a shard of whole heads cannot exist then. The numbers are the
    same."""
    if cfg.arch == "gpt2" or (cfg.heads % size == 0
                              and cfg.kv_heads % size == 0):
        return specs
    out = dict(specs)
    out["layers"] = [{k: (None if k in ATTENTION else v)
                      for k, v in layer.items()} for layer in specs["layers"]]
    return out


def fsdp_specs(tree, size: int, axis: str = DATA):
    """Each leaf split along its largest dim that ``size`` divides (ties:
    the later dim, as ``np.argsort(shape)[::-1]`` orders them), or None
    (``sharding.py:66-84``); the tree's dicts and lists mirrored."""
    if isinstance(tree, dict):
        return {k: fsdp_specs(v, size, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [fsdp_specs(v, size, axis) for v in tree]
    shape = tuple(getattr(tree, "shape", ()))
    for dim in np.argsort(shape)[::-1] if shape else ():
        if shape[dim] % size == 0 and shape[dim] >= size:
            return Split(int(dim), axis)
    return None


# ------------------------------------------------- Megatron's f and g
class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` (in f32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.to(torch.float32, copy=True)
        mesh.all_reduce_(s, group=ctx.group)
        return s.to(g.dtype), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over ``group``, taken in f32 and cast back once; identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        s = x.to(torch.float32, copy=True)
        mesh.all_reduce_(s, group=group)
        return s.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLastDim(torch.autograd.Function):
    """The ranks' ``x`` concatenated along the last dim, in group-rank
    order; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.n = rank, x.shape[-1]
        return torch.cat(list(mesh.all_gather(x, group).unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None, None


def copy_to_group(x, group):
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return _ReduceFromGroup.apply(x, group)


def gather_last_dim(x, group, rank: int):
    return _GatherLastDim.apply(x, group, rank)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """A generator's tensor-parallel layout on this rank: ``size`` ranks of
    ``group``, this one ``rank``; which parts are split (``attn``: llama's
    q/k/v/o by whole heads, or gpt2's o rows; ``mlp``: gate/up/down;
    ``vocab``: the embedding rows and the head's columns)."""

    group: object
    size: int
    rank: int
    attn: bool
    mlp: bool
    vocab: bool


def tensor_parallel_of(gen_specs: dict, group, size: int,
                       rank: int) -> TensorParallel:
    """The layout a generator spec tree (``whole_heads(lm_tp_specs())``)
    gives."""
    layer = gen_specs["layers"][0] if gen_specs["layers"] else {}
    return TensorParallel(
        group=group, size=size, rank=rank,
        attn=layer.get("o_w") is not None,
        mlp=layer.get("down_w") is not None,
        vocab=gen_specs.get("embed") is not None)


# -------------------------------------------------------------- placement
def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _buckets(items: list, size, cap: int = BUCKET_BYTES) -> list:
    """Consecutive runs of ``items`` of at most ``cap`` bytes by
    ``size(item)`` (a larger item stands alone)."""
    out, run, n = [], [], 0
    for it in items:
        b = size(it)
        if run and n + b > cap:
            out.append(run)
            run, n = [], 0
        run.append(it)
        n += b
    if run:
        out.append(run)
    return out


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Placement:
    """The leaves of a param tree (``named_leaves`` order) and their
    splits on ``grid``, with the collectives that move between the full
    and the sharded tree. Built on the full tree; ``shard_`` then narrows
    it. ``seconds`` accumulates the host seconds of the FSDP gathers and
    the gradient reduce-scatters (each timed between device syncs)."""

    def __init__(self, paths: list, leaves: list, specs: list, grid,
                 partial: list | None = None):
        self.paths, self.leaves, self.specs = paths, leaves, specs
        self.grid = grid
        data, index = mesh.axis_groups(grid)
        self.group = {DATA: data, INDEX: index}
        self.size = {DATA: grid.n_data, INDEX: grid.n_index}
        self.coord = {DATA: grid.data_rank, INDEX: grid.index_rank}
        # gradients that are partial sums over the index group (the LoRA
        # adapters of a tensor-parallel projection)
        self.partial = partial or [False] * len(leaves)
        self.full_shapes = [tuple(t.shape) for t in leaves]
        self.sharded = {DATA: False, INDEX: False}
        self.seconds = {"gather": 0.0, "reduce_scatter": 0.0}
        for s in specs:
            if s is not None and self.size[s.axis] == 1:
                raise ValueError(f"a split over the {s.axis} axis of size 1")

    def on(self, axis: str) -> list[int]:
        """The leaves split over ``axis``."""
        return [i for i, s in enumerate(self.specs)
                if s is not None and s.axis == axis]

    @property
    def split(self) -> bool:
        return any(s is not None for s in self.specs)

    def shard_of(self, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf ``i``'s full value (a view)."""
        s = self.specs[i]
        if s is None:
            return full
        n = self.full_shapes[i][s.dim] // self.size[s.axis]
        return full.narrow(s.dim, self.coord[s.axis] * n, n)

    def dealias_(self) -> None:
        """Give every leaf that shares storage with an earlier one a copy
        of its own (the storage pointers are compared, not the tensors: two
        views of one storage are two tensors). One tensor at two paths
        cannot be given two storages in place, and raises."""
        if len({id(t) for t in self.leaves}) != len(self.leaves):
            raise ValueError("one tensor at two paths of the param tree")
        seen = set()
        for t in self.leaves:
            if _storage(t) in seen:
                t.data = t.data.clone()
            seen.add(_storage(t))

    def shard_(self, axes=(DATA, INDEX)) -> None:
        """Narrow the leaves split over ``axes`` to this rank's part, each
        into storage of its own (the full tensor is freed)."""
        for axis in axes:
            if self.sharded[axis]:
                continue
            for i in self.on(axis):
                t = self.leaves[i]
                t.data = self.shard_of(i, t.data).clone(
                    memory_format=torch.contiguous_format)
            self.sharded[axis] = True

    def gather_(self, axes=(DATA, INDEX)) -> None:
        """The full value of every leaf split over ``axes``, on every rank
        (collective), in buckets of ``BUCKET_BYTES``."""
        for axis in axes:
            if not self.sharded[axis]:
                continue
            idx = self.on(axis)
            if idx:
                t0 = time.perf_counter()
                full = self.gather_values([self.leaves[i].data for i in idx],
                                          idx)
                for i, f in zip(idx, full):
                    self.leaves[i].data = f
                if axis == DATA:
                    self.seconds["gather"] += time.perf_counter() - t0
            self.sharded[axis] = False

    @contextlib.contextmanager
    def full(self, axes=(DATA, INDEX)):
        """The leaves split over ``axes`` gathered inside the block, and
        narrowed again after it where they were sharded before."""
        was = [a for a in axes if self.sharded[a]]
        self.gather_(was)
        try:
            yield
        finally:
            self.shard_(was)

    def gather_values(self, shards: list, idx: list) -> list:
        """Full values of leaves ``idx`` from this rank's ``shards`` of them
        (any dtype; all split over one axis): their bytes gathered in
        buckets, each leaf's parts concatenated along its dim."""
        axis = self.specs[idx[0]].axis
        group, w = self.group[axis], self.size[axis]
        out = [None] * len(idx)
        order = list(range(len(idx)))
        for run in _buckets(order, lambda j: shards[j].numel()
                            * shards[j].element_size()):
            flat = torch.cat([shards[j].contiguous().reshape(-1).view(
                torch.uint8) for j in run])
            _sync(flat)
            every = mesh.all_gather(flat, group)  # (W, bytes)
            off = 0
            for j in run:
                sh = shards[j]
                nb = sh.numel() * sh.element_size()
                parts = every[:, off:off + nb].contiguous().view(
                    sh.dtype).reshape(w, *sh.shape)
                out[j] = torch.cat(list(parts.unbind(0)),
                                   dim=self.specs[idx[j]].dim)
                off += nb
        return out

    def reduce_scatter_mean(self, grads: dict) -> dict:
        """{leaf i: full gradient} of leaves split over ``data`` -> {i:
        this rank's part of the mean over the data group}, in f32
        buckets; gradients that are partial over the index group are
        summed over it first. Rounded once to each gradient's dtype."""
        group, w = self.group[DATA], self.size[DATA]
        out = {}
        t0 = time.perf_counter()
        for partial in (False, True):
            idx = [i for i in grads if self.partial[i] == partial]
            for run in _buckets(idx, lambda i: grads[i].numel() * 4):
                # each gradient as its W parts along its dim, flattened:
                # (W, n_i) side by side -> (W, sum n_i)
                cols = [torch.stack([p.reshape(-1) for p in grads[i].to(
                    torch.float32).chunk(w, dim=self.specs[i].dim)])
                    for i in run]
                buf = torch.cat(cols, dim=1)
                if partial:
                    mesh.all_reduce_(buf, group=self.group[INDEX])
                mine = buf.new_empty(buf.shape[1])
                _sync(buf)
                mesh.reduce_scatter_(mine, buf.reshape(-1), group)
                mine.div_(w)
                off = 0
                for i, c in zip(run, cols):
                    n = c.shape[1]
                    shape = list(self.full_shapes[i])
                    shape[self.specs[i].dim] //= w
                    out[i] = mine[off:off + n].view(shape).to(grads[i].dtype)
                    off += n
        if grads:
            _sync(next(iter(out.values())))
        self.seconds["reduce_scatter"] += time.perf_counter() - t0
        return out

    def resident_bytes(self) -> int:
        """Bytes the leaves hold on this rank now."""
        return sum(t.numel() * t.element_size() for t in self.leaves)


def place(paths: list, leaves: list, specs: list, grid,
          partial: list | None = None) -> Placement:
    """Each rank narrows its leaves (equal on every rank) to its shards
    (``apply_specs``): the placed tree's leaves own their storage."""
    p = Placement(paths, leaves, specs, grid, partial)
    p.dealias_()
    p.shard_()
    return p
