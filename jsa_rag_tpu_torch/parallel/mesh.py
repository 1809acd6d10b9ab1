"""Processes and the (data, index) grid (counterpart of
``jsa_rag_tpu/parallel/mesh.py``).

The JAX package places its devices on a 2-D mesh: ``data`` shards the
batches (params replicated, the DDP placement), and the index shards its
rows over every device, both axes flattened. The port runs one process per
device under ``torchrun`` (``python -m torch.distributed.run``), so the JAX
device count becomes the world size and a process's rank its place on the
grid: rank ``r`` sits at ``divmod(r, n_index)``, the row-major reshape of
``make_mesh``.

``init_processes`` is the counterpart of ``multihost_init``: without
``WORLD_SIZE`` in the environment it does nothing, and every function here
answers "process 0 of 1"; under ``torchrun`` it joins the process group from
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. The collective helpers below are what the rest of the port
calls across processes; each is the identity (or a local answer) in a
single process. Every rank must call each of them together, in the same
order: a rank that skips one leaves the others waiting.

Transport: NCCL refuses two ranks on one card, so ranks that share one
join over gloo; gloo takes the CUDA tensors of every collective used here
(all_reduce, broadcast, all_gather, barrier; checked on the card with torch
2.11) and carries them through host memory itself. Scalars and host-side
values travel as host tensors under gloo and as card tensors under NCCL
(``comm_device``).

Axis groups (``axis_groups``): the ranks that share an index coordinate
form a *data group* (they hold the same FSDP or tensor-parallel shard and
average its gradient), the ranks that share a data coordinate an *index
group* (they split one generator under tensor parallelism). Every rank
creates every group, in the same order, at its first call; each helper
takes an optional ``group`` (None: every rank).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings

import torch
import torch.distributed as dist

from ..device import resolve_device

@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place on the (data, index) grid of ``n_data x
    n_index`` processes."""

    n_data: int
    n_index: int
    rank: int = 0

    @property
    def world(self) -> int:
        return self.n_data * self.n_index

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_index

    @property
    def index_rank(self) -> int:
        return self.rank % self.n_index


def make_grid(n_data: int = 1, n_index: int | None = None,
              world: int | None = None, rank: int | None = None) -> Grid:
    """The grid ``make_mesh`` would build over ``world`` devices (default:
    the process count), with its checks and messages. ``n_index`` defaults
    to ``world // n_data``; the product must equal the world size."""
    n = process_count() if world is None else world
    if n_index is None:
        if n % n_data != 0:
            raise ValueError(f"n_data={n_data} does not divide device count {n}")
        n_index = n // n_data
    if n_data * n_index != n:
        raise ValueError(
            f"mesh shape ({n_data}, {n_index}) != device count {n}"
        )
    return Grid(n_data, n_index, process_index() if rank is None else rank)


def training_grid(opt) -> Grid:
    """The training entry point's grid (``train.py:54-65``): under several
    processes ``--mesh_data 1`` becomes the process count (every rank a
    data-parallel worker, the reference's DDP); another value must be a
    multiple of it; then ``make_grid`` with ``--mesh_index``. Under
    ``--tensor_parallel`` with ``--mesh_index`` above 1 the index axis
    spans processes (one device each here, where a JAX process holds
    several): the grid is ``--mesh_data`` x ``--mesh_index`` as given."""
    n_data, pc = opt.mesh_data, process_count()
    if opt.tensor_parallel and opt.mesh_index > 1:
        return make_grid(n_data, opt.mesh_index)
    if pc > 1 and n_data % pc != 0:
        if n_data != 1:
            raise ValueError(f"--mesh_data {n_data} must be a multiple of "
                             f"the process count {pc}")
        n_data = pc
    return make_grid(n_data, opt.mesh_index or None)


def evaluation_grid(opt) -> Grid:
    """The evaluation entry point's grid (``evaluate.py:34``)."""
    return make_grid(opt.mesh_data, opt.mesh_index or None)


def init_processes(device="cuda", backend: str | None = None,
                   timeout_s: float | None = None) -> torch.device:
    """Join the ``torchrun`` process group and return this process's
    device. Without ``WORLD_SIZE`` in the environment: no group, the device
    resolved as given. ``device="cuda"`` means ``cuda:{LOCAL_RANK}`` and
    raises where that card does not exist; an explicit index (``cuda:0``)
    is honoured as given. ``backend`` defaults to ``nccl`` for CUDA and
    ``gloo`` for the CPU; ranks that share one card name ``gloo``. A group
    already joined is kept (the call is idempotent); a failed join
    raises."""
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return dev
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if dev.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} asks for cuda:{local}, but this "
                    f"machine has {torch.cuda.device_count()} CUDA "
                    "device(s)")
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    addr = os.environ["MASTER_ADDR"]
    port = os.environ["MASTER_PORT"]
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        _GROUP_KW["timeout"] = kw["timeout"]
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kw)
    return dev


def shutdown_processes() -> None:
    """Leave the process group (a no-op without one)."""
    _GROUPS.clear()
    _GROUP_KW.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


_GROUPS: dict = {}    # (n_data, n_index) -> this rank's (data, index) group
_GROUP_KW: dict = {}  # the group's timeout, for the subgroups too


def axis_groups(grid: Grid) -> tuple:
    """This rank's (data group, index group) on ``grid``: the ranks
    ``{d * n_index + index_rank}`` over d, and ``{data_rank * n_index +
    j}`` over j, whose group ranks are then ``data_rank`` and
    ``index_rank``. Collective at the first call for a grid shape (every
    rank creates every group, in the same order); (None, None) without a
    process group."""
    if not distributed():
        return None, None
    key = (grid.n_data, grid.n_index)
    if key not in _GROUPS:
        if grid.world != process_count():
            raise ValueError(f"grid of {grid.world} ranks in a group of "
                             f"{process_count()}")
        nd, ni = key
        data = [dist.new_group([d * ni + j for d in range(nd)], **_GROUP_KW)
                for j in range(ni)]
        index = [dist.new_group([i * ni + j for j in range(ni)],
                                **_GROUP_KW) for i in range(nd)]
        _GROUPS[key] = (data[grid.index_rank], index[grid.data_rank])
    return _GROUPS[key]


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: every rank); 1 without a process group."""
    return dist.get_world_size(group) if distributed() else 1


def distributed() -> bool:
    """Whether this process is in a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if distributed() else 1


def comm_device() -> torch.device:
    """Where a collective's own buffers live: the host under gloo, this
    process's card under NCCL."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast of global rank ``src``'s ``t`` over ``group``;
    returns ``t``."""
    if group_size(group) > 1:
        dist.broadcast(t, src=src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (same shape on all) stacked in group-rank
    order: (W, *t.shape)."""
    w = group_size(group)
    if w == 1:
        return t[None]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(w)]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts)


def reduce_scatter_(out: torch.Tensor, t: torch.Tensor,
                    group=None) -> torch.Tensor:
    """``out`` := group rank r's part of the sum over ``group`` of ``t``
    (W * out.numel() elements, r's part the r-th run of out.numel());
    returns ``out``."""
    if group_size(group) == 1:
        return out.copy_(t.reshape(out.shape))
    with warnings.catch_warnings():  # renamed in later torch releases
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def exchange_rows(t: torch.Tensor, dest_counts: list, group=None
                  ) -> torch.Tensor:
    """Send the rows of ``t`` in order, the first ``dest_counts[0]`` to
    group rank 0, the next ``dest_counts[1]`` to rank 1, ...; -> the rows
    every rank sent here, source after source, on ``t``'s device. Any
    dtype: each row travels as its bytes (through host memory under
    gloo)."""
    w = group_size(group)
    if w == 1:
        return t
    dev = comm_device()
    counts = all_gather(torch.tensor(list(dest_counts), dtype=torch.int64,
                                     device=dev), group).cpu()
    me = dist.get_rank(group)
    recv = counts[:, me].tolist()
    rows = t.reshape(t.shape[0], -1)
    raw = rows.contiguous().view(torch.uint8).to(dev)
    out = raw.new_empty((sum(recv), raw.shape[1]))
    dist.all_to_all_single(out, raw, recv, list(dest_counts), group=group)
    return out.to(t.device).view(t.dtype).reshape(-1, *t.shape[1:])


def gather_to_root(t: torch.Tensor, root: int = 0):
    """Every rank's ``t`` (same shape on all) stacked on rank ``root``
    (W, *t.shape), through the collectives' device as bytes; None
    elsewhere."""
    if not distributed():
        return t[None]
    x = t.contiguous().reshape(max(t.shape[0], 1) if t.dim() else 1, -1)
    raw = x.view(torch.uint8).to(comm_device())  # any dtype, as bytes
    parts = ([torch.empty_like(raw) for _ in range(process_count())]
             if process_index() == root else None)
    dist.gather(raw, parts, dst=root)
    if parts is None:
        return None
    return torch.stack(parts).to(t.device).view(t.dtype).reshape(
        process_count(), *t.shape)


def all_gather_ragged(t: torch.Tensor):
    """Gather ranks' ``t`` whose first dims differ: each is padded with
    zeros to the global maximum (the JAX package's
    ``gather_queries_across_processes``, ``index/flat.py:63-80``). ->
    ((W, b_max, *rest) tensor on ``t``'s device, [b_0, ..., b_{W-1}])."""
    counts = all_gather(torch.tensor(
        [t.shape[0]], dtype=torch.int64,
        device=comm_device() if distributed() else t.device))
    counts = [int(c) for c in counts.reshape(-1).tolist()]
    b_max = max(counts)
    if t.shape[0] < b_max:
        pad = t.new_zeros((b_max - t.shape[0], *t.shape[1:]))
        t = torch.cat([t, pad])
    return all_gather(t), counts


def all_max(value):
    """The largest of every rank's ``value`` (an int or a float)."""
    if not distributed():
        return value
    t = torch.tensor([value], dtype=torch.float64, device=comm_device())
    out = all_reduce_(t, dist.ReduceOp.MAX).item()
    return type(value)(out)


def any_rank(flag: bool) -> bool:
    """True where any rank's ``flag`` is."""
    return bool(all_max(int(bool(flag))))


def all_sum(values) -> list[float]:
    """Elementwise sum over ranks of a list of floats, in float64."""
    if not distributed():
        return [float(v) for v in values]
    t = torch.tensor(list(values), dtype=torch.float64, device=comm_device())
    return all_reduce_(t).cpu().tolist()


def barrier() -> None:
    """Wait until every rank arrives (a no-op in a single process)."""
    if distributed():
        dist.barrier()
