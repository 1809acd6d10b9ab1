"""The training step (counterpart of ``jsa_rag_tpu/train/step.py``): loss,
backward, the data-parallel gradient all-reduce, clip, AdamW update.

Placement is DDP, the JAX package's default (``step.py:49-75``): every rank
holds the whole param tree and optimizer state, and takes
``per_gpu_batch_size`` rows of the global batch of ``per_gpu_batch_size x
n_data`` (``host_batch_rows``). Each rank's loss is the mean over its own
rows, and every mode's loss is a per-example mean, so the mean of the ranks'
gradients is the gradient of the global batch's mean loss, as the JAX step's
one program over the global batch computes it (``step.py:141-175``); that
holds while every rank holds the same number of rows, which the loop
asserts. The all-reduce (``GradReducer``) runs between the backward and the
optimizer, so the clip norm and AdamW see the global-batch gradients and
every replica takes the same update. ``--shard_optim`` (FSDP) over a data
axis above 1 and ``--tensor_parallel`` over an index axis above 1 are
ROADMAP queue A item 13b; where the axis has size 1 they are no-ops, as in
the JAX package.
"""

from __future__ import annotations

import logging
import time

import torch
import torch.distributed as dist

from ..config import Options
from ..parallel import mesh
from .modes import MODE_LOSSES
from .optim import AdamW

logger = logging.getLogger(__name__)

BUCKET_BYTES = 256 << 20  # float32 bytes a gradient bucket holds


def param_placement(opt: Options, grid: mesh.Grid) -> str:
    """The params' placement on ``grid`` (``step.py::param_specs``): DDP
    ("replicated"). FSDP and tensor parallelism where their axis exceeds 1
    are not ported yet and raise."""
    if opt.shard_optim and grid.n_data > 1:
        raise NotImplementedError(
            f"--shard_optim over a data axis of {grid.n_data} (FSDP: params "
            "and optimizer state sharded) is ROADMAP queue A item 13b; the "
            "port places params replicated (DDP)")
    if opt.tensor_parallel and grid.n_index > 1:
        raise NotImplementedError(
            f"--tensor_parallel over an index axis of {grid.n_index} is "
            "ROADMAP queue A item 13b; the port places params replicated "
            "(DDP)")
    return "replicated"


def host_batch_rows(opt: Options, grid: mesh.Grid | None = None) -> int:
    """Examples this rank's data iterator draws per step
    (``step.py:90-110``): ``per_gpu_batch_size``, of the data shard of its
    data coordinate. The global batch is ``per_gpu_batch_size x n_data``;
    ranks that share a data coordinate (``n_index > 1``) draw the same rows,
    as the JAX mesh replicates a batch over ``index``."""
    return opt.per_gpu_batch_size


def _buckets(tensors: list, cap: int = BUCKET_BYTES // 4) -> list:
    """Consecutive runs of ``tensors`` of at most ``cap`` elements each (a
    larger tensor stands alone)."""
    out, run, size = [], [], 0
    for t in tensors:
        if run and size + t.numel() > cap:
            out.append(run)
            run, size = [], 0
        run.append(t)
        size += t.numel()
    if run:
        out.append(run)
    return out


def _bucketed(tensors: list, collective) -> int:
    """Apply ``collective`` (in place, to a flat float32 buffer) over
    ``tensors`` a bucket at a time: the tensors are widened into the buffer
    (bf16 exactly), the collective runs once a bucket, and the results are
    copied back (rounded once to each tensor's dtype). -> buckets used."""
    if not tensors:
        return 0
    buckets = _buckets(tensors)
    dev = tensors[0].device
    buf = torch.empty(max(sum(t.numel() for t in b) for b in buckets),
                      dtype=torch.float32, device=dev)
    for run in buckets:
        n = sum(t.numel() for t in run)
        torch.cat([t.reshape(-1).to(torch.float32) for t in run],
                  out=buf[:n])
        collective(buf[:n])
        parts = torch.split(buf[:n], [t.numel() for t in run])
        torch._foreach_copy_(run, [p.view(t.shape) for p, t in
                                   zip(parts, run)])
    return len(buckets)


def _checksum(tensors: list) -> torch.Tensor:
    """Per-tensor float64 sums, on the collectives' device."""
    return torch.stack([t.detach().to(torch.float64).sum()
                        for t in tensors]).to(mesh.comm_device())


def sync_params(leaves: list) -> None:
    """Every rank starts from rank 0's params: a bucketed broadcast of
    every leaf, then one check that the ranks' per-leaf sums agree (a
    collective; a no-op without a process group)."""
    if not mesh.distributed():
        return
    with torch.no_grad():
        _bucketed(list(leaves), lambda b: mesh.broadcast_(b, 0))
    sums = mesh.all_gather(_checksum(leaves))
    if not bool((sums == sums[0]).all()):
        raise RuntimeError("params differ between ranks after the "
                           "broadcast from rank 0")


class GradReducer:
    """The DDP gradient all-reduce: the gradients that exist are flattened
    into float32 buckets of ``BUCKET_BYTES`` and each bucket is summed over
    the ranks by one ``all_reduce`` and divided by the world size (the
    mean; gloo has no AVG). bf16 gradients (``--param_dtype bfloat16``)
    are widened to float32 for the reduction and rounded back once. The
    ranks must agree on which gradients exist (the same graph on every
    rank): checked at the first call. ``buckets`` counts the last call's
    buckets; a call returns its span, whose ``span_ms`` is its time (CUDA
    events on the card, read when asked; the host clock on the CPU)."""

    def __init__(self):
        self.world = mesh.process_count()
        self.checked = False
        self.buckets = 0
        self.last_span = None

    def __call__(self, grads: list):
        present = [g for g in grads if g is not None]
        if not self.checked:
            pattern = torch.tensor([float(g is not None) for g in grads]
                                   + [float(len(grads))],
                                   dtype=torch.float64,
                                   device=mesh.comm_device())
            seen = mesh.all_gather(pattern)
            if not bool((seen == seen[0]).all()):
                raise RuntimeError("ranks differ in which leaves take a "
                                   "gradient: the data-parallel step needs "
                                   "the same graph on every rank")
            self.checked = True
        world = self.world

        def mean(buf):
            mesh.all_reduce_(buf, dist.ReduceOp.SUM)
            if world > 1:
                buf.div_(world)

        cuda = bool(present) and present[0].device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        with torch.no_grad():
            self.buckets = _bucketed(present, mean)
        if cuda:
            stop.record()
        else:
            stop = time.perf_counter()
        self.last_span = (start, stop)
        return self.last_span


def span_ms(span) -> float:
    """Milliseconds of a ``GradReducer`` call's span (waits for its CUDA
    events)."""
    if span is None:
        return 0.0
    start, stop = span
    if isinstance(start, float):
        return (stop - start) * 1e3
    stop.synchronize()
    return start.elapsed_time(stop)


def average_over_ranks(loss: torch.Tensor, aux: dict):
    """The loss and the scalar aux stats averaged over the ranks (the JAX
    program's replicated aux, ``step.py:170-172``): one all-reduce of their
    stack. Per-row ``debug/`` arrays stay the rank's own."""
    keys = [k for k, v in aux.items()
            if not k.startswith("debug/") and torch.as_tensor(v).numel() == 1]
    dev = loss.device
    vals = torch.stack([loss.reshape(())]
                       + [torch.as_tensor(aux[k], device=dev).to(
                           loss.dtype).reshape(()) for k in keys])
    mesh.all_reduce_(vals, dist.ReduceOp.SUM)
    vals = vals / mesh.process_count()
    out = dict(aux)
    for k, v in zip(keys, vals[1:]):
        out[k] = v.to(torch.as_tensor(aux[k]).dtype)
    return vals[0], out


def make_train_step(model, mode: str, tx: AdamW):
    """-> train_step(params, batch, rng) -> (loss, aux): the mode loss, its
    gradients for every leaf that takes one (``torch.autograd.grad``; the
    gradients of frozen leaves are computed too, since they count in the
    clip norm), in a process group their mean over the ranks
    (``GradReducer``, kept as ``train_step.reducer``), and the optimizer
    update, which changes ``params`` in place. The loss and the aux (in a
    process group, their means over the ranks) stay on the device."""
    if mode not in MODE_LOSSES:
        raise ValueError(
            f"unknown training mode {mode!r}; expected one of "
            f"{sorted(MODE_LOSSES)} (gold_score_mode / gen_method)")
    value_and_grad = model.loss_and_grad_fn(mode)
    where = [i for i, t in enumerate(tx.leaves) if t.requires_grad]
    train_leaves = [tx.leaves[i] for i in where]
    reducer = GradReducer() if mesh.distributed() else None

    def train_step(params, batch, rng):
        (loss, aux), grads = value_and_grad(params, batch, rng, train_leaves)
        full = [None] * len(tx.leaves)
        for i, g in zip(where, grads):
            full[i] = g
        del grads
        if reducer is not None:
            reducer(full)
            loss, aux = average_over_ranks(loss, aux)
        tx.step(full)
        return loss, aux

    train_step.reducer = reducer
    return train_step
