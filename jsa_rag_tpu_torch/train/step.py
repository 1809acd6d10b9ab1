"""The training step (counterpart of ``jsa_rag_tpu/train/step.py``): loss,
backward, the gradient reductions, clip, AdamW update.

Placement (``param_specs``, ``step.py:49-75``): by default DDP, every rank
holding the whole param tree and optimizer state; ``--shard_optim`` over a
data axis above 1 splits every leaf over the data group (FSDP: params, mu
and nu divided by the data degree), the generator too unless it is
tensor-parallel; ``--tensor_parallel`` over an index axis above 1 splits
the generator Megatron-style over the index group (``models/lm.py``). Each
flag is a no-op where its axis has size 1, as in the JAX package.
``place_params`` carries the specs out (``parallel/sharding.Placement``).

Each rank takes ``per_gpu_batch_size`` rows of the global batch of
``per_gpu_batch_size x n_data`` (``host_batch_rows``); ranks of one data
coordinate take the same rows. Each rank's loss is the mean over its own
rows, and every mode's loss is a per-example mean, so the mean of the data
coordinates' gradients is the gradient of the global batch's mean loss, as
the JAX step's one program over the global batch computes it
(``step.py:141-175``); that holds while every rank holds the same number of
rows, which the loop asserts. The reductions (``GradReducer``) run between
the backward and the optimizer, so the clip norm and AdamW see the
global-batch gradients.

FSDP's step: between steps each rank holds only its shards of the params,
mu and nu; the step gathers every FSDP leaf into a full tensor, runs the
forward and backward unchanged, reduce-scatters each FSDP gradient into the
rank's shard (the mean over the data group), frees the full tensors and
runs AdamW on the shards. The whole tree is gathered at once (its peak is
the full params beside the shards of mu and nu; gathering layer by layer
is a later optimisation).
"""

from __future__ import annotations

import dataclasses
import logging
import time

import torch
import torch.distributed as dist

from ..config import Options
from ..models.lm import with_tensor_parallel
from ..parallel import mesh, sharding
from ..parallel.sharding import DATA, INDEX
from ..utils import trace
from .modes import MODE_LOSSES
from .optim import AdamW, named_leaves

logger = logging.getLogger(__name__)

BUCKET_BYTES = 256 << 20  # float32 bytes a gradient bucket holds


def param_placement(opt: Options, grid: mesh.Grid) -> str:
    """The params' placement on ``grid``: "replicated" (DDP), "fsdp",
    "tensor_parallel" or "fsdp+tensor_parallel"; a flag whose axis has
    size 1 is a no-op."""
    kinds = [k for k, on in (("fsdp", opt.shard_optim and grid.n_data > 1),
                             ("tensor_parallel", opt.tensor_parallel
                              and grid.n_index > 1)) if on]
    return "+".join(kinds) or "replicated"


def _flat_specs(prefix: tuple, tree, out: dict) -> dict:
    """A spec tree's leaves by ``named_leaves`` path."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat_specs(prefix + (str(k),), v, out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _flat_specs(prefix + (str(i),), v, out)
    else:
        out[prefix] = tree
    return out


def param_specs(opt: Options, params: dict, grid: mesh.Grid,
                gen_cfg=None) -> dict:
    """{``named_leaves`` path: ``Split`` or None} per flags
    (``step.py::param_specs``): replicated by default; under
    ``--shard_optim`` every top-level key FSDP-split over ``data``, the
    generator too unless tensor-parallel; under ``--tensor_parallel`` the
    generator by ``lm_tp_specs`` over ``index`` (with ``gen_cfg``, its
    attention replicated where the heads do not divide:
    ``sharding.whole_heads``)."""
    tp = opt.tensor_parallel and grid.n_index > 1
    fsdp = opt.shard_optim and grid.n_data > 1
    leaves = named_leaves(params)
    out = {}
    for key, sub in params.items():
        mine = {p: t for p, t in leaves.items() if p[0] == key}
        if key == "generator" and tp:
            specs = sharding.lm_tp_specs(sub, grid.n_index)
            if gen_cfg is not None:
                specs = sharding.whole_heads(specs, gen_cfg, grid.n_index)
            out.update(_flat_specs((key,), specs, {}))
        elif fsdp:
            out.update({p: sharding.fsdp_specs(t, grid.n_data)
                        for p, t in mine.items()})
        else:
            out.update({p: None for p in mine})
    return out


def place_params(opt: Options, model, params: dict, grid: mesh.Grid):
    """Carry ``param_specs`` out in a process group: rank 0's values
    broadcast, every leaf narrowed to this rank's shard, and under tensor
    parallelism the model's generator config given its layout
    (``models/lm.py::with_tensor_parallel``). -> the ``Placement`` (None
    without a process group, where every flag is a no-op). Build the
    optimizer after it, so its moments live on the shards."""
    if not mesh.distributed():
        return None
    leaves = named_leaves(params)
    specs = param_specs(opt, params, grid, model.gen_cfg)
    paths = list(leaves)
    gen = {p[1:]: s for p, s in specs.items() if p[0] == "generator"}
    # a LoRA adapter of a split projection: its gradient is partial on
    # each rank of the index group
    partial = [p[0] == "lora" and gen.get(("layers",) + p[2:4]) is not None
               for p in paths]
    if any(s is not None and s.axis == INDEX for s in specs.values()):
        _, index_group = mesh.axis_groups(grid)
        gen_tree = sharding.whole_heads(sharding.lm_tp_specs(
            params["generator"], grid.n_index), model.gen_cfg, grid.n_index)
        tp = sharding.tensor_parallel_of(gen_tree, index_group,
                                         grid.n_index, grid.index_rank)
        model.gen_cfg = with_tensor_parallel(model.gen_cfg, tp)
        model.fns = dataclasses.replace(model.fns, gen_cfg=model.gen_cfg)
    sync_params([leaves[p] for p in paths])
    placement = sharding.place(paths, [leaves[p] for p in paths],
                               [specs[p] for p in paths], grid, partial)
    logger.info("placement %s: %d of %d leaves split, %.1f MiB of params "
                "on this rank", param_placement(opt, grid),
                sum(s is not None for s in specs.values()), len(specs),
                placement.resident_bytes() / 2 ** 20)
    return placement


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
    """The gradient reductions. Without a split (DDP) the gradients that
    exist are flattened into float32 buckets of ``BUCKET_BYTES`` and each
    bucket is summed over the ranks by one ``all_reduce`` and divided by
    the world size (the mean; gloo has no AVG). With a ``placement`` each
    leaf is reduced over its own group: a replicated leaf as above; a
    tensor-parallel leaf, the mean over its data group; a replicated leaf
    whose gradient is partial over the index group (a LoRA adapter of a
    split projection), the sum over the world divided by the data degree
    (the sum over the index group, then the mean over the data group); an
    FSDP leaf, reduce-scattered into this rank's shard
    (``Placement.reduce_scatter_mean``), which replaces it in the list.
    bf16 gradients (``--param_dtype bfloat16``) are widened to float32 for
    the reduction and rounded back once. The ranks must agree on which
    gradients exist (the same graph on every rank): checked at the first
    call. ``buckets`` counts the last call's buckets; a call returns its
    span, whose ``span_ms`` is its time (CUDA events on the card, read when
    asked; the host clock on the CPU)."""

    def __init__(self, placement=None):
        self.world = mesh.process_count()
        self.placement = placement
        self.checked = False
        self.buckets = 0
        self.last_span = None

    def _reduce(self, grads: list) -> int:
        """Reduce ``grads`` in place (FSDP entries replaced by shards);
        -> buckets used."""
        pl = self.placement
        live = [i for i, g in enumerate(grads) if g is not None]
        if pl is None or not (pl.split or any(pl.partial)):
            return _bucketed([grads[i] for i in live],
                             self._mean(None, self.world))
        n_data = pl.size[DATA]
        classes = {"world": [], "partial": [], INDEX: [], DATA: []}
        for i in live:
            s = pl.specs[i]
            if s is not None:
                classes[s.axis].append(i)
            else:
                classes["partial" if pl.partial[i] else "world"].append(i)
        n = 0
        for key, group, div in (("world", None, self.world),
                                ("partial", None, n_data),
                                (INDEX, pl.group[DATA], n_data)):
            n += _bucketed([grads[i] for i in classes[key]],
                           self._mean(group, div))
        if classes[DATA]:
            shards = pl.reduce_scatter_mean({i: grads[i]
                                             for i in classes[DATA]})
            for i, g in shards.items():
                grads[i] = g
            n += 1
        return n

    @staticmethod
    def _mean(group, div: int):
        def mean(buf):
            mesh.all_reduce_(buf, dist.ReduceOp.SUM, group=group)
            if div > 1:
                buf.div_(div)
        return mean

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
        cuda = bool(present) and present[0].device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            start = time.perf_counter()
        with torch.no_grad():
            self.buckets = self._reduce(grads)
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
    clip norm), in a process group their reductions (``GradReducer``, kept
    as ``train_step.reducer``), and the optimizer update, which changes
    ``params`` in place. Under FSDP (``tx.placement``) the FSDP leaves are
    gathered first (a no-op where the loop already gathered them) and
    narrowed again before the update. The loss and the aux (in a process
    group, their means over the ranks) stay on the device."""
    if mode not in MODE_LOSSES:
        raise ValueError(
            f"unknown training mode {mode!r}; expected one of "
            f"{sorted(MODE_LOSSES)} (gold_score_mode / gen_method)")
    value_and_grad = model.loss_and_grad_fn(mode)
    where = [i for i, t in enumerate(tx.leaves) if t.requires_grad]
    train_leaves = [tx.leaves[i] for i in where]
    placement = tx.placement
    reducer = GradReducer(placement) if mesh.distributed() else None

    def train_step(params, batch, rng):
        if placement is not None:
            placement.gather_((DATA,))
        (loss, aux), grads = value_and_grad(params, batch, rng, train_leaves)
        full = [None] * len(tx.leaves)
        for i, g in zip(where, grads):
            full[i] = g
        del grads
        if reducer is not None:
            with trace.span("step.reduce"):
                reducer(full)
                loss, aux = average_over_ranks(loss, aux)
        if placement is not None:
            placement.shard_((DATA,))
        with trace.span("step.update"):
            tx.step(full)
        return loss, aux

    train_step.reducer = reducer
    return train_step
