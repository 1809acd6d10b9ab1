"""The training loop (counterpart of ``jsa_rag_tpu/train/loop.py``;
reference: train.py:113-377): the initial index build, the refresh
schedule, the optimizer steps, periodic eval/save/retriever export, stats
and logging.

Over several processes (``parallel/mesh.py``) every rank runs this loop in
step: rank 0's params are broadcast first, each rank draws its data
coordinate's shard of the data with its own shuffle seed
(``loop.py:150-162``), the step averages the gradients over the ranks, and
rank 0 alone writes the metrics log, the step dumps and the checkpoints
(``loop.py:66-70, 272, 362``). A SIGTERM or SIGUSR1 that reaches any rank
stops every rank: an any-rank OR every step (``loop.py:337-345``).

As in the JAX package, the step's loss and aux stay on the device and are
drained to the host every 32 steps, at a log boundary, or when a
``training_info_step{N}.json`` dump (``--log_detail_num``) needs them, so
the host builds the next batch while the device runs the step. SIGTERM and
SIGUSR1 end the run after the current step with a checkpoint.

``--incremental_refresh_batches N`` replaces each scheduled rebuild after
step 1 by a double-buffered sweep (``index/refresh.py``), N embed batches a
step, swapped in when it completes. ``--pipeline_retrieval`` retrieves the
next batch's candidates with the pre-step params before the step; a
prefetch made against rows that a rebuild or swap has since replaced is
dropped and retrieved again (``index_version``).

A run that starts at a restored step skips the batches the steps before it
took (the same per-epoch shuffles), so a resume sees the data an
uninterrupted run would; with ``--save_optimizer`` every checkpoint holds
the optimizer's state (``AdamW.state_dict``). Both are deliberate
differences from the JAX package, whose resume replays the data from the
first batch with a fresh optimizer. The step's random generators restart
from ``--seed``.

``--profile_steps a-b`` runs ``torch.profiler`` (CPU, and CUDA on the card)
from the start of step a to the start of step b, as the JAX package brackets
``jax.profiler`` (``loop.py:174-180``), and writes a Chrome trace under
``<checkpoint>/profile``; inside the span ``record_function`` marks
``retrieve+tokenize``, ``prefetch_retrieve`` and each step's ``train``.
Without the flag nothing is profiled or marked.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import time

import torch

from ..config import Options
from ..index.refresh import IncrementalIndexRefresher
from ..parallel import mesh
from ..tasks import get_task
from ..utils.schedulers import IndexRefreshScheduler
from ..utils.stats import WeightedAvgStats
from .checkpoint import (export_retriever, save_checkpoint,
                         wait_for_local_writes, wait_for_writes)
from .modes import StepRng
from .optim import AdamW
from .step import (host_batch_rows, make_train_step, param_placement,
                   span_ms, sync_params)

logger = logging.getLogger(__name__)

DRAIN_EVERY = 32  # device scalars kept before a forced host sync


def train_mode_of(opt: Options) -> str:
    return "concat" if opt.gen_method == "concat" else opt.gold_score_mode


class StepProfiler:
    """``torch.profiler`` over steps [a, b) of ``--profile_steps a-b``:
    ``at_step`` starts it at step a and stops it, writing the trace, at
    step b; ``span(name)`` is a ``record_function`` while it runs and a
    no-op otherwise."""

    def __init__(self, profile_steps: str, out_dir: str,
                 device: torch.device):
        self.range = (tuple(int(x) for x in profile_steps.split("-"))
                      if profile_steps else None)
        self.out_dir = out_dir
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None

    def at_step(self, step: int) -> None:
        if self.range is None:
            return
        if step == self.range[0]:
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.start()
        elif step == self.range[1]:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        a, b = self.range
        path = os.path.join(self.out_dir, f"steps_{a}-{b}.pt.trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        logger.info("profiler trace written to %s", path)

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def train(model, index, params: dict, tx: AdamW, opt: Options,
          step: int = 0, evaluate_fn=None,
          checkpoint_path: str | None = None, grid: mesh.Grid | None = None):
    """Run the training loop; returns the final step. ``params`` is updated
    in place. ``grid``: the processes' grid (None: ``training_grid``)."""
    grid = grid or mesh.training_grid(opt)
    param_placement(opt, grid)
    rank0 = grid.rank == 0
    run_stats = WeightedAvgStats()
    checkpoint_path = checkpoint_path or os.path.join(opt.checkpoint_dir,
                                                      opt.name)
    os.makedirs(checkpoint_path, exist_ok=True)
    # rank 0 alone appends: N writers would interleave every record
    metrics_log = (open(os.path.join(checkpoint_path, "metrics.jsonl"), "a")
                   if rank0 else None)
    profiler = StepProfiler(opt.profile_steps,
                            os.path.join(checkpoint_path, "profile"),
                            model.device)
    completed = False
    try:
        sync_params(tx.leaves)
        mode = train_mode_of(opt)
        first_step = step + 1
        uses_index = not opt.use_file_passages and not opt.closed_book
        if uses_index and opt.load_index_path is None:
            t0 = time.time()
            model.build_index(index, params)
            logger.info("Initial indexing time: %.3f min",
                        (time.time() - t0) / 60)

        task = get_task(opt, model.generator_tokenizer)
        refresh = IndexRefreshScheduler(opt.refresh_index,
                                        opt.freeze_retriever_steps,
                                        opt.train_retriever)
        refresher = None
        if opt.incremental_refresh_batches > 0:
            refresher = IncrementalIndexRefresher(
                model, index, batches_per_step=opt.incremental_refresh_batches)
        train_step = make_train_step(model, mode, tx)
        reducer = train_step.reducer  # None without a process group
        batch_rows = host_batch_rows(opt, grid)

        stop_requested = {"flag": False}

        def _on_term(signum, frame):
            stop_requested["flag"] = True

        try:
            signal.signal(signal.SIGTERM, _on_term)
            signal.signal(signal.SIGUSR1, _on_term)
        except ValueError:
            pass  # not the main thread (e.g. tests)

        # one Philox stream per data coordinate (JAX splits one global key
        # per row): ranks with different rows draw differently
        rng = StepRng.from_seed(opt.seed + 7_919 * grid.data_rank,
                                model.device)
        epoch = 0
        # bumped on every rebuild and swap: a prefetched retrieval is valid
        # only against the rows it searched
        index_version = 0
        # (iter_stats, loss, aux, weight, all-reduce span), on the device
        pending: list = []
        last_loss = float("nan")
        to_skip = step  # batches the restored steps already took

        def opt_state():
            # only rank 0 writes, so only it copies the moments
            return tx.state_dict() if opt.save_optimizer and rank0 else None

        def drain_pending() -> float:
            nonlocal last_loss
            for istats, ldev, adev, w, span in pending:
                last_loss = float(ldev)
                istats["loss/train_loss"] = (last_loss, w)
                if span is not None:
                    istats["parallel/allreduce_ms"] = (span_ms(span), 1)
                    istats["parallel/allreduce_buckets"] = (
                        float(reducer.buckets), 1)
                for k, v in adev.items():
                    if not k.startswith("debug/"):
                        istats[k] = (float(v), w)
                run_stats.update(istats)
            pending.clear()
            return last_loss

        while step < opt.total_steps:
            epoch += 1
            data_iterator = task.data_iterator(
                opt.train_data, grid.data_rank, grid.n_data,
                repeat_if_less_than_world_size=True, opt=opt)
            data_iterator = filter(None, map(task.process, data_iterator))
            # per-(seed, epoch, rank) shuffle seed (loop.py:155-162)
            batches = task.batch_iterator(
                data_iterator, batch_rows, drop_last=True, shuffle=True,
                shuffle_buffer_size=opt.shuffle_buffer_size,
                shuffle_seed=(opt.seed * 1_000_003 + epoch * 9_973
                              + grid.data_rank))
            batches_it = iter(batches)
            while to_skip > 0 and next(batches_it, None) is not None:
                to_skip -= 1
            batch = next(batches_it, None)
            prefetched = None  # (retrieval ctx of `batch`, index_version)
            while batch is not None:
                iter_stats: dict = {}
                step += 1
                t_step = time.time()
                profiler.at_step(step)
                if uses_index and refresh.is_time_to_refresh(step):
                    # a just-loaded index already holds these weights' rows
                    if not (step == first_step
                            and opt.load_index_path is not None):
                        t0 = time.time()
                        if refresher is not None and step > 1:
                            # the sweep runs inside the following steps
                            if not refresher.active:
                                refresher.start()
                        else:
                            model.build_index(index, params, iter_stats)
                            index_version += 1
                        iter_stats["runtime/indexing"] = (time.time() - t0,
                                                          1)
                if refresher is not None and refresher.active:
                    t0 = time.time()
                    if refresher.step(params):
                        index_version += 1
                        iter_stats["index/refresh_swapped"] = (1.0, 1)
                    iter_stats["runtime/incremental_refresh"] = (
                        time.time() - t0, 1)
                queries, targets = batch["query"], batch["target"]
                if len(queries) != batch_rows:
                    # the mean over ranks is the global batch's mean only
                    # when every rank holds the same number of rows
                    raise RuntimeError(
                        f"a batch of {len(queries)} rows, not {batch_rows}")
                filt = getattr(task, "filter", None)
                filt = filt if callable(filt) else None
                retrieval = (prefetched[0] if prefetched is not None
                             and prefetched[1] == index_version else None)
                t0 = time.time()
                with profiler.span("retrieve+tokenize"):
                    train_batch = model.build_batch(
                        mode, index, params, queries, targets, iter_stats,
                        file_passages=batch.get("passages"),
                        batch_metadata=batch.get("metadata"),
                        filtering_fun=filt, retrieval=retrieval)
                iter_stats["runtime/retrieve+tokenize"] = (time.time() - t0,
                                                           1)
                next_batch = next(batches_it, None)
                prefetched = None
                # the prefetch searches collectively: every rank takes it or
                # none does (a rank's epoch may end a batch before another's)
                if (opt.pipeline_retrieval and step < opt.total_steps
                        and not mesh.any_rank(next_batch is None)):
                    # the next batch's candidates from the pre-step params
                    t0 = time.time()
                    with profiler.span("prefetch_retrieve"):
                        prefetched = (model.retrieval_ctx(
                            mode, index, params, next_batch["query"],
                            next_batch["target"], iter_stats,
                            file_passages=next_batch.get("passages"),
                            batch_metadata=next_batch.get("metadata"),
                            filtering_fun=filt), index_version)
                    iter_stats["runtime/prefetch_retrieve"] = (
                        time.time() - t0, 1)

                t0 = time.time()
                with profiler.span("train"):
                    loss, aux = train_step(params, train_batch, rng)
                # host time to enqueue the step; the device finishes later
                iter_stats["runtime/fwdbwd+update"] = (time.time() - t0, 1)
                iter_stats["runtime/train_step"] = (time.time() - t_step, 1)
                pending.append((iter_stats, loss, aux, len(queries),
                                reducer and reducer.last_span))
                if len(pending) >= DRAIN_EVERY:
                    drain_pending()

                if step <= opt.log_detail_num:
                    # training_info_step{N}.json (reference: train.py:228)
                    loss_v = drain_pending()
                    info = dict(getattr(model, "last_info", {}))
                    info.update({k: v.tolist() for k, v in aux.items()
                                 if k.startswith("debug/")})
                    info["loss"] = loss_v
                    if rank0:
                        with open(os.path.join(
                                checkpoint_path,
                                f"training_info_step{step}.json"), "w") as f:
                            json.dump(info, f, indent=1)

                if step % opt.log_freq == 0:
                    loss_v = drain_pending()
                    avg = run_stats.average_stats
                    log = f"EPOCH:{epoch} | {step}/{opt.total_steps}"
                    log += f" | train_loss:{loss_v:.4f}"
                    if "loss/generator_loss" in avg:
                        log += f" | gen_loss:{avg['loss/generator_loss']:.4f}"
                    if "accept_rate" in avg:
                        log += f" | accept_rate:{avg['accept_rate']:.3f}"
                    logger.info(log)
                    _write_metrics(metrics_log, step, avg)
                    run_stats.reset()

                if evaluate_fn is not None and step % opt.eval_freq == 0:
                    for data_path in opt.eval_data:
                        metrics = evaluate_fn(model, index, params, opt,
                                              data_path, step)
                        logger.info("Dataset: %s | %s",
                                    os.path.basename(data_path), " | ".join(
                                        f"{v:.3f} {k}"
                                        for k, v in metrics.items()))

                if (opt.save_build_retriever_step
                        and step % opt.save_build_retriever_step == 0
                        and step % opt.save_freq != 0):
                    export_retriever(checkpoint_path, step,
                                     params["retriever"],
                                     tokenizer=model.retriever_tokenizer,
                                     block=False)
                if step % opt.save_freq == 0:
                    export_retriever(checkpoint_path, step,
                                     params["retriever"],
                                     tokenizer=model.retriever_tokenizer,
                                     block=False)
                    save_checkpoint(opt.checkpoint_dir, opt.name, step,
                                    params, opt_state=opt_state(),
                                    options=opt,
                                    tokenizer=model.generator_tokenizer,
                                    retriever_tokenizer=model
                                    .retriever_tokenizer, block=False)

                stop_now = stop_requested["flag"]
                if grid.world > 1:
                    # the signal may reach one rank: stop every rank
                    stop_now = mesh.any_rank(stop_now)
                if stop_now:
                    drain_pending()
                    _flush_metrics(metrics_log, step, run_stats)
                    if step % opt.save_freq != 0:
                        save_checkpoint(
                            opt.checkpoint_dir, opt.name, step, params,
                            opt_state=opt_state(), options=opt,
                            tokenizer=model.generator_tokenizer,
                            retriever_tokenizer=model.retriever_tokenizer)
                    logger.info("preemption checkpoint saved at step %d",
                                step)
                    completed = True
                    return step

                if step >= opt.total_steps:
                    break
                batch = next_batch
        drain_pending()
        _flush_metrics(metrics_log, step, run_stats)
        completed = True
        return step
    finally:
        profiler.stop()  # a span past the last step ends with the run
        if metrics_log is not None:
            metrics_log.close()
        if completed:
            wait_for_writes()
        else:  # a failing rank does not wait at the others' barrier
            wait_for_local_writes()


def _write_metrics(metrics_log, step: int, avg: dict) -> None:
    """One stats window -> a metrics.jsonl line (rank 0; the averages
    themselves are a collective every rank takes part in)."""
    if metrics_log is not None and avg:
        metrics_log.write(json.dumps(
            {"step": step, **{k: float(v) for k, v in avg.items()}}) + "\n")
        metrics_log.flush()


def _flush_metrics(metrics_log, step: int, run_stats) -> None:
    """Write a partial stats window before returning."""
    _write_metrics(metrics_log, step, run_stats.average_stats)
    run_stats.reset()

