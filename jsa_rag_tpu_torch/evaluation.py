"""Evaluation harness (counterpart of ``jsa_rag_tpu/evaluation.py``;
reference: evaluate.py:30-386), one process.

Per batch: retrieve top-k -> rescore with the live towers -> substring-recall
bookkeeping -> eval loss (generator CE on the gold target) -> generation
(concat prompt, or fast-decode best-of-K; greedy or beam search), or for a
multiple-choice task the choice letters' logits -> task metrics.
``run_retrieval_only`` ports evaluate.py:60-102.

Over several processes each rank evaluates its shard of the data (the
data iterator deals example ``i`` to rank ``(i + 1) % W``); a rank with
fewer batches runs dummy ones (its
last batch, or a template) through the whole pipeline, recording nothing,
so every rank reaches each collective search and pad-length max together
(``_pad_batches_across_processes``); the metrics average over every rank's
examples and rank 0 writes the merged predictions file.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from .config import Options
from .data.prompts import build_generation_batch
from .tasks import get_task
from .models.lm import lm_logits
from .parallel import mesh
from .train.rag_model import RAGModel
from .utils import metrics as M
from .utils.stats import WeightedAvgStats

logger = logging.getLogger(__name__)


class _Laps:
    """``lap(name)`` adds the host-clock seconds since the last lap (or
    since construction) to ``s[name]``."""

    def __init__(self):
        self.s: dict[str, float] = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.s[name] = self.s.get(name, 0.0) + now - self._t
        self._t = now


def _answers_of(batch, i):
    if "answers" in batch and batch["answers"]:
        a = batch["answers"][i]
        return a if isinstance(a, list) else [a]
    return [batch["target"][i]]


def evaluate(model: RAGModel, index, params, opt: Options, data_path: str,
             step: int = 0, write_results: bool | None = None) -> dict:
    """Averaged task metrics over ``data_path``. Each batch's wall time
    (host clock around the whole batch) is logged at INFO, with the seconds
    in the record's ``batch_s`` attribute and its split in ``stage_s``:
    ``retrieve`` (query embed, search, passage lookup), ``rescore``,
    ``eval_loss``, ``generate`` (``choice_logits`` for a multiple-choice
    task) and ``score`` (detokenise, task metrics).
    Each stage ends in a host copy of its device results, so the host clock
    splits them with no added synchronise."""
    task = get_task(opt, model.generator_tokenizer)
    metrics: dict[str, list] = {k: [] for k in task.metrics}
    metrics["retrieval_recall"] = []
    dataset_wpred = []

    data_iterator = task.data_iterator(
        data_path, mesh.process_index(), mesh.process_count(),
        repeat_if_less_than_world_size=True, opt=opt, is_eval=True)
    data_iterator = filter(None, map(task.process, data_iterator))
    batches = task.batch_iterator(data_iterator, opt.per_gpu_batch_size)
    # static row count, as in the JAX package (whose jitted programs need
    # it): the ragged tail batch repeats its last example
    batches = (_pad_batch_rows(b, opt.per_gpu_batch_size) for b in batches)
    batches = _pad_batches_across_processes(
        batches, rows=opt.per_gpu_batch_size,
        extra_keys=("choices",) if hasattr(task, "choices") else ())
    task_filter = getattr(task, "filter", None)
    task_filter = task_filter if callable(task_filter) else None

    for n_batch, batch in enumerate(batches):
        t0 = time.perf_counter()
        lap = _Laps()
        queries, targets = batch["query"], batch["target"]
        # a dummy batch runs every stage (the collectives inside) and
        # records nothing
        n_real = 0 if batch.get("__dummy__") else int(
            batch.get("__size__", len(queries)))
        if opt.closed_book:
            passages = [[{"title": "", "text": ""}] for _ in queries]
            ret_scores = np.zeros((len(queries), 1), np.float32)
        elif opt.use_file_passages:
            # supplied passages scored by the LIVE towers, top n_context
            # kept; pad duplicates are masked (evaluate.py:187-204)
            pool, valid = model.supplied_pool(batch["passages"])
            scores = model.live_rescore(params, queries, pool)
            scores = np.where(valid, scores, np.float32(-1e9))
            order = np.argsort(-scores, axis=-1)[:, :opt.n_context]
            ret_scores = np.take_along_axis(scores, order, axis=-1)
            passages = [[pool[i][j] for j in order[i]]
                        for i in range(len(queries))]
        else:
            # one query embed shared by the search and the live rescore
            q_emb = model.embed_queries(params, queries)
            _, _, passages = model.retrieve(
                index, params, queries, opt.n_context,
                batch_metadata=batch.get("metadata"),
                filtering_fun=task_filter, q_emb=q_emb)
            lap("retrieve")
            # selection scores come from the LIVE towers, not the index
            # (stale between refreshes) — reference: evaluate.py:175-186
            ret_scores = model.live_rescore(params, queries, passages,
                                            q_emb=q_emb)
        lap("rescore")

        # substring recall over retrieved passages (evaluate.py:206-209)
        for i in range(n_real):
            texts = [p.get("text", "") for p in passages[i]]
            metrics["retrieval_recall"].append(
                M.recall(texts, _answers_of(batch, i)))

        if "eval_loss" in metrics and opt.compute_eval_loss:
            per_seq = model.eval_loss(params, queries, passages, targets)
            metrics["eval_loss"].extend(
                per_seq.reshape(len(queries), -1).mean(-1)[:n_real].tolist())
        lap("eval_loss")

        # multiple choice: the choice letters' logits at the first answer
        # position instead of generation (reference:
        # src/tasks/multiple_choice.py get_choice_logits + evaluate.py's MC
        # path); a dummy template carries "choices" (``extra_keys``)
        choice_rows = None
        if hasattr(task, "choices") and "choices" in batch:
            choice_rows = _choice_logits(model, params, queries, passages,
                                         task.choices)
            lap("choice_logits")
        elif opt.gen_method == "concat" or opt.concat_doc:
            # one passages-concatenated prompt per query (reference
            # src/rag.py:533-538, 2323)
            best = model.generate(params, queries, passages,
                                  max_new_tokens=opt.generation_max_length,
                                  force_concat=True)
            lap("generate")
        else:
            best, _ = model.method_generate(
                params, queries, passages, ret_scores,
                max_new_tokens=opt.generation_max_length)
            lap("generate")
        for i in range(n_real):
            if choice_rows is None:
                pred = model.generator_tokenizer.decode(best[i]).strip()
            else:
                pred = max(choice_rows[i], key=choice_rows[i].get)
            gold = _answers_of(batch, i)
            for k, v in task.evaluation(pred, gold).items():
                if k in metrics:
                    metrics[k].append(v)
            ex = {"query": queries[i], "generation": pred, "answers": gold}
            if choice_rows is not None:
                ex["choice_logits"] = choice_rows[i]
            ex["passages"] = passages[i]
            if "metadata" in batch:
                ex["metadata"] = batch["metadata"][i]
            dataset_wpred.append(ex)
        lap("score")
        dt = time.perf_counter() - t0
        logger.info("eval batch %d: %d rows, %.3f s (%s)", n_batch, n_real,
                    dt, ", ".join(f"{k} {v:.3f}" for k, v in lap.s.items()),
                    extra={"batch_s": dt, "stage_s": lap.s})

    metrics, dataset_wpred = task.evaluation_postprocessing(metrics,
                                                            dataset_wpred)
    avg = _reduce_metrics(metrics)
    if write_results or (write_results is None and opt.write_results):
        save_distributed_dataset(dataset_wpred, os.path.basename(data_path),
                                 opt)
    return avg


def run_retrieval_only(model: RAGModel, index, params, opt: Options,
                       data_path: str, step: int = 0) -> dict:
    """Retrieval-only eval (evaluate.py:60-102): substring recall and
    coverage@k of the top retriever_n_context passages. ``--task
    retrieval`` is the CLI gate for this mode, not a registered task: the
    data is read through the qa task then."""
    if opt.task == "retrieval":
        task = get_task(dataclasses.replace(opt, task="qa"),
                        model.generator_tokenizer)
    else:
        task = get_task(opt, model.generator_tokenizer)
    stats = WeightedAvgStats()
    data_iterator = task.data_iterator(
        data_path, mesh.process_index(), mesh.process_count(), opt=opt,
        is_eval=True)
    data_iterator = filter(None, map(task.process, data_iterator))
    batches = task.batch_iterator(data_iterator, opt.per_gpu_batch_size)
    batches = (_pad_batch_rows(b, opt.per_gpu_batch_size) for b in batches)
    batches = _pad_batches_across_processes(
        batches, rows=opt.per_gpu_batch_size,
        extra_keys=("choices",) if hasattr(task, "choices") else ())
    t0 = time.time()
    n = 0
    for batch in batches:
        queries = batch["query"]
        _, _, passages = model.retrieve(index, params, queries,
                                        opt.retriever_n_context)
        if batch.get("__dummy__"):
            continue
        for i in range(int(batch.get("__size__", len(queries)))):
            texts = [p.get("text", "") for p in passages[i]]
            gold = _answers_of(batch, i)
            stats.update({"recall": (M.recall(texts, gold), 1)})
            stats.update({k: (v, 1) for k, v in
                          M.coverage_at_k(texts, gold).items()})
            n += 1
    out = stats.average_stats
    out["queries_per_sec"] = n / max(time.time() - t0, 1e-9)
    return out


def _choice_logits(model: RAGModel, params, queries, passages, choices):
    """Per-example {letter: logit} at the first generated position over
    each query's top passage (``evaluation.py:238-259``): one
    ``lm_logits`` forward, the logit of each letter's first token id."""
    top1 = [[p[0]] for p in passages]
    gids, gmask = build_generation_batch(
        model.generator_tokenizer, queries, top1, model.prompt_cfg)
    with torch.no_grad():
        last = lm_logits(model.gen_params(params), model.gen_cfg,
                         model._tensor(gids), model._tensor(gmask))[:, -1]
    last = last.cpu().numpy()
    letter_ids = {
        c: model.generator_tokenizer.encode_batch([c], 4,
                                                  add_special=False)[0][0][0]
        for c in choices
    }
    return [
        {c: float(last[i, int(tid)]) for c, tid in letter_ids.items()}
        for i in range(len(queries))
    ]


def _reduce_metrics(metrics: dict) -> dict:
    """Cross-process weighted average of the collected metric lists
    (reference: evaluate.py:331 avg_dist_dict), through ``WeightedAvgStats``,
    whose key-union alignment issues the same collectives on a rank whose
    lists are all empty (``evaluation.py:262-276``)."""
    stats = WeightedAvgStats()
    stats.update({k: (float(np.mean(v)), float(len(v)))
                  for k, v in metrics.items() if len(v)})
    return stats.average_stats


def _pad_batch_rows(batch: dict, rows: int) -> dict:
    """Pad a dict-of-lists batch to exactly ``rows`` rows by repeating its
    last example; ``__size__`` keeps the real count so recording skips the
    pads."""
    n = int(batch.get("__size__", len(batch["query"])))
    if n >= rows:
        return batch
    out = dict(batch)
    for k, v in batch.items():
        if isinstance(v, list) and len(v) == n:
            out[k] = v + [v[-1]] * (rows - n)
    out["__size__"] = n
    return out


def _pad_batches_across_processes(batches, rows: int = 1,
                                  extra_keys: tuple = ()):
    """Several processes: a rank with fewer batches appends dummy ones up
    to the largest count (``evaluation.py:293-325``; reference:
    evaluate.py:44-56), so every rank issues the same collectives. The
    dummy is the rank's last batch, or for a rank with none a template of
    ``rows`` rows carrying ``extra_keys`` (a multiple-choice task's
    "choices", so an all-dummy rank takes the same branches)."""
    if mesh.process_count() == 1:
        return batches
    batches = list(batches)
    max_count = mesh.all_max(len(batches))
    if batches:
        template = dict(batches[-1])
    else:
        template = _pad_batch_rows(
            {"query": ["pad"], "target": ["pad"],
             "passages": [[{"title": "", "text": ""}]],
             **{k: ["pad"] for k in extra_keys},
             "__size__": 1}, rows)
    for _ in range(max_count - len(batches)):
        batches.append(dict(template, __dummy__=True))
    return batches


def save_distributed_dataset(data, dataset_name, opt: Options):
    """Predictions -> ``<checkpoint_dir>/<name>/<dataset_name>.jsonl``
    (src/util.py:337-362, ``evaluation.py:327-345``): each rank writes its
    rows to ``tmp_dir/<rank>.json``; after a barrier rank 0 merges them in
    rank order into the jsonl and removes the tmp files; the others wait
    for the merge."""
    dir_path = os.path.join(opt.checkpoint_dir, opt.name)
    write_path = os.path.join(dir_path, "tmp_dir")
    os.makedirs(write_path, exist_ok=True)
    rank, world = mesh.process_index(), mesh.process_count()
    with open(os.path.join(write_path, f"{rank}.json"), "w") as fw:
        json.dump(data, fw)
    mesh.barrier()
    if rank == 0:
        final_path = os.path.join(dir_path, f"{dataset_name}.jsonl")
        logger.info("Writing dataset with scores at %s", final_path)
        with open(final_path, "w") as fout:
            for r in range(world):
                path = os.path.join(write_path, f"{r}.json")
                with open(path) as f:
                    for ex in json.load(f):
                        fout.write(json.dumps(ex, ensure_ascii=False)
                                   + "\n")
                os.unlink(path)
        os.rmdir(write_path)
    mesh.barrier()
