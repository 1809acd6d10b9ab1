"""Task framework: jsonl streaming, rank-sharding, batching, anti-cheat
filtering (reference: src/tasks/base.py — rebuilt from the intended behavior;
the checked-in file has unresolved merge markers).

The port's own copy of ``jsa_rag_tpu/tasks/base.py``. It holds the directly
usable ``base`` task and ``filter_results_by_id``, the anti-cheat filter of
the lm, mlm and section tasks."""

from __future__ import annotations

import json
import logging
import random
from collections import defaultdict

from ..parallel import mesh
from ..utils.metrics import exact_match_score


logger = logging.getLogger(__name__)


def _process_count() -> int:
    return mesh.process_count()


def _process_index() -> int:
    return mesh.process_index()


class BaseTask:
    metrics = ["accuracy", "eval_loss"]

    def __init__(self, *args, **kwargs):
        self.filter = None

    @staticmethod
    def data_iterator(filenames, world_rank=-1, world_size=-1,
                      repeat_if_less_than_world_size=False, *args, **kwargs):
        """Stream jsonl examples, sharding by ``total_yielded % world_size ==
        world_rank`` and repeating tiny datasets until every worker has one
        (src/tasks/base.py:28-47)."""
        if isinstance(filenames, str):
            filenames = [filenames]

        def _iter():
            return (line for filename in filenames
                    for line in open(filename, encoding="utf-8"))

        def _stop():
            return (total_yielded >= world_size
                    if repeat_if_less_than_world_size else total_yielded > 0)

        total_yielded = 0
        while not _stop():
            saw_line = False
            for line in _iter():
                saw_line = True
                total_yielded += 1
                if world_rank > -1 and total_yielded % world_size != world_rank:
                    continue
                yield json.loads(line)
            if not saw_line:
                # fail fast on an empty dataset: the reference's repeat
                # loop (src/tasks/base.py:28-47) would spin forever here
                raise ValueError(
                    f"no examples in {filenames} — empty dataset file?")

    @staticmethod
    def batch_iterator(data_iterator, batch_size, drop_last=False,
                       shuffle=False, shuffle_buffer_size=65536,
                       shuffle_seed=None):
        """Dict-of-lists batching (src/tasks/base.py:50-66).
        ``shuffle_seed`` makes the epoch's data order reproducible (the
        reference seeds all host RNGs from opt.seed, train.py:397)."""
        if shuffle:
            data_iterator = BaseTask.shuffle_iterator(
                data_iterator, buffer_size=shuffle_buffer_size,
                seed=shuffle_seed)
        batch = defaultdict(list)
        batch["__size__"] = 0
        yielded = 0
        for example in data_iterator:
            for k, v in example.items():
                batch[k].append(v)
            batch["__size__"] += 1
            if batch["__size__"] == batch_size:
                yield batch
                yielded += 1
                batch = defaultdict(list)
                batch["__size__"] = 0
        if batch["__size__"] > 0:
            if not drop_last:
                yield batch
            elif yielded == 0:
                # a rank whose shard is smaller than one batch would yield
                # NOTHING per epoch and spin forever while the other ranks
                # run global train steps (collective desync/hang) — repeat
                # examples up to a full static batch instead
                n = batch["__size__"]
                for k, v in list(batch.items()):
                    if isinstance(v, list) and len(v) == n:
                        batch[k] = [v[i % n] for i in range(batch_size)]
                batch["__size__"] = batch_size
                yield batch
        elif drop_last and yielded == 0 and _process_count() > 1:
            # ZERO usable examples on this rank (every raw line filtered
            # out by task.process): the repeat-pad protection above has
            # nothing to replicate, and silently yielding no batches
            # would hang the other ranks inside the global train step's
            # collectives. Fail loudly on THIS rank instead — the fix is
            # data sharding / filters, not padding.
            raise RuntimeError(
                f"process {_process_index()}'s data shard produced "
                "zero usable examples after task filtering — multi-"
                "process training would desync; rebalance the shards or "
                "relax the filter")

    @staticmethod
    def shuffle_iterator(dataset, buffer_size: int = 65536, seed=None):
        """Streaming reservoir shuffle: hold ``buffer_size`` examples and
        emit a uniformly random one as each new example arrives (then drain
        the buffer shuffled). Datasets smaller than the buffer get a full
        Fisher-Yates shuffle; larger ones stream at O(buffer) memory — the
        reference materializes the whole dataset per epoch
        (random.shuffle over a list), the wrong shape for the 21M-scale
        corpora the rest of the framework targets. Note mixing is
        window-local for datasets larger than the buffer: an example moves
        at most ~buffer_size positions, so a topic-/length-sorted file
        keeps its coarse order. ``buffer_size <= 0`` materializes and
        fully shuffles (the reference behavior; ``--shuffle_buffer_size
        0`` restores it for datasets that fit in host memory)."""
        rng = random.Random(seed) if seed is not None else random
        if buffer_size <= 0:
            buf = list(dataset)
            rng.shuffle(buf)
            yield from buf
            return
        buf = []
        for example in dataset:
            if len(buf) < buffer_size:
                buf.append(example)
                continue
            j = rng.randrange(buffer_size)
            buf[j], example = example, buf[j]
            yield example
        rng.shuffle(buf)
        yield from buf

    def process(self, example, *args, **kwargs):
        assert "target" in example and isinstance(example["target"], str)
        assert "query" in example and isinstance(example["query"], str)
        if "passages" not in example:
            example["passages"] = [{"title": "", "text": ""}]
        return example

    def evaluation(self, prediction, ground_truths):
        return {"accuracy": exact_match_score(prediction, ground_truths)}

    def evaluation_postprocessing(self, metrics, dataset_with_predictions):
        return metrics, dataset_with_predictions


class Task(BaseTask):
    """`base` task is directly usable (reference exposes it in the registry)."""

    def __init__(self, opt=None, tokenizer=None, *args, **kwargs):
        super().__init__()


def filter_results_by_id(batch_metadata, passages, scores, topk,
                         training=False):
    """Anti-cheat filter for MLM/LM/section: drop retrieved passages whose id
    matches the source chunk being denoised/generated; re-append them only if
    the result would fall short of topk (src/tasks/base.py:97-132)."""
    if batch_metadata is None:
        logger.warning(
            "filter_results_by_id got a batch without metadata (likely a "
            "padding instance); returning the unfiltered topk")
        return [ps[:topk] for ps in passages], [ss[:topk] for ss in scores]

    output_passages, output_scores = [], []
    for metadata, passage_li, scores_li in zip(batch_metadata, passages,
                                               scores):
        kept, violating = [], []
        for p, s in zip(passage_li, scores_li):
            (violating if p.get("id") == metadata.get("id") else kept).append(
                (p, s))
        if topk > len(kept):
            logger.warning("%d passages after filtering for topk = %d",
                           len(kept), topk)
        kept += violating
        ps, ss = zip(*kept)
        output_passages.append(ps)
        output_scores.append(ss)
    return ([ps[:topk] for ps in output_passages],
            [ss[:topk] for ss in output_scores])
