"""Section-generation task: title+section -> text
(reference: src/tasks/section.py).

The port's own copy of ``jsa_rag_tpu/tasks/section.py``.
"""

from __future__ import annotations

from ..utils.metrics import exact_match_score, f1_score, rouge_score
from .base import BaseTask, filter_results_by_id


class Task(BaseTask):
    metrics = ["eval_loss", "accuracy", "f1", "rouge_1", "rouge_2", "rouge_L"]

    def __init__(self, opt, *args, **kwargs):
        self.min_words = opt.min_words_per_lm_instance

    def process(self, example, *args, **kwargs):
        if "section" not in example or len(example["section"].strip()) == 0:
            return None
        query = ", ".join([example["title"], example["section"]])
        text = example["text"]
        if len(text.strip()) == 0:
            return None
        if self.min_words is not None and len(text.split()) < self.min_words:
            return None
        if "passages" not in example:
            example["passages"] = [{"title": "", "text": ""}]
        example["query"] = query
        example["target"] = text
        example["metadata"] = {"id": example["id"]}
        return example

    def evaluation(self, prediction, ground_truths):
        r1, r2, rl = rouge_score(prediction, ground_truths)
        return {
            "accuracy": exact_match_score(prediction, ground_truths),
            "f1": f1_score(prediction, ground_truths),
            "rouge_1": r1, "rouge_2": r2, "rouge_L": rl,
        }

    def filter(self, *args, **kwargs):
        return filter_results_by_id(*args, **kwargs)
