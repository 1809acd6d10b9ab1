"""Language-modelling task: split text into context/continuation
(reference: src/tasks/lm.py).

The port's own copy of ``jsa_rag_tpu/tasks/lm.py``.
"""

from __future__ import annotations

import random
import re

from ..utils.metrics import exact_match_score, f1_score, rouge_score
from .base import BaseTask, filter_results_by_id


class Task(BaseTask):
    metrics = ["eval_loss", "accuracy", "f1", "rouge_1", "rouge_2", "rouge_L"]

    def __init__(self, opt, *args, **kwargs):
        self.min_words = opt.min_words_per_lm_instance
        self.min_context_ratio = opt.min_lm_context_ratio
        self.max_context_ratio = opt.max_lm_context_ratio

    def filter(self, *args, **kwargs):
        return filter_results_by_id(*args, **kwargs)

    def process(self, example, *args, **kwargs):
        text = example["text"]
        if len(text.strip()) == 0:
            return None
        if self.min_words is not None and len(text.split()) < self.min_words:
            return None
        inp, out = self.split(text, self.min_context_ratio,
                              self.max_context_ratio)
        if "passages" not in example:
            example["passages"] = [{"title": "", "text": ""}]
        example["query"] = inp
        example["target"] = out
        example["metadata"] = {"id": example["id"]}
        return example

    @staticmethod
    def split(text, min_context_ratio, max_context_ratio):
        words = re.split(r"(\S+)", text)
        min_length = int(max(2, len(words) * min_context_ratio))
        max_length = int(max(min(len(words) - 2,
                                 len(words) * max_context_ratio),
                             min_length + 1))
        split_idx = random.randint(min_length, max_length)
        return "".join(words[:split_idx]), "".join(words[split_idx:])

    def evaluation(self, prediction, ground_truths):
        r1, r2, rl = rouge_score(prediction, ground_truths)
        return {
            "accuracy": exact_match_score(prediction, ground_truths),
            "f1": f1_score(prediction, ground_truths),
            "rouge_1": r1, "rouge_2": r2, "rouge_L": rl,
        }
