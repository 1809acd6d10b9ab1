"""Plain QA without the instruction prompt (reference: src/tasks/vanilla_qa.py).

The port's own copy of ``jsa_rag_tpu/tasks/vanilla_qa.py``.
"""

from __future__ import annotations

import random

from ..utils.metrics import exact_match_score, f1_score, normalize_answer
from .base import BaseTask


class Task(BaseTask):
    metrics = ["exact_match", "f1", "eval_loss"]

    def __init__(self, opt, *args, **kwargs):
        super().__init__()
        self.qa_prompt_format_str = opt.qa_prompt_format

    def process(self, example, *args, **kwargs):
        if "target" in example:
            target = example["target"]
        elif "answers" in example:
            target = random.choice(example["answers"])
        else:
            target = None
        if "passages" not in example:
            example["passages"] = [{"title": "", "text": ""}]
        example["metadata"] = example.get("metadata", {})
        example["query"] = "question: " + example["question"]
        if target is not None:
            example["target"] = target
        return example

    def evaluation(self, prediction, ground_truths):
        return {
            "exact_match": exact_match_score(prediction, ground_truths,
                                             normalize_answer),
            "f1": f1_score(prediction, ground_truths, normalize_answer),
        }
