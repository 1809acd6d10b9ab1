"""Open-domain QA task (reference: src/tasks/qa.py): EM/F1/BLEU/Rouge over
prompted questions; the flagship NQ/TriviaQA task.

The port's own copy of ``jsa_rag_tpu/tasks/qa.py``."""

from __future__ import annotations

import random

from ..utils.metrics import (
    bleu_score, exact_match_score, f1_score, normalize_answer, rouge_score,
)
from .base import BaseTask


class Task(BaseTask):
    metrics = ["exact_match", "f1", "eval_loss", "BLEU-4", "BLEU-1",
               "Rouge-1", "Rouge-2", "Rouge-L"]

    def __init__(self, opt, *args, **kwargs):
        super().__init__()
        self.qa_prompt_format_str = opt.qa_prompt_format
        self.decoder_only = opt.decoder_only

    def get_qa_prompt(self, question: str) -> str:
        return self.qa_prompt_format_str.format(question=question)

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
        example["query"] = self.get_qa_prompt(example["question"])
        if target is not None:
            example["target"] = (target if self.decoder_only
                                 else f"<extra_id_0> {target}")
        return example

    def evaluation(self, prediction, ground_truths):
        r1, r2, rl = rouge_score(prediction, ground_truths)
        return {
            "exact_match": exact_match_score(prediction, ground_truths,
                                             normalize_answer),
            "f1": f1_score(prediction, ground_truths, normalize_answer),
            "BLEU-4": bleu_score(prediction, ground_truths, 4),
            "BLEU-1": bleu_score(prediction, ground_truths, 1),
            "Rouge-1": r1,
            "Rouge-2": r2,
            "Rouge-L": rl,
        }
