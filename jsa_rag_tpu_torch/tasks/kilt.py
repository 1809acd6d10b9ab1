"""KILT-format tasks (reference: src/tasks/kilt.py).

The port's own copy of ``jsa_rag_tpu/tasks/kilt.py``.
"""

from __future__ import annotations

import random

from ..utils.metrics import exact_match_score, f1_score, normalize_answer
from .base import BaseTask


class Task(BaseTask):
    metrics = ["accuracy", "exact_match", "f1"]

    def __init__(self, opt=None, tokenizer=None, *args, **kwargs):
        super().__init__()
        self.decoder_only = getattr(opt, "decoder_only", True)

    def process(self, example, *args, **kwargs):
        clean_input = example["input"]
        answers = list(self.get_gold_answers(example))
        if "filename" in example and "fever" in example["filename"]:
            answers = ["true" if a == "SUPPORTS" else "false"
                       for a in answers]
        if not answers:
            # KILT dev lines can carry provenance-only outputs; skip like
            # other tasks (returning None drops the example upstream)
            return None
        clean_target = random.choice(answers)
        example["metadata"] = example.get("metadata", {})
        if self.decoder_only:
            example["query"] = f"question: {clean_input} answer:"
            example["target"] = clean_target
        else:
            example["query"] = (f"question: {clean_input} "
                                f"answer: <extra_id_0>")
            example["target"] = f"<extra_id_0> {clean_target}"
        example["answers"] = answers
        example["passages"] = [{"title": "", "text": ""}]
        example["metadata"]["clean_target"] = clean_target
        return example

    def get_gold_answers(self, gold):
        ground_truths = set()
        for item in gold["output"]:
            if "answer" in item and item["answer"] and \
                    len(item["answer"].strip()) > 0:
                ground_truths.add(item["answer"].strip())
        return ground_truths

    def evaluation(self, prediction, ground_truths):
        return {
            "accuracy": exact_match_score(prediction, ground_truths),
            "exact_match": exact_match_score(prediction, ground_truths,
                                             normalize_answer),
            "f1": f1_score(prediction, ground_truths, normalize_answer),
        }
