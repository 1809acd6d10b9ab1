"""FEVER claim verification (reference: src/tasks/fever.py).

The port's own copy of ``jsa_rag_tpu/tasks/fever.py``.
"""

from __future__ import annotations

from ..utils.metrics import exact_match_score
from .base import BaseTask


class Task(BaseTask):
    metrics = ["accuracy"]

    def __init__(self, opt=None, tokenizer=None, *args, **kwargs):
        super().__init__()
        self.decoder_only = getattr(opt, "decoder_only", True)

    def process(self, example, *args, **kwargs):
        clean_input = example["claim"]
        clean_target = ""
        if "label" in example:
            target = example["label"]
            clean_target = {"NOT ENOUGH INFO": "maybe", "REFUTES": "false",
                            "SUPPORTS": "true"}.get(target, "")
        example["metadata"] = example.get("metadata", {})
        # the <extra_id_0> sentinel is the T5/FiD span marker; decoder-only
        # generators must train/emit the bare answer (same gating as qa.py)
        if self.decoder_only:
            example["query"] = f"question: {clean_input} answer:"
            example["target"] = clean_target
        else:
            example["query"] = (f"question: {clean_input} "
                                f"answer: <extra_id_0>")
            example["target"] = f"<extra_id_0> {clean_target}"
        example["passages"] = [{"title": "", "text": ""}]
        example["metadata"]["clean_target"] = clean_target
        example["answers"] = [clean_target]
        return example

    def evaluation(self, prediction, ground_truths):
        return {"accuracy": exact_match_score(prediction, ground_truths)}
