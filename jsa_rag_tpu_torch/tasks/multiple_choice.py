"""Multiple-choice task with permutation debiasing
(reference: src/tasks/multiple_choice.py).

The port's own copy of ``jsa_rag_tpu/tasks/multiple_choice.py``.
"""

from __future__ import annotations

import copy
import itertools
import string

import numpy as np

from ..utils.metrics import exact_match_score
from .base import BaseTask


def _get_permutation_orderings(n, permutations_type):
    li = list(range(n))
    if permutations_type == "cyclic":
        return [li[n - i:] + li[:n - i] for i in range(n)]
    if permutations_type == "all":
        return list(itertools.permutations(li))
    return [li]


class Task(BaseTask):
    metrics = ["debiased_accuracy", "accuracy", "eval_loss"]

    def __init__(self, opt, tokenizer, *args, **kwargs):
        super().__init__()
        self.tokenizer = tokenizer
        self.maximum_question_length = 356
        self.choices = string.ascii_uppercase[: opt.multiple_choice_num_options]
        self.decoder_only = getattr(opt, "decoder_only", True)

    @staticmethod
    def get_multiple_choice_question_prompt(tokenizer, question, choices,
                                            maximum_length=356,
                                            decoder_only=True):
        choices_wsep = " ".join(f"({L}) {T}" for L, T in choices.items()).strip()
        # decoder-only: prompt ends at 'answer:' and the target is the bare
        # letter, so the first generated/scored position IS the letter (the
        # <extra_id_0> sentinel is the T5/FiD span marker; training it as a
        # literal prefix makes choice-logit scoring read the wrong position)
        tail = "answer:" if decoder_only else "answer: <extra_id_0>"
        prompt = (f"question: {question.strip()} options: {choices_wsep} "
                  f"{tail}")
        # word-level truncation stand-in for the reference's token-level one
        words = prompt.split()
        if len(words) > maximum_length:
            prompt = " ".join(words[-maximum_length:])
        return prompt

    def process(self, example, *args, **kwargs):
        preprocessed_question = self.get_multiple_choice_question_prompt(
            self.tokenizer, example["question"], example["options"],
            maximum_length=self.maximum_question_length,
            decoder_only=self.decoder_only)
        target = (example["answer"] if self.decoder_only
                  else f'<extra_id_0> {example["answer"]}')
        return {
            "query": preprocessed_question,
            "target": target,
            "choices": self.choices,
            "passages": [{"title": "", "text": ""}],
            "answers": [example["answer"]],
            "metadata": example,
        }

    @staticmethod
    def get_permutations(example, permutations_type):
        options, answer = example["options"], example["answer"]
        uid = example["question"] + " ".join(options.values())
        choice_keys = sorted(options.keys())
        choice_values = [options[c] for c in choice_keys]
        orderings = _get_permutation_orderings(len(choice_keys),
                                               permutations_type)
        permuted = []
        for ordering in orderings:
            p_options = {c: choice_values[o]
                         for c, o in zip(choice_keys, ordering)}
            p_answer = [k for k, ans in p_options.items()
                        if ans == options[answer]][0]
            ex = copy.deepcopy(example)
            ex["options"] = p_options
            ex["answer"] = p_answer
            ex["is_original"] = p_options == example["options"]
            ex["uid"] = uid
            permuted.append(ex)
        return permuted

    @staticmethod
    def data_iterator(*args, **kwargs):
        """Wrap the base iterator to expand each example into its
        permutations (reference: src/tasks/multiple_choice.py:105-117)."""
        super_iterator = BaseTask.data_iterator(*args, **kwargs)
        opt = kwargs["opt"]  # loud failure like the reference (py:108-112)
        if kwargs.get("is_eval", False):
            perms_type = opt.multiple_choice_eval_permutations
        else:
            perms_type = opt.multiple_choice_train_permutations
        for example in super_iterator:
            yield from Task.get_permutations(example, perms_type)

    def evaluation(self, prediction, ground_truths):
        return {"accuracy": exact_match_score(prediction, ground_truths)}

    def _get_original_instance(self, permutations):
        return [p for p in permutations if p["metadata"]["is_original"]][0]

    def _marginalize_across_permutations(self, permutations):
        original = self._get_original_instance(permutations)
        text2letter = {v: k for k, v in
                       original["metadata"]["options"].items()}
        aggregate: dict[str, list[float]] = {}
        for perm in permutations:
            logits = np.array([perm["choice_logits"][c]
                               for c in self.choices])
            e = np.exp(logits - logits.max())
            probs = (e / e.sum()).tolist()
            texts = [perm["metadata"]["options"][c] for c in self.choices]
            for t, p in zip(texts, probs):
                aggregate.setdefault(t, []).append(p)
        marginalized = {text2letter[t]: float(np.mean(v))
                        for t, v in aggregate.items()}
        return marginalized, aggregate

    def _reduce_permutations(self, dataset_wpred):
        to_agg: dict[str, list] = {}
        for output in dataset_wpred:
            to_agg.setdefault(output["metadata"]["uid"], []).append(output)
        out = []
        for _, perms in to_agg.items():
            original = copy.deepcopy(self._get_original_instance(perms))
            scores, all_scores = self._marginalize_across_permutations(perms)
            original.pop("choice_logits", None)
            original["choice_probs"] = scores
            original["generation"] = max(scores.items(), key=lambda x: x[1])[0]
            original["all_probs"] = all_scores
            original["permutations"] = perms
            out.append(original)
        return out

    def evaluation_postprocessing(self, metrics, dataset_with_predictions):
        dataset_with_predictions = self._reduce_permutations(
            dataset_with_predictions)
        metrics["debiased_accuracy"] = [
            float(d["generation"] == d["metadata"]["answer"])
            for d in dataset_with_predictions
        ]
        return metrics, dataset_with_predictions
