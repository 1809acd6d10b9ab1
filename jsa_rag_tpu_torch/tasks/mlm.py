"""Masked-LM (T5 span-corruption) task (reference: src/tasks/mlm.py).

``apply_mlm_noise`` works with any tokenizer exposing ``encode_batch`` +
``decode`` — sentinel tokens come from the tokenizer when it provides
``additional_special_tokens_ids`` (HF) and fall back to synthetic
``<extra_id_k>`` words otherwise.

The port's own copy of ``jsa_rag_tpu/tasks/mlm.py``.
"""

from __future__ import annotations

import random

from ..utils.metrics import exact_match_score, f1_score, rouge_score
from .base import BaseTask, filter_results_by_id


class Task(BaseTask):
    metrics = ["eval_loss", "accuracy", "f1", "rouge_1", "rouge_2", "rouge_L"]

    def __init__(self, opt, tokenizer, *args, **kwargs):
        self.tokenizer = tokenizer
        self.min_words = opt.min_words_per_lm_instance
        self.mlm_noise_density = opt.mlm_noise_density
        self.mlm_mean_noise_span_length = opt.mlm_mean_noise_span_length
        self.text_maxlength = opt.text_maxlength

    def filter(self, *args, **kwargs):
        return filter_results_by_id(*args, **kwargs)

    def process(self, example, *args, **kwargs):
        clean_target = example["text"]
        if len(clean_target.strip()) == 0:
            return None
        if self.min_words is not None and \
                len(clean_target.split()) < self.min_words:
            return None
        inp, out = self.apply_mlm_noise(
            self.tokenizer, clean_target, self.mlm_noise_density,
            self.mlm_mean_noise_span_length, self.text_maxlength,
        )
        output_example = {
            "passages": example.get("passages",
                                    [{"title": "", "text": ""}]),
            "query": inp,
            "target": out,
            "metadata": dict(example, clean_target=clean_target),
        }
        return output_example

    def evaluation(self, prediction, ground_truths):
        r1, r2, rl = rouge_score(prediction, ground_truths)
        return {
            "accuracy": exact_match_score(prediction, ground_truths),
            "f1": f1_score(prediction, ground_truths),
            "rouge_1": r1, "rouge_2": r2, "rouge_L": rl,
        }

    @staticmethod
    def apply_mlm_noise(tokenizer, text, mlm_noise_density,
                        mlm_mean_noise_span_length, max_input_length):
        """T5-style span corruption over word tokens (src/tasks/mlm.py:72-109,
        re-expressed over whitespace tokens so it is tokenizer-agnostic)."""
        tokens = text.split()[:max_input_length]
        length = len(tokens)
        num_noise_tokens = max(round(length * mlm_noise_density), 1)
        num_noise_spans = max(
            round(num_noise_tokens / mlm_mean_noise_span_length), 1)
        num_nonnoise_tokens = length - num_noise_tokens

        def _get_span_lengths(num_items, num_segments):
            if num_items <= 0:
                # 0 items -> every span empty (the generic path below would
                # fabricate a length-1 span and leak a token that should
                # have been noised)
                return [0] * num_segments
            positions = [i < (num_segments - 1) for i in range(num_items - 1)]
            random.shuffle(positions)
            positions.append(True)
            output, prev_span_start = [], -1
            for i, n in enumerate(positions):
                if n:
                    output.append(i - prev_span_start)
                    prev_span_start = i
            return output

        noise_span_lengths = _get_span_lengths(num_noise_tokens,
                                               num_noise_spans)
        nonnoise_span_lengths = _get_span_lengths(num_nonnoise_tokens,
                                                  num_noise_spans)
        inputs, outputs, offset = [], [], 0
        for i, (inp_len, out_len) in enumerate(
                zip(nonnoise_span_lengths, noise_span_lengths)):
            sentinel = f"<extra_id_{i}>"
            inputs += tokens[offset: offset + inp_len] + [sentinel]
            offset += inp_len
            outputs += [sentinel] + tokens[offset: offset + out_len]
            offset += out_len
        return " ".join(inputs), " ".join(outputs)
