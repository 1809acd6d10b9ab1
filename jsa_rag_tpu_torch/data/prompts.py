"""Prompt and label construction for decoder-only generators.

Behavior-port of the reference's ``tokenize_casual`` / ``tokenize_casual4gen``
(src/rag.py:389-629) — these semantics define the model's training signal:

- condition text per generator family (src/rag.py:340-388
  ``get_condition_format``): llama/mistral get
  ``<bos>[INST] Give a short answer ...\\nInput:title: {t} context: {x}``;
  GPT gets an uninstructed ``title/context`` prefix (the reference's GPT
  training branch skips the instruction, src/rag.py:428-470);
- query suffix ``\\nQuestion: {q}\\n[/INST]`` (llama/mistral) or the raw
  question (GPT);
- target = answer + EOS; labels = IGNORE_INDEX over condition+query, target
  ids over the answer;
- truncation drops condition tokens only — query and target stay whole
  (src/rag.py:417-419, 447-449, 493-495);
- training batches are right-padded; generation batches left-padded
  (src/rag.py:506-525 vs 625-629);
- one row per (query, passage) pair — B*K rows — unless ``concat_doc`` joins
  all K contexts into one prompt (src/rag.py:395-427).

The port's own copy of ``jsa_rag_tpu/data/prompts.py``.
"""

from __future__ import annotations

import dataclasses

import re

import numpy as np

from ..parallel import mesh

IGNORE_INDEX = -100

SPEAKER_RE = re.compile(r"<speaker[12]>\s*")


def remove_speakers(text: str) -> str:
    """Strip dialog speaker tags from retrieval queries
    (reference: src/rag.py remove_speakers, applied to query_to_retrieve)."""
    return SPEAKER_RE.sub("", text)


INSTRUCTION = ("Give a short answer to the Question based on relevant "
               "information given in Input.")
DIALOG_INSTRUCTION = ("Give an answer or response to the dialog based on "
                      "relevant information given in the Input.")


@dataclasses.dataclass(frozen=True)
class PromptConfig:
    family: str = "mistral"  # mistral | llama | gpt
    concat_doc: bool = False
    dialog: bool = False
    text_maxlength: int = 512
    target_maxlength: int = 256
    pad_to_multiple: int = 64


def _context_str(p: dict) -> str:
    return "title: {} context: {}".format(p.get("title", ""), p.get("text", ""))


def _tok_ids(tokenizer, text: str, max_length: int) -> list[int]:
    ids, mask = tokenizer.encode_batch([text], max_length, add_special=False)
    return [int(i) for i, m in zip(ids[0], mask[0]) if m]


def _condition_ids(tokenizer, cfg: PromptConfig, q: str, context: str
                   ) -> list[int]:
    fam = cfg.family.lower()
    if "gpt" in fam:
        if cfg.concat_doc:
            text = f"{INSTRUCTION}\nInput:{context}\nQuestion: {q}\n"
        elif cfg.dialog:
            text = f"{DIALOG_INSTRUCTION}\ndialog: {q}\nInput:{context}\n"
        else:
            text = f"{INSTRUCTION}\nInput:{context}\n"
        bos = [tokenizer.bos_id] if tokenizer.bos_id is not None else []
        return bos + _tok_ids(tokenizer, text, cfg.text_maxlength)
    # llama / mistral. Note: cfg.dialog deliberately has no effect here —
    # the reference applies the dialog framing only in its GPT branch
    # (src/rag.py:371-387; the llama/mistral branch of get_condition_format
    # has no dialog case), and we mirror that.
    text = f"[INST] {INSTRUCTION}\nInput:{context}"
    bos = [tokenizer.bos_id] if tokenizer.bos_id is not None else []
    return bos + _tok_ids(tokenizer, text, cfg.text_maxlength)


def _query_ids(tokenizer, cfg: PromptConfig, q: str) -> list[int]:
    if "gpt" in cfg.family.lower():
        # GPT training branch appends the raw question (src/rag.py:441-445);
        # concat/dialog variants already fold q into the condition.
        if cfg.concat_doc or cfg.dialog:
            return []
        return _tok_ids(tokenizer, q, cfg.target_maxlength)
    return _tok_ids(tokenizer, f"\nQuestion: {q}\n[/INST]",
                    cfg.target_maxlength)


def _rows(queries, passages, cfg: PromptConfig):
    """Yield (query, context_string) rows: B*K or B (concat)."""
    for q, ps in zip(queries, passages):
        if cfg.concat_doc:
            yield q, "\n".join(_context_str(p) for p in ps)
        else:
            for p in ps:
                yield q, _context_str(p)


def _pad_len(lengths, multiple: int) -> int:
    m = max(lengths)
    return global_max_len(((m + multiple - 1) // multiple) * multiple)


def global_max_len(m: int) -> int:
    """Cross-process max of a batch-dependent pad length (``prompts.py:
    114-131``); with one process, ``m`` itself. Every rank pads its rows to
    the same length, so a data-parallel step's ranks see the pad lengths of
    the global batch. A collective: callers build their batches in lockstep
    (the train step's and the evaluation's batches are count-aligned)."""
    return mesh.all_max(m)


def build_training_batch(tokenizer, queries, passages, targets,
                         cfg: PromptConfig):
    """-> (input_ids, labels, attention_mask) int32, right-padded.

    Rows are (B*K) ordered passage-major within each query, matching the
    reference's loop order (src/rag.py:473-505).
    """
    rows_ids, rows_labels = [], []
    tgt_iter = (
        t for t, ps in zip(targets, passages)
        for _ in range(1 if cfg.concat_doc else len(ps))
    )
    for (q, context), t in zip(_rows(queries, passages, cfg), tgt_iter):
        cond = _condition_ids(tokenizer, cfg, q, context)
        qry = _query_ids(tokenizer, cfg, q)
        tgt = _tok_ids(tokenizer, t, cfg.target_maxlength)
        if tokenizer.eos_id is not None:
            tgt = tgt + [tokenizer.eos_id]
        if len(cond) + len(qry) + len(tgt) > cfg.text_maxlength:
            keep = cfg.text_maxlength - (len(tgt) + len(qry))
            cond = cond[:max(keep, 0)]
        prefix = cond + qry
        rows_ids.append(prefix + tgt)
        rows_labels.append([IGNORE_INDEX] * len(prefix) + tgt)

    pad_len = _pad_len([len(r) for r in rows_ids], cfg.pad_to_multiple)
    n = len(rows_ids)
    ids = np.full((n, pad_len), tokenizer.pad_id, np.int32)
    labels = np.full((n, pad_len), IGNORE_INDEX, np.int32)
    mask = np.zeros((n, pad_len), np.int32)
    for i, (r, l) in enumerate(zip(rows_ids, rows_labels)):
        ids[i, :len(r)] = r
        labels[i, :len(l)] = l
        mask[i, :len(r)] = 1
    return ids, labels, mask


def build_generation_batch(tokenizer, queries, passages, cfg: PromptConfig):
    """-> (input_ids, attention_mask) int32, LEFT-padded for decoding."""
    rows = []
    for q, context in _rows(queries, passages, cfg):
        cond = _condition_ids(tokenizer, cfg, q, context)
        qry = _query_ids(tokenizer, cfg, q)
        if len(cond) + len(qry) > cfg.text_maxlength:
            cond = cond[:max(cfg.text_maxlength - len(qry), 0)]
        rows.append(cond + qry)

    pad_len = _pad_len([len(r) for r in rows], cfg.pad_to_multiple)
    n = len(rows)
    ids = np.full((n, pad_len), tokenizer.pad_id, np.int32)
    mask = np.zeros((n, pad_len), np.int32)
    for i, r in enumerate(rows):
        ids[i, pad_len - len(r):] = r
        mask[i, pad_len - len(r):] = 1
    return ids, mask
