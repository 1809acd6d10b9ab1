"""The reference recipe's text handling for a mistral generator and a BERT
retriever, over the word vocabularies ``benchmark/inputs.py`` makes:

- the word tokenizer: one id a whitespace-separated word (6 + i for
  ``w<i>``, unknown words id 3), BOS (1) and EOS (2) around a retriever
  input, padding 0;
- the generator's rows (``src/rag.py:389-505``, ``tokenize_casual``): the
  condition ``<bos>[INST] <instruction>\\nInput:title: <t> context: <x>``,
  the query ``\\nQuestion: <q>\\n[/INST]``, the target ``<answer><eos>``;
  when the three pass ``text_maxlength`` the condition is cut, the query and
  the target stay whole; labels -100 over condition and query; rows padded
  to a multiple of 64.
"""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
IGNORE = -100
INSTRUCTION = ("Give a short answer to the Question based on relevant "
               "information given in Input.")
CONDITION = "[INST] {instruction}\nInput:title: {title} context: {text}"
QUERY = "\nQuestion: {q}\n[/INST]"
PAD_MULTIPLE = 64


def prompt_words() -> list[str]:
    """The words of the prompt templates, in order of first use."""
    text = (CONDITION.format(instruction=INSTRUCTION, title="", text="")
            + QUERY.format(q=""))
    out = []
    for w in text.split():
        if w not in out:
            out.append(w)
    return out


def tokens(vocab: dict, text: str) -> list[int]:
    return [vocab.get(w, UNK) for w in text.split()]


def retriever_ids(vocab: dict, text: str, max_length: int) -> list[int]:
    """A retriever input at its real length: BOS, the words, EOS."""
    return [BOS] + tokens(vocab, text)[:max_length - 2] + [EOS]


def passage_text(p: dict) -> str:
    return f"{p['title']} {p['text']}"


def generator_rows(vocab: dict, question: str, passages: list[dict],
                   answer: str, text_maxlength: int, target_maxlength: int):
    """One row per passage -> (ids, labels, mask) int64 (R, S) numpy."""
    rows, labs = [], []
    for p in passages:
        cond = [BOS] + tokens(vocab, CONDITION.format(
            instruction=INSTRUCTION, title=p["title"],
            text=p["text"]))[:text_maxlength]
        qry = tokens(vocab, QUERY.format(q=question))[:target_maxlength]
        tgt = tokens(vocab, answer)[:target_maxlength] + [EOS]
        if len(cond) + len(qry) + len(tgt) > text_maxlength:
            cond = cond[:max(text_maxlength - len(tgt) - len(qry), 0)]
        rows.append(cond + qry + tgt)
        labs.append([IGNORE] * (len(cond) + len(qry)) + tgt)
    m = max(len(r) for r in rows)
    s = -(-m // PAD_MULTIPLE) * PAD_MULTIPLE
    ids = np.full((len(rows), s), PAD, np.int64)
    labels = np.full((len(rows), s), IGNORE, np.int64)
    mask = np.zeros((len(rows), s), np.int64)
    for i, (r, l) in enumerate(zip(rows, labs)):
        ids[i, :len(r)] = r
        labels[i, :len(l)] = l
        mask[i, :len(r)] = 1
    return ids, labels, mask
