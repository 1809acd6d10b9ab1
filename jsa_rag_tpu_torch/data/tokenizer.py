"""Tokenization front-end (the port's own copy of
``jsa_rag_tpu/data/tokenizer.py``; framework-neutral).

Production path wraps a HF tokenizer (bge/mistral/llama vocabularies,
reference loads them in src/model_io.py:132-150 and src/retrievers.py:108-142).
For tests and synthetic runs — this image has no model hub access — a
self-contained ``SimpleTokenizer`` provides the same interface with a
dynamically grown word vocabulary.

Interface contract (used by the embed pipeline, tasks, and the generator):

- ``encode_batch(texts, max_length) -> (ids, mask)`` right-padded int32;
- ``encode_pair_batch`` for query [SEP] target posterior inputs;
- ``decode(ids) -> str``;
- special ids: ``pad_id, bos_id, eos_id, sep_id``.
"""

from __future__ import annotations

import numpy as np


class SimpleTokenizer:
    """Whitespace word tokenizer with a growable vocab. Deterministic within
    a process; serializable via ``to_dict``/``from_dict`` for checkpoints."""

    PAD, BOS, EOS, UNK, SEP, MASK = range(6)

    def __init__(self, vocab: dict[str, int] | None = None,
                 max_vocab: int = 50000, frozen: bool = False):
        self.vocab: dict[str, int] = dict(vocab or {})
        self.inv: dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.max_vocab = max_vocab
        self.frozen = frozen

    pad_id, bos_id, eos_id, unk_id, sep_id, mask_id = (
        PAD, BOS, EOS, UNK, SEP, MASK
    )
    n_special = 6

    @property
    def vocab_size(self) -> int:
        return self.max_vocab

    def _id(self, word: str) -> int:
        wid = self.vocab.get(word)
        if wid is None:
            if self.frozen or len(self.vocab) + self.n_special >= self.max_vocab:
                return self.UNK
            wid = len(self.vocab) + self.n_special
            self.vocab[word] = wid
            self.inv[wid] = word
        return wid

    def tokenize(self, text: str) -> list[int]:
        return [self._id(w) for w in text.split()]

    def encode(self, text: str, max_length: int,
               add_special: bool = True) -> tuple[np.ndarray, np.ndarray]:
        ids = self.tokenize(text)
        if add_special:
            ids = [self.BOS] + ids[: max_length - 2] + [self.EOS]
        else:
            ids = ids[:max_length]
        mask = [1] * len(ids)
        pad = max_length - len(ids)
        ids = ids + [self.PAD] * pad
        mask = mask + [0] * pad
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def encode_batch(self, texts: list[str], max_length: int,
                     add_special: bool = True):
        pairs = [self.encode(t, max_length, add_special) for t in texts]
        ids = np.stack([p[0] for p in pairs])
        mask = np.stack([p[1] for p in pairs])
        return ids, mask

    def encode_pair_batch(self, texts_a: list[str], texts_b: list[str],
                          max_length: int):
        """``a [SEP] b`` — posterior retriever input (reference builds
        ``query + ' [SEP] ' + target``, src/rag.py:1572)."""
        joined = [f"{a} [SEP] {b}" for a, b in zip(texts_a, texts_b)]
        # make sure [SEP] maps to the special id
        self.vocab.setdefault("[SEP]", self.SEP)
        self.inv[self.SEP] = "[SEP]"
        return self.encode_batch(joined, max_length)

    def decode(self, ids, skip_special: bool = True) -> str:
        words = []
        for i in np.asarray(ids).tolist():
            if skip_special and i < self.n_special:
                continue
            words.append(self.inv.get(int(i), "<unk>"))
        return " ".join(words)

    def to_dict(self) -> dict:
        return {"vocab": self.vocab, "max_vocab": self.max_vocab,
                "frozen": self.frozen}

    @classmethod
    def from_dict(cls, d: dict) -> "SimpleTokenizer":
        # default frozen=False keeps old checkpoints loadable
        return cls(vocab=d["vocab"], max_vocab=d["max_vocab"],
                   frozen=bool(d.get("frozen", False)))


class HFTokenizerWrapper:
    """Adapter giving HF tokenizers the same batch interface."""

    def __init__(self, hf_tokenizer):
        self.t = hf_tokenizer
        if self.t.pad_token is None:
            self.t.pad_token = self.t.eos_token or self.t.unk_token
        self.pad_id = self.t.pad_token_id
        # keep None when the tokenizer has no such token: `or 0` would
        # smuggle token id 0 in as a fake bos/eos (prepended to every
        # prompt / treated as a stop token by decode)
        self.bos_id = getattr(self.t, "bos_token_id", None)
        self.eos_id = getattr(self.t, "eos_token_id", None)
        sep = getattr(self.t, "sep_token_id", None)
        self.sep_id = sep if sep is not None else self.eos_id

    @property
    def vocab_size(self) -> int:
        return len(self.t)

    def encode_batch(self, texts, max_length, add_special: bool = True):
        out = self.t(
            list(texts), padding="max_length", truncation=True,
            max_length=max_length, return_tensors="np",
            add_special_tokens=add_special,
        )
        return (out["input_ids"].astype(np.int32),
                out["attention_mask"].astype(np.int32))

    def encode_pair_batch(self, texts_a, texts_b, max_length):
        joined = [f"{a} {self.t.sep_token or '[SEP]'} {b}"
                  for a, b in zip(texts_a, texts_b)]
        return self.encode_batch(joined, max_length)

    def decode(self, ids, skip_special: bool = True) -> str:
        return self.t.decode(
            [int(i) for i in np.asarray(ids).tolist()],
            skip_special_tokens=skip_special,
        )


def load_tokenizer(name_or_path: str | None, max_vocab: int = 50000):
    """HF tokenizer if loadable from a local path/cache, else SimpleTokenizer
    (no network in this environment; synthetic runs use the simple one)."""
    if name_or_path:
        try:
            from transformers import AutoTokenizer

            return HFTokenizerWrapper(
                AutoTokenizer.from_pretrained(
                    name_or_path, local_files_only=True
                )
            )
        except Exception:
            pass
    return SimpleTokenizer(max_vocab=max_vocab)
