"""Everything a run feeds the program, made from the run's ``--seed``: the
corpus, the questions and answers, the word vocabularies, the model weights
and the index rows. The plain reference makes the same inputs with the same
functions, so both sides see the same numbers.

Frozen copies (the program may change; these may not):

- the passage length law is ``jsa_rag_tpu_torch/analysis/synthetic.py::
  wiki_like_passages`` (normal(155, 18) words clipped to [110, 230]), made
  per id when read instead of in bulk, so a 5.25M-passage corpus costs no
  set-up;
- the unit index rows are ``jsa_rag_tpu_torch/bench.py::unit_gaussian``,
  written ``CHUNK`` rows at a time as ``analysis/train_step_bench.py::
  random_index`` writes them;
- the weight init is the program's N(0, 0.02) matrices, unit norm scales and
  zero biases (``models/lm.py::lm_init``, ``models/bert.py::_param``) and
  LoRA's A ~ 0.01 N(0, 1), B = 0 (``models/lora.py::lora_init``), drawn in
  one call per model into one buffer instead of leaf by leaf.

Words are ``w<i>``; the word tokenizers map ``w<i>`` to id ``6 + i`` (six
special ids first, as the program's ``SimpleTokenizer`` numbers them).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

N_SPECIAL = 6  # PAD BOS EOS UNK SEP MASK of the word tokenizer
SEP_ID = 4
CHUNK = 65_536  # index rows made and written at a time


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of the run (``tags``: strings or
    integers)."""
    ints = [int(seed)] + [t if isinstance(t, int) else zlib.crc32(
        str(t).encode()) for t in tags]
    return int(np.random.SeedSequence(ints).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def words(ids) -> str:
    return " ".join(f"w{int(j)}" for j in ids)


class WikiPassages:
    """Passage ``i`` of a corpus of ``n``, made from (seed, i) when read:
    ``title`` 1-3 words and ``text`` of normal(mean, sd) words clipped to
    [lo, hi], every word uniform over ``n_words``. Answers the calls the
    program makes of a ``PassageStore``: ``len``, ``[i]``, ``get_many``."""

    def __init__(self, n: int, n_words: int, seed: int, body: dict,
                 title_words: tuple = (1, 3)):
        self.n, self.n_words, self.seed = int(n), int(n_words), int(seed)
        self.mean, self.sd = float(body["mean"]), float(body["sd"])
        self.lo, self.hi = int(body["min"]), int(body["max"])
        self.title_words = title_words

    def __len__(self) -> int:
        return self.n

    def _draw(self, i: int):
        """(the passage's generator, title words, body words)."""
        rng = np.random.default_rng([self.seed, int(i)])
        body = int(np.clip(np.rint(rng.normal(self.mean, self.sd)),
                           self.lo, self.hi))
        title = int(rng.integers(self.title_words[0],
                                 self.title_words[1] + 1))
        return rng, title, body

    def length(self, i: int) -> tuple[int, int]:
        """(title words, body words) of passage ``i``."""
        return self._draw(i)[1:]

    def __getitem__(self, i: int) -> dict:
        i = int(i)
        if not 0 <= i < self.n:
            raise IndexError(i)
        rng, title, body = self._draw(i)
        w = rng.integers(0, self.n_words, title + body)
        return {"id": str(i), "title": words(w[:title]),
                "text": words(w[title:])}

    def get_many(self, ids) -> list[dict]:
        return [self[i] for i in ids]


def qa_pair(seed: int, step: int, row: int, n_words: int,
            question: tuple, answer: tuple) -> tuple[str, str]:
    """An NQ-like (question, answer) of ``question`` = (min, max) and
    ``answer`` = (min, max) words, fresh for every (step, row)."""
    rng = np.random.default_rng([int(seed), int(step), int(row)])
    nq = int(rng.integers(question[0], question[1] + 1))
    na = int(rng.integers(answer[0], answer[1] + 1))
    w = rng.integers(0, n_words, nq + na)
    return words(w[:nq]), words(w[nq:])


def word_vocab(n_words: int, extra=()) -> dict[str, int]:
    """``w<i>`` -> 6 + i, then each further word of ``extra`` (a word ->
    id mapping or a sequence of words) after them."""
    vocab = {f"w{i}": N_SPECIAL + i for i in range(n_words)}
    if isinstance(extra, dict):
        vocab.update(extra)
        return vocab
    for w in extra:
        if w not in vocab:
            vocab[w] = N_SPECIAL + len(vocab)
    return vocab


# ----------------------------------------------------------------- weights
def _flat_normal(shapes, std: float, seed: int, device, dtype):
    """One N(0, std) buffer for every shape, drawn in one call, cut into
    views in order."""
    sizes = [int(np.prod(s)) for s in shapes]
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(sum(sizes), dtype=dtype, device=device)
    buf.normal_(0.0, std, generator=g)
    out, at = [], 0
    for s, n in zip(shapes, sizes):
        out.append(buf[at:at + n].view(*s))
        at += n
    return out


def lm_shapes(c: dict) -> list[tuple[str, tuple]]:
    """(leaf path, shape) of every N(0, 0.02) matrix of a llama-family
    generator, in the order they are drawn."""
    h, hd = c["hidden_size"], c["head_dim"]
    nh, nkv, f = (c["num_attention_heads"], c["num_key_value_heads"],
                  c["intermediate_size"])
    out = [("embed", (c["vocab_size"], h))]
    for i in range(c["num_hidden_layers"]):
        out += [(f"layers.{i}.q_w", (h, nh * hd)),
                (f"layers.{i}.k_w", (h, nkv * hd)),
                (f"layers.{i}.v_w", (h, nkv * hd)),
                (f"layers.{i}.o_w", (nh * hd, h)),
                (f"layers.{i}.gate_w", (h, f)),
                (f"layers.{i}.up_w", (h, f)),
                (f"layers.{i}.down_w", (f, h))]
    out.append(("lm_head", (h, c["vocab_size"])))
    return out


def lm_weights(c: dict, seed: int, device, dtype) -> dict:
    """The generator's weights in the tree the port's ``models/lm.py``
    reads (``embed``, ``layers[i].{attn_norm, q_w, ...}``, ``final_norm``,
    ``lm_head``): matrices N(0, 0.02) in ``dtype``, norm scales ones."""
    shapes = lm_shapes(c)
    mats = dict(zip([p for p, _ in shapes],
                    _flat_normal([s for _, s in shapes], 0.02, seed, device,
                                 dtype)))
    h = c["hidden_size"]

    def ones():
        return torch.ones((h,), dtype=dtype, device=device)

    layers = []
    for i in range(c["num_hidden_layers"]):
        layer = {k.split(".")[2]: v for k, v in mats.items()
                 if k.startswith(f"layers.{i}.")}
        layer.update(attn_norm=ones(), mlp_norm=ones())
        layers.append(layer)
    return {"embed": mats["embed"], "layers": layers, "final_norm": ones(),
            "lm_head": mats["lm_head"]}


def lora_weights(c: dict, rank: int, seed: int, device) -> dict:
    """LoRA adapters of every target matrix of every layer, f32: A (in, r)
    ~ 0.01 N(0, 1), B (r, out) = 0, in the port's tree
    (``{"layers": [{name: {"A", "B"}}]}``); each leaf its own tensor, as
    trained leaves must be."""
    shapes = [(p, s) for p, s in lm_shapes(c) if p.startswith("layers.")]
    a = _flat_normal([(s[0], rank) for _, s in shapes], 0.01, seed, device,
                     torch.float32)
    layers = [{} for _ in range(c["num_hidden_layers"])]
    for (p, s), a_i in zip(shapes, a):
        _, i, name = p.split(".")
        layers[int(i)][name] = {
            "A": a_i.clone(), "B": torch.zeros((rank, s[1]), dtype=torch.float32,
                                       device=device)}
    return {"layers": layers}


def bert_shapes(c: dict) -> list[tuple[str, tuple]]:
    """(name, shape, init) of every leaf of a BERT tower, by the port's
    state-dict names, in the order the N(0, 0.02) matrices are drawn."""
    h, f = c["hidden_size"], c["intermediate_size"]
    out = [("embed.word", (c["vocab_size"], h), "normal"),
           ("embed.position", (c["max_position_embeddings"], h), "normal"),
           ("embed.type", (c["type_vocab_size"], h), "normal"),
           ("embed.ln_scale", (h,), "ones"), ("embed.ln_bias", (h,), "zeros")]
    for i in range(c["num_hidden_layers"]):
        p = f"layers.{i}."
        for n in ("q", "k", "v", "o"):
            out += [(p + f"{n}_w", (h, h), "normal"),
                    (p + f"{n}_b", (h,), "zeros")]
        out += [(p + "attn_ln_scale", (h,), "ones"),
                (p + "attn_ln_bias", (h,), "zeros"),
                (p + "ffn_in_w", (h, f), "normal"),
                (p + "ffn_in_b", (f,), "zeros"),
                (p + "ffn_out_w", (f, h), "normal"),
                (p + "ffn_out_b", (h,), "zeros"),
                (p + "ffn_ln_scale", (h,), "ones"),
                (p + "ffn_ln_bias", (h,), "zeros")]
    return out


def bert_weights(c: dict, seed: int, device, dtype=torch.float32) -> dict:
    """One BERT tower's leaves by name: matrices N(0, 0.02) in one draw,
    LayerNorm scales ones, biases zero."""
    spec = bert_shapes(c)
    mats = iter(_flat_normal([s for _, s, i in spec if i == "normal"], 0.02,
                             seed, device, dtype))
    out = {}
    for name, shape, init in spec:
        if init == "normal":
            out[name] = next(mats)
        else:
            fill = torch.ones if init == "ones" else torch.zeros
            out[name] = fill(shape, dtype=dtype, device=device)
    return out


# --------------------------------------------------------------- index rows
def unit_rows(seed: int, n: int, d: int, device, chunk: int = CHUNK):
    """Yield (start, (rows, d) f32 unit rows) over ``n`` rows, ``chunk`` at
    a time, from one generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, n, chunk):
        x = torch.randn((min(chunk, n - lo), d), generator=g, device=device)
        yield lo, x / x.norm(dim=1, keepdim=True)


def unit_queries(seed: int, rows: int, d: int, device) -> torch.Tensor:
    """(rows, d) f32 unit query embeddings."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((rows, d), generator=g, device=device)
    return x / x.norm(dim=1, keepdim=True)
