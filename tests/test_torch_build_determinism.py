"""The index build numbers a growable vocabulary the same way every run.

``index/build.py::build_index`` tokenises its windows on a background
thread while the card embeds the previous one. With the SimpleTokenizer
(a word gets the next id when first met) the windows must be tokenised in
corpus order, or two runs of the same build give the same words other ids,
and so other embeddings, retrievals and losses."""

import numpy as np
import torch

from jsa_rag_tpu_torch.data.passages import PassageStore
from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer
from jsa_rag_tpu_torch.index.build import build_index
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex

N, WORDS = 2000, 12  # every passage brings words no other passage has
VOCAB = N * (WORDS + 1) + 100  # its title and its words


def _build(store):
    tok = SimpleTokenizer(max_vocab=VOCAB)
    index = ShardedFlatIndex(len(store), 8, "float32", device="cpu")
    table = torch.randn((VOCAB, 8), generator=torch.Generator().manual_seed(0))

    def encode(ids, mask):  # a stand-in tower: the mean of id rows
        e = table[ids.long()] * mask[..., None]
        return e.sum(1) / mask.sum(1, keepdim=True).clamp_min(1)

    build_index(index, store, encode, tok, batch_size=64, max_length=48)
    return tok.vocab, index.embeddings.clone()


def test_repeated_builds_give_the_same_ids_and_rows():
    """Five builds of 2,000 passages, each with words of its own, in
    windows of 512 (the default prefetch and sort window): one vocabulary,
    in corpus order, and the same rows each time."""
    store = PassageStore(passages=[
        {"id": str(i), "title": f"t{i}",
         "text": " ".join(f"p{i}w{j}" for j in range(WORDS))}
        for i in range(N)])
    vocab, rows = _build(store)
    first_seen = []
    for i in range(len(store)):
        for w in f"{store[i]['title']} {store[i]['text']}".split():
            if w not in first_seen:
                first_seen.append(w)
    assert sorted(vocab, key=vocab.get) == first_seen
    for _ in range(4):
        v, r = _build(store)
        assert v == vocab
        np.testing.assert_array_equal(r.numpy(), rows.numpy())
