"""Faults planted underneath a run, to show that ``correct`` catches them
(the tests at a toy size on the CPU, ``controls.py`` at the cells' sizes on
the card). Each is a context manager that patches the program while it is
open; none is used by a benchmark run.

- ``state_unchanged``: the update or the write returns its state as it was;
- ``half_batch``: the first half of the batch is left out and its place
  is filled with the mean of the rest (a search: with the rest's answers);
- ``answer_altered``: one token or one answer is changed where it is
  produced;
- ``chain_altered``: the jsa chain keeps its first draw, whatever the
  acceptance tests said (its samples altered where they are produced).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _half(x: torch.Tensor) -> torch.Tensor:
    """The first half of the rows replaced by the mean of the rest."""
    h = x.shape[0] // 2
    if h < 1:
        return x
    fill = x[h:].mean(dim=0, keepdim=True).expand(h, *x.shape[1:])
    return torch.cat([fill.to(x.dtype), x[h:]])


# ------------------------------------------------------------------ training
def train(kind: str):
    from jsa_rag_tpu_torch.train import modes, optim, rag_model

    if kind == "state_unchanged":
        return patched(optim.AdamW, "step", lambda self, grads: True)
    if kind == "half_batch":
        real = modes._per_row_ce

        def half_ce(fns, params, gen_ids, gen_labels, gen_mask, rng=None):
            h = gen_ids.shape[0] // 2
            ce = real(fns, params, gen_ids[h:], gen_labels[h:], gen_mask[h:],
                      rng)
            return torch.cat([ce.mean().expand(h), ce])
        return patched(modes, "_per_row_ce", half_ce)
    if kind == "answer_altered":
        real = rag_model.build_training_batch

        def altered(tokenizer, queries, passages, targets, cfg):
            ids, labels, mask = real(tokenizer, queries, passages, targets,
                                     cfg)
            pos = int((labels[0] != -100).argmax())
            new = (int(ids[0, pos]) + 1) % tokenizer.vocab_size
            ids[0, pos] = labels[0, pos] = new
            return ids, labels, mask
        return patched(rag_model, "build_training_batch", altered)
    if kind == "chain_altered":
        real_chain = modes.mis_chain

        def first_draw(post, prior, log_lm, proposals, uniforms, **kw):
            sampled, rate, info = real_chain(post, prior, log_lm, proposals,
                                             uniforms, **kw)
            return sampled[:1].expand_as(sampled).clone(), rate, info
        return patched(modes, "mis_chain", first_draw)
    raise ValueError(kind)


# -------------------------------------------------------------------- search
def search(kind: str):
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex

    real = ShardedFlatIndex.search
    if kind == "half_batch":
        def half(self, queries, k):
            h = queries.shape[0] // 2
            s, i = real(self, queries[h:], k)
            return torch.cat([s[:h], s]), torch.cat([i[:h], i])
        return patched(ShardedFlatIndex, "search", half)
    if kind == "answer_altered":
        def altered(self, queries, k):
            s, i = real(self, queries, k)
            i = i.clone()
            i[0, 0] = (i[0, 0] + 1) % self.n_passages
            return s, i
        return patched(ShardedFlatIndex, "search", altered)
    raise ValueError(kind)


# ------------------------------------------------------------------- rebuild
def rebuild(kind: str):
    from jsa_rag_tpu_torch.index import build
    from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex

    if kind == "state_unchanged":
        real_set = ShardedFlatIndex.set_embeddings

        def keep(self, start, block):
            # the set-up's fill of the index still writes; the rebuild's
            # writes (blocks of a build window) are dropped
            if block.shape[0] < 65_536 and getattr(self, "_filled", False):
                return None
            out = real_set(self, start, block)
            if start + block.shape[0] >= self.n_passages:
                self._filled = True
            return out
        return patched(ShardedFlatIndex, "set_embeddings", keep)
    real = build.make_encode_fn

    def wrap(retriever):
        enc = real(retriever)
        if kind == "half_batch":
            return lambda ids, mask: _half(enc(ids, mask))
        if kind == "answer_altered":
            def altered(ids, mask):
                e = enc(ids, mask).clone()
                e[0] = -e[0]
                return e
            return altered
        raise ValueError(kind)
    return patched(build, "make_encode_fn", wrap)


# by driver: the faults each kind of cell can have (one chip: no exchange
# between chips to leave out)
FAULTS = {"train_jsa": (train, ("state_unchanged", "half_batch",
                                "answer_altered", "chain_altered")),
          "search": (search, ("half_batch", "answer_altered")),
          "rebuild": (rebuild, ("state_unchanged", "half_batch",
                                "answer_altered"))}
