"""Contrastively pretrain the hard-copy demo's dual encoder (counterpart of
``scripts/pretrain_hard_encoder.py``).

The hard copy task gives questions and passages disjoint vocabularies
(``qw{i}`` against ``pw{i}``), so only an encoder that has learned the
word-form correspondence retrieves. This trains the 2-layer tied
``mean_norm`` BERT (hidden 256, 4 heads, intermediate 512) by symmetric
in-batch InfoNCE at temperature ``--tau`` on the train-topic (question,
gold passage) pairs, each batch one row of ``--batch`` distinct topics,
with AdamW at ``--lr`` and weight decay 0.01 as ``optax.adamw`` applies
them (a constant step size, eps 1e-8, no clip). It then reports recall@4
on the unseen dev topics by exact search over the whole corpus, beside the
0-layer bag-of-words encoder (random word embeddings), and writes the
artifact pickle (``bert``, ``vocab``, fp16 ``params`` in the JAX tree's key
names and (in, out) layouts, ``metrics``) to ``--out``::

    python -m jsa_rag_tpu_torch.demo.pretrain_hard_encoder \\
        --data data/hardcopy --out out/hard_encoder.pkl --steps 500

The recipe is ``--steps 500 --batch 256`` (the committed artifact's).
Random numbers: the weights from a ``torch.Generator`` seeded ``--seed``
(the bag-of-words encoder's ``--seed + 1``), the batches from numpy's
``default_rng(--seed)`` drawn as the JAX script draws them, so both pick the
same rows. The JAX script's ``--cpu`` is ``--device cpu`` here.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pickle
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Options
from ..convert import (numpy_float16, retriever_params_from_numpy,
                       retriever_params_to_numpy)
from ..data.tokenizer import SimpleTokenizer
from ..device import resolve_device
from ..models.bert import BertConfig
from ..models.retriever import DualEncoderRetriever, RetrieverConfig
from ..train.optim import AdamW
from . import passage_text, read_jsonl

QUESTION_LEN = 16
PASSAGE_LEN = 48
EMBED_BATCH = 512


def build_tokenizer(passages: list[dict], train: list[dict],
                    max_vocab: int = 8192) -> SimpleTokenizer:
    """The demo's shared vocabulary: every passage, then the first
    len(passages) train questions, then frozen (``:97-102``); the copy
    generator reads the same one."""
    tok = SimpleTokenizer(max_vocab=max_vocab)
    for p in passages:
        tok.encode(passage_text(p), PASSAGE_LEN)
    for r in train[:len(passages)]:
        tok.encode(r["question"], QUESTION_LEN)
    tok.frozen = True
    return tok


def encoder_config(vocab_size: int, layers: int = 2,
                   hidden: int = 256) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, hidden=hidden, layers=layers,
                      heads=4, intermediate=2 * hidden, max_positions=64,
                      pooling="mean_norm", dtype=torch.float32)


def make_retriever(bert: BertConfig, device, seed: int):
    """A tied retriever of ``bert``'s geometry, N(0, 0.02) from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return DualEncoderRetriever(RetrieverConfig(bert=bert, tied=True),
                                device=device, generator=g)


def topic_rows(gold: np.ndarray) -> tuple[dict, np.ndarray]:
    """{topic: its train rows} and the sorted topic ids."""
    rows: dict[int, list[int]] = {}
    for j, g in enumerate(gold):
        rows.setdefault(int(g), []).append(j)
    return rows, np.asarray(sorted(rows))


def sample_batch(rng: np.random.Generator, rows: dict, topic_ids,
                 batch: int) -> np.ndarray:
    """One train row of each of ``batch`` distinct topics (``:136-150``:
    a repeated topic would be a false in-batch negative), drawn from
    ``rng`` call for call as the JAX script draws them."""
    ts = rng.choice(topic_ids, batch, replace=False)
    return np.asarray([rows[int(t)][rng.integers(len(rows[int(t)]))]
                       for t in ts])


def infonce_loss(retriever, q_ids, q_mask, p_ids, p_mask,
                 tau: float) -> torch.Tensor:
    """Symmetric in-batch InfoNCE (``:120-131``): row i's gold passage is
    column i, every other column a negative, both directions averaged."""
    qe = retriever.embed_queries(q_ids, q_mask)
    pe = retriever.embed_passages(p_ids, p_mask)
    logits = (qe @ pe.T) / tau
    lbl = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, lbl) + F.cross_entropy(logits.T, lbl)) / 2


def adamw(retriever, lr: float, weight_decay: float,
          device: torch.device) -> AdamW:
    """``optax.adamw(lr, weight_decay=...)`` on the port's AdamW: eps 1e-8,
    no clip (an infinite bound never triggers), one group, and a constant
    step size from the first update (the loop's schedules start at 0)."""
    opt = Options(lr=lr, weight_decay=weight_decay, epsilon=1e-8,
                  clip=math.inf, separate_learning_rates=False,
                  device=device.type)
    tx = AdamW(opt, {"retriever": retriever})
    tx.schedules = dict.fromkeys(tx.schedules, lambda count: lr)
    return tx


def train_step(retriever, tx: AdamW, batch, tau: float) -> torch.Tensor:
    """One InfoNCE loss, its gradients and one AdamW update; -> the loss
    (on the device)."""
    loss = infonce_loss(retriever, *batch, tau)
    grads = torch.autograd.grad(loss, tx.leaves)
    tx.step(grads)
    return loss.detach()


@torch.no_grad()
def embed(retriever, ids, mask, *, passages: bool) -> torch.Tensor:
    fn = retriever.embed_passages if passages else retriever.embed_queries
    return torch.cat([fn(ids[i:i + EMBED_BATCH], mask[i:i + EMBED_BATCH])
                      for i in range(0, ids.shape[0], EMBED_BATCH)])


def recall_at_4(retriever, p_ids, p_mask, q_ids, q_mask, gold) -> float:
    """Share of questions whose gold passage is among the top 4 of an exact
    search over every passage (``:159-173``)."""
    pe = embed(retriever, p_ids, p_mask, passages=True)
    qe = embed(retriever, q_ids, q_mask, passages=False)
    top4 = torch.topk(qe @ pe.T, 4, dim=1).indices
    return float((top4 == gold[:, None]).any(dim=1).float().mean())


def save_artifact(path: str, retriever, tok: SimpleTokenizer,
                  metrics: dict) -> None:
    bert = retriever.cfg.bert
    art = {"bert": {k: v for k, v in dataclasses.asdict(bert).items()
                    if k != "dtype"},
           "vocab": tok.to_dict(),
           "params": numpy_float16(retriever_params_to_numpy(retriever)),
           "metrics": metrics}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(art, f)


def load_artifact(path: str, device="cuda"):
    """An encoder pickle (either package's) -> (tied f32
    ``DualEncoderRetriever`` on ``device``, ``SimpleTokenizer``)."""
    with open(path, "rb") as f:
        art = pickle.load(f)
    retriever = DualEncoderRetriever(
        RetrieverConfig(bert=BertConfig(**art["bert"]), tied=True),
        device=device)
    retriever.load_state_dict(retriever_params_from_numpy(art["params"]))
    return retriever.eval(), SimpleTokenizer.from_dict(art["vocab"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="make_copy_task_data.py --hard's directory")
    ap.add_argument("--out", required=True, help="the artifact pickle")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, evaluate and save; -> the artifact's metrics plus the
    ``losses`` of the logged steps (every 200th and the last) and the
    training ``seconds``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    passages = read_jsonl(os.path.join(args.data, "passages.jsonl"))
    train = read_jsonl(os.path.join(args.data, "train.jsonl"))
    dev_rows = read_jsonl(os.path.join(args.data, "dev.jsonl"))
    tok = build_tokenizer(passages, train)
    bert = encoder_config(tok.vocab_size, args.layers, args.hidden)
    retriever = make_retriever(bert, dev, args.seed)

    def on_device(ids_mask):
        return tuple(torch.from_numpy(a).to(dev) for a in ids_mask)

    q_ids, q_mask = on_device(tok.encode_batch(
        [r["question"] for r in train], QUESTION_LEN))
    p_ids, p_mask = on_device(tok.encode_batch(
        [passage_text(p) for p in passages], PASSAGE_LEN))
    gold = np.asarray([int(r["passages"][0]["id"]) for r in train])
    rows, topic_ids = topic_rows(gold)
    tx = adamw(retriever, args.lr, 0.01, dev)
    rng = np.random.default_rng(args.seed)
    losses = []
    t0 = time.perf_counter()
    for s in range(args.steps):
        b = sample_batch(rng, rows, topic_ids, args.batch)
        bi = torch.from_numpy(b).to(dev)
        gi = torch.from_numpy(gold[b]).to(dev)
        loss = train_step(retriever, tx,
                          (q_ids[bi], q_mask[bi], p_ids[gi], p_mask[gi]),
                          args.tau)
        if s % 200 == 0 or s == args.steps - 1:
            losses.append((s, float(loss)))
            print(f"step {s:5d} loss {losses[-1][1]:.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    seconds = time.perf_counter() - t0

    dq_ids, dq_mask = on_device(tok.encode_batch(
        [r["question"] for r in dev_rows], QUESTION_LEN))
    dev_gold = torch.tensor([int(r["passages"][0]["id"]) for r in dev_rows],
                            device=dev)
    r4 = recall_at_4(retriever, p_ids, p_mask, dq_ids, dq_mask, dev_gold)
    bow = make_retriever(dataclasses.replace(bert, layers=0), dev,
                         args.seed + 1)
    bow_r4 = recall_at_4(bow, p_ids, p_mask, dq_ids, dq_mask, dev_gold)
    print(f"recall@4 unseen topics: pretrained {r4:.3f} | 0-layer BoW "
          f"{bow_r4:.3f} | chance {4 / len(passages):.4f}", flush=True)
    metrics = {"recall@4_unseen": r4, "recall@4_bow": bow_r4,
               "steps": args.steps,
               "final_loss": losses[-1][1] if losses else float("nan")}
    save_artifact(args.out, retriever, tok, metrics)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB, "
          "fp16)", flush=True)
    return {**metrics, "losses": losses, "seconds": seconds}


if __name__ == "__main__":
    main()
