"""The unseen-topic copy task end to end (counterpart of
``docs/demo/e2e_copy_task.py``): the copy-pretrained generator
(``demo/copy_task.py``) and a 0-layer bag-of-words retriever over an f32
flat index of every passage, searched by kernel B3 (``method="pallas2"``);
exact match, F1 and retrieval recall on the unseen dev topics before joint
training (zero shot) and after ``--steps`` rag steps::

    python -m jsa_rag_tpu_torch.demo.e2e_copy --data data/copy \\
        --generator out/ck/copy-generator --checkpoint_dir out/ck \\
        --out out/metrics-e2e-copy.jsonl

The script's options (``:34-45``): rag scoring, fast_deocde1, 4 passages,
text 96 / target 8 / 4 generated tokens, batch 16, lr 1e-7 for the
generator and 2e-4 for the retriever, a fixed schedule with warmup 30, no
weight decay, the index rebuilt on ``0-700:150``, no evaluation inside the
loop. The two metric lines (``{"phase", "exact_match", "f1",
"retrieval_recall"}``) go to ``--out``; the loop's log to
``<--checkpoint_dir>/e2e``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from ..data.passages import PassageStore, load_passages_jsonl
from ..device import resolve_device
from ..index.flat import ShardedFlatIndex
from ..train.rag_model import RAGModel
from .copy_task import bow_retriever, load_generator_checkpoint
from .e2e_hard_copy import rag_options, zero_shot_then_joint


def setup(data: str, generator: str, *, steps: int, seed: int, device: str,
          checkpoint_dir: str, retriever=None):
    """-> (model, index (empty), params, opt). ``retriever``: the tied
    bag-of-words retriever, else drawn from ``seed``."""
    dev = resolve_device(device)
    lm_cfg, gen, tok = load_generator_checkpoint(generator, dev)
    if retriever is None:
        retriever = bow_retriever(tok.vocab_size, tied=True, seed=seed,
                                  device=dev)
    opt = dataclasses.replace(
        rag_options(data, steps=steps, refresh_index="0-700:150", seed=seed,
                    device=dev.type, checkpoint_dir=checkpoint_dir),
        name="e2e", eval_freq=300, save_freq=10_000)
    store = PassageStore(passages=load_passages_jsonl(
        os.path.join(data, "passages.jsonl")))
    model = RAGModel(opt, retriever, lm_cfg, tok, tok, store)
    index = ShardedFlatIndex(len(store), retriever.cfg.bert.hidden,
                             "float32", device=dev, method="pallas2")
    return model, index, {"retriever": retriever, "generator": gen}, opt


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--generator", required=True,
                    help="the copy generator's run or step directory")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--out", required=True,
                    help="the two metric lines (jsonl)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"zero_shot": metrics, "after": metrics, "losses": the loop's
    logged (step, loss), "steps", "seconds": training wall seconds}."""
    args = parse_args(argv)
    model, index, params, opt = setup(
        args.data, args.generator, steps=args.steps, seed=args.seed,
        device=args.device, checkpoint_dir=args.checkpoint_dir)
    return zero_shot_then_joint(model, index, params, opt, args.out)


if __name__ == "__main__":
    main()
