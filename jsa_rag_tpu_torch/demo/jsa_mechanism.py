"""The JSA mechanism probe (counterpart of
``docs/demo/jsa_mechanism_demo.py``): can the posterior retriever, which
sees the answer, guide a random prior query tower to the gold passages?

The copy task's towers (``copy_task.mechanism_towers``): untied 0-layer
bag-of-words towers; the passage tower (the index's) and the decoupled
posterior query tower start from the same embeddings, so the posterior,
whose query holds the answer code, retrieves the gold passage; the prior
query tower starts from other random embeddings, so the prior retrieves
near chance. The copy-pretrained generator (``demo/copy_task.py``) stays
at lr 1e-7. Then ``--steps`` jsa steps with ``decouple_encoder`` and
``query_side_retriever_training`` (the query towers train at lr 1e-3, the
passage tower and the index built from it stay fixed): the MIS chain
samples the candidates the posterior and the generator prefer, and the
prior's loss pulls its query tower toward them::

    python -m jsa_rag_tpu_torch.demo.jsa_mechanism --data data/copy \\
        --generator out/ck/copy-generator --checkpoint_dir out/ck \\
        --out out/metrics-jsa-mechanism.jsonl

The script's options (``:88-105``): mis_step 8, ``use_all_mis``,
``temperature_jsa`` 0.1, 4 passages, batch 16, a fixed schedule with warmup
30, no refresh (``refresh_index "-1"``). Measured: the prior's recall@4 of
each dev question's gold passage over the whole corpus
(``prior_gold_recall``, the first 100 dev questions) before and after, and
the loop's logged accept rates and losses. The JAX package recorded 0.00
before and after 2,500 steps, the accept rate falling 0.90 -> 0.77 and the
loss falling (``docs/BENCHMARKS.md``): joint training fine-tunes a
pretrained retriever and does not replace contrastive pretraining. One JSON
line goes to ``--out``; the loop's log to ``<--checkpoint_dir>/jsa-mech``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..config import Options
from ..data.passages import PassageStore, load_passages_jsonl
from ..device import resolve_device
from ..index.flat import ShardedFlatIndex
from ..train.loop import train
from ..train.optim import set_optim
from ..train.rag_model import RAGModel
from . import read_jsonl
from .copy_task import load_generator_checkpoint, mechanism_towers

N_DEV = 100


def jsa_options(data: str, *, steps: int, seed: int, device: str,
                checkpoint_dir: str) -> Options:
    """The script's ``Options`` (``:88-105``)."""
    return Options(task="qa", gold_score_mode="jsa",
                   gen_method="fast_deocde1", qa_prompt_format="{question}",
                   decouple_encoder=True,
                   query_side_retriever_training=True,
                   train_data=[os.path.join(data, "train.jsonl")],
                   eval_data=[os.path.join(data, "dev.jsonl")],
                   n_context=4, mis_step=8, use_all_mis=True,
                   temperature_jsa=0.1, temperature_gold=1.0,
                   text_maxlength=96, target_maxlength=8,
                   generation_max_length=4, per_gpu_batch_size=16,
                   per_gpu_embedder_batch_size=256, lr=1e-7,
                   lr_retriever=1e-3, weight_decay=0.0, scheduler="fixed",
                   warmup_steps=30, total_steps=steps, log_freq=100,
                   eval_freq=10_000, save_freq=10_000, refresh_index="-1",
                   use_lora=False, precision="fp32", seed=seed,
                   checkpoint_dir=checkpoint_dir, name="jsa-mech",
                   device=device)


def prior_gold_recall(model, index, params, dev: list, code2id: dict,
                      k: int = 4) -> float:
    """Share of ``dev`` questions whose gold passage (the passage holding
    the answer code, ``code2id``) is in the prior's top ``k``
    (``jsa_mechanism_demo.py:57-66``)."""
    q = model.embed_queries(params, [d["question"] for d in dev])
    _, ids = index.search(q, k)
    ids = np.asarray(ids.cpu())
    return float(np.mean([code2id[d["answers"][0]] in ids[i].tolist()
                          for i, d in enumerate(dev)]))


def setup(data: str, generator: str, *, steps: int, seed: int, device: str,
          checkpoint_dir: str, towers=None):
    """-> (model, index (built), params, opt, dev questions, code2id).
    ``towers``: (prior, posterior) as ``mechanism_towers`` makes them,
    else drawn from ``seed``."""
    dev = resolve_device(device)
    lm_cfg, gen, tok = load_generator_checkpoint(generator, dev)
    prior, post = towers or mechanism_towers(tok.vocab_size, seed, dev)
    params = {"retriever": prior, "post_retriever": post, "generator": gen}
    opt = jsa_options(data, steps=steps, seed=seed, device=dev.type,
                      checkpoint_dir=checkpoint_dir)
    passages = read_jsonl(os.path.join(data, "passages.jsonl"))
    code2id = {p["text"].split()[-1]: int(p["id"]) for p in passages}
    store = PassageStore(passages=load_passages_jsonl(
        os.path.join(data, "passages.jsonl")))
    model = RAGModel(opt, prior, lm_cfg, tok, tok, store)
    index = ShardedFlatIndex(len(store), prior.cfg.bert.hidden, "float32",
                             device=dev, method="pallas2")
    model.build_index(index, params)
    questions = read_jsonl(os.path.join(data, "dev.jsonl"))[:N_DEV]
    return model, index, params, opt, questions, code2id


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--generator", required=True,
                    help="the copy generator's run or step directory")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--out", required=True, help="one JSON line")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"recall@4_before", "recall@4_after", "accept_rates", "losses"
    (the loop's logged (step, value)), "steps", "seconds"}."""
    args = parse_args(argv)
    model, index, params, opt, questions, code2id = setup(
        args.data, args.generator, steps=args.steps, seed=args.seed,
        device=args.device, checkpoint_dir=args.checkpoint_dir)
    r0 = prior_gold_recall(model, index, params, questions, code2id)
    print(f"prior gold recall@4 before: {r0:.2f}", flush=True)
    t0 = time.perf_counter()
    step = train(model, index, params, set_optim(opt, params), opt)
    seconds = time.perf_counter() - t0
    # the index holds the passage tower's rows, which did not train: only
    # the prior's query tower moved, so no rebuild
    r1 = prior_gold_recall(model, index, params, questions, code2id)
    print(f"prior gold recall@4 after {step} jsa steps: {r1:.2f}",
          flush=True)
    with open(os.path.join(args.checkpoint_dir, opt.name,
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    result = {"recall@4_before": r0, "recall@4_after": r1,
              "accept_rates": [(r["step"], r["accept_rate"]) for r in rows
                               if "accept_rate" in r],
              "losses": [(r["step"], r["loss/train_loss"]) for r in rows
                         if "loss/train_loss" in r],
              "steps": step, "seconds": seconds}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(json.dumps(result) + "\n")
    return result


if __name__ == "__main__":
    main()
