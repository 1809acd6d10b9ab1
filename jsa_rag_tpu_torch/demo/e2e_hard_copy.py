"""The joint rag fine-tune of the hard-copy demo (counterpart of
``docs/demo/e2e_hard_copy_task.py``): a pretrained encoder and a
copy-pretrained generator, an f32 flat index searched by kernel B3
(``method="pallas2"``), exact match, F1 and retrieval recall on the unseen
dev topics before joint training (zero shot) and after ``--steps`` rag
steps with the index rebuilt on the ``--refresh_index`` schedule::

    python -m jsa_rag_tpu_torch.demo.e2e_hard_copy --data data/hardcopy \\
        --out out/metrics-e2e-hard.jsonl --checkpoint_dir out/ck

The demo's options (``:57-69``): rag scoring, fast_deocde1, 4 passages,
text 96 / target 8 / 4 generated tokens, batch 16, lr 1e-7 for the
generator and 2e-4 for the retriever, a fixed schedule with warmup 30, no
weight decay, refresh ``0-700:150`` over 400 steps. ``--encoder`` and
``--generator`` default to the committed artifacts (the JAX package
trained them); the port's own are the other modules of ``demo/``. The two
metric lines (``{"phase", "exact_match", "f1", "retrieval_recall"}``) go
to ``--out``; the loop's log to ``<--checkpoint_dir>/e2e-hard``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..config import Options
from ..data.passages import PassageStore, load_passages_jsonl
from ..device import resolve_device
from ..evaluation import evaluate
from ..index.flat import ShardedFlatIndex
from ..train.loop import train
from ..train.optim import set_optim
from ..train.rag_model import RAGModel
from .pretrain_copy_generator import load_generator, metric_losses
from .pretrain_hard_encoder import load_artifact

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "docs",
                         "demo", "artifacts")
METRICS = ("exact_match", "f1", "retrieval_recall")


def rag_options(data: str, *, steps: int, refresh_index: str, seed: int,
                device: str, checkpoint_dir: str) -> Options:
    return Options(task="qa", gold_score_mode="rag",
                   gen_method="fast_deocde1", qa_prompt_format="{question}",
                   train_data=[os.path.join(data, "train.jsonl")],
                   eval_data=[os.path.join(data, "dev.jsonl")],
                   n_context=4, text_maxlength=96, target_maxlength=8,
                   generation_max_length=4, per_gpu_batch_size=16,
                   per_gpu_embedder_batch_size=256, lr=1e-7,
                   lr_retriever=2e-4, weight_decay=0.0, scheduler="fixed",
                   warmup_steps=30, total_steps=steps, log_freq=100,
                   eval_freq=10 ** 9, save_freq=10 ** 9,
                   refresh_index=refresh_index, use_lora=False,
                   precision="fp32", temperature_gold=1.0, seed=seed,
                   checkpoint_dir=checkpoint_dir, name="e2e-hard",
                   device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--encoder",
                    default=os.path.join(ARTIFACTS, "hard_encoder.pkl"))
    ap.add_argument("--generator",
                    default=os.path.join(ARTIFACTS, "hard_generator.pkl"))
    ap.add_argument("--out", required=True,
                    help="the two metric lines (jsonl)")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--refresh_index", default="0-700:150")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"zero_shot": metrics, "after": metrics, "losses": the loop's
    logged (step, loss), "seconds": training wall seconds}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    retriever, _ = load_artifact(args.encoder, dev)
    lm_cfg, gen, tok = load_generator(args.generator, dev)
    params = {"retriever": retriever, "generator": gen}
    opt = rag_options(args.data, steps=args.steps,
                      refresh_index=args.refresh_index, seed=args.seed,
                      device=dev.type, checkpoint_dir=args.checkpoint_dir)
    store = PassageStore(passages=load_passages_jsonl(
        os.path.join(args.data, "passages.jsonl")))
    model = RAGModel(opt, retriever, lm_cfg, tok, tok, store)
    index = ShardedFlatIndex(len(store), retriever.cfg.bert.hidden,
                             "float32", device=dev, method="pallas2")
    return zero_shot_then_joint(model, index, params, opt, args.out)


def zero_shot_then_joint(model, index, params, opt, out: str) -> dict:
    """Build the index, evaluate on ``opt.eval_data[0]`` (zero shot), train
    ``opt.total_steps`` steps, evaluate again; write the two metric lines
    to ``out``. -> {"zero_shot", "after", "losses", "steps", "seconds"}."""
    dev_path = opt.eval_data[0]
    model.build_index(index, params)
    m0 = evaluate(model, index, params, opt, dev_path)
    print("zero shot:", {k: round(m0[k], 3) for k in METRICS}, flush=True)
    t0 = time.perf_counter()
    step = train(model, index, params, set_optim(opt, params), opt)
    seconds = time.perf_counter() - t0
    m1 = evaluate(model, index, params, opt, dev_path)
    print(f"after {step} joint steps:",
          {k: round(m1[k], 3) for k in METRICS}, flush=True)

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        for phase, m in (("zero_shot", m0), (f"after_joint_{step}", m1)):
            f.write(json.dumps({"phase": phase,
                                **{k: m[k] for k in METRICS}}) + "\n")
    return {"zero_shot": {k: m0[k] for k in METRICS},
            "after": {k: m1[k] for k in METRICS},
            "losses": metric_losses(os.path.join(
                opt.checkpoint_dir, opt.name, "metrics.jsonl")),
            "steps": step, "seconds": seconds}


if __name__ == "__main__":
    main()
