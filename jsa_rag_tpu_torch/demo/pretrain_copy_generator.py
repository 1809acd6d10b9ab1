"""Copy-pretrain the hard-copy demo's generator (counterpart of
``scripts/pretrain_copy_generator.py``).

A llama generator (hidden 256, 4 layers, 8 heads, 4 kv heads, intermediate
512) over the encoder artifact's vocabulary, initialised from ``--seed``,
trained through the port's own loop (``train/loop.py::train``) in concat
mode with the gold passage supplied per row (``use_file_passages``): one
passage, text 96 / target 8 tokens, lr ``--lr`` with a cosine schedule
(warmup 50), no weight decay, the retriever untouched (lr_retriever 0).
It trains on ``gen_pretrain.jsonl`` when the data directory has it (the
code resampled per example, so only copying lowers the loss), else on
``train.jsonl``; then reports exact match with the gold passage on the
unseen dev topics and writes the artifact pickle (``lm``, ``vocab``, fp16
``params``, ``metrics``) to ``--out``::

    python -m jsa_rag_tpu_torch.demo.pretrain_copy_generator \\
        --data data/hardcopy --encoder out/hard_encoder.pkl \\
        --out out/hard_generator.pkl --steps 2500 --checkpoint_dir out/ck

The recipe is ``--steps 2500`` (the committed artifact's; the JAX script's
default is 1200). The loop's metrics log goes to
``<--checkpoint_dir>/copygen/metrics.jsonl``; the retriever exports the
loop would write every 500 steps are off (``save_build_retriever_step``
0), since the retriever does not train here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import time

import torch

from ..config import Options
from ..convert import lm_params_from_numpy, lm_params_to_numpy, numpy_float16
from ..data.passages import PassageStore, load_passages_jsonl
from ..data.tokenizer import SimpleTokenizer
from ..device import resolve_device
from ..evaluation import evaluate
from ..models.lm import LMConfig, lm_init
from ..train.loop import train
from ..train.optim import set_optim
from ..train.rag_model import RAGModel
from .pretrain_hard_encoder import load_artifact

GEOMETRY = dict(hidden=256, layers=4, heads=8, kv_heads=4, intermediate=512)


def generator_config(vocab_size: int) -> LMConfig:
    return LMConfig(vocab_size=vocab_size, dtype=torch.float32, **GEOMETRY)


def copy_options(data: str, train_file: str, *, steps: int, batch: int,
                 lr: float, seed: int, device: str,
                 checkpoint_dir: str) -> Options:
    """The script's ``Options`` (``:91-106``)."""
    return Options(task="qa", gold_score_mode="concat",
                   use_file_passages=True, qa_prompt_format="{question}",
                   train_data=[train_file],
                   eval_data=[os.path.join(data, "dev.jsonl")],
                   n_context=1, text_maxlength=96, target_maxlength=8,
                   generation_max_length=4, per_gpu_batch_size=batch,
                   per_gpu_embedder_batch_size=256, lr=lr, lr_retriever=0.0,
                   weight_decay=0.0, scheduler="cosine", warmup_steps=50,
                   total_steps=steps, log_freq=100, eval_freq=10 ** 9,
                   save_freq=10 ** 9, save_build_retriever_step=0,
                   use_lora=False, precision="fp32", seed=seed,
                   checkpoint_dir=checkpoint_dir, name="copygen",
                   device=device)


def save_generator(path: str, cfg: LMConfig, params: dict,
                   tok: SimpleTokenizer, metrics: dict) -> None:
    art = {"lm": {k: v for k, v in dataclasses.asdict(cfg).items()
                  if k != "dtype"},
           "vocab": tok.to_dict(),
           "params": numpy_float16(lm_params_to_numpy(params)),
           "metrics": metrics}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(art, f)


def load_generator(path: str, device="cuda"):
    """A generator pickle (either package's) -> (``LMConfig`` at f32, f32
    params on ``device``, ``SimpleTokenizer``)."""
    with open(path, "rb") as f:
        art = pickle.load(f)
    return (LMConfig(dtype=torch.float32, **art["lm"]),
            lm_params_from_numpy(art["params"], device),
            SimpleTokenizer.from_dict(art["vocab"]))


def metric_losses(path: str) -> list:
    """(step, train loss) of every line of a loop's metrics.jsonl."""
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["loss/train_loss"]) for r in rows
            if "loss/train_loss" in r]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--train_file", default=None,
                    help="default: gen_pretrain.jsonl if the data has it, "
                    "else train.jsonl")
    ap.add_argument("--encoder", required=True,
                    help="the encoder artifact (its tokenizer is shared)")
    ap.add_argument("--out", required=True, help="the artifact pickle")
    ap.add_argument("--checkpoint_dir", required=True,
                    help="where the loop writes copygen/metrics.jsonl")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train, evaluate and save; -> the artifact's metrics plus the logged
    ``losses`` and the training ``seconds``."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    retriever, tok = load_artifact(args.encoder, dev)
    cfg = generator_config(tok.vocab_size)
    gen = lm_init(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(args.seed))
    params = {"retriever": retriever, "generator": gen}
    train_file = args.train_file or os.path.join(args.data,
                                                 "gen_pretrain.jsonl")
    if not os.path.exists(train_file):
        train_file = os.path.join(args.data, "train.jsonl")
    print(f"pretraining on {train_file}", flush=True)
    opt = copy_options(args.data, train_file, steps=args.steps,
                       batch=args.batch, lr=args.lr, seed=args.seed,
                       device=dev.type, checkpoint_dir=args.checkpoint_dir)
    store = PassageStore(passages=load_passages_jsonl(
        os.path.join(args.data, "passages.jsonl")))
    model = RAGModel(opt, retriever, cfg, tok, tok, store)
    tx = set_optim(opt, params)
    t0 = time.perf_counter()
    # concat over the supplied gold passage never searches: no index
    step = train(model, None, params, tx, opt)
    seconds = time.perf_counter() - t0
    m = evaluate(model, None, params, opt,
                 os.path.join(args.data, "dev.jsonl"))
    print("eval with gold:", {k: round(v, 3) for k, v in m.items()
                              if k in ("exact_match", "f1")}, flush=True)
    metrics = {"em_with_gold_unseen": m.get("exact_match"), "steps": step}
    save_generator(args.out, cfg, gen, tok, metrics)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)",
          flush=True)
    losses = metric_losses(os.path.join(args.checkpoint_dir, opt.name,
                                        "metrics.jsonl"))
    return {**metrics, "f1": m.get("f1"), "losses": losses,
            "seconds": seconds}


if __name__ == "__main__":
    main()
