"""The copy task's shared setup, and its generator's copy pretraining
(the counterpart of the generator checkpoint ``docs/demo/e2e_copy_task.py``
and ``docs/demo/jsa_mechanism_demo.py`` read).

The data (``make_data``): ``scripts/make_copy_task_data.py`` without
``--hard`` (one word form shared by questions and passages), at 26,000
topics (26k passages), 25,000 of them train topics, and 100 dev questions
drawn from the 1,000 unseen ones; the script's other flags at their
defaults (4 rows a topic, 500 base words, seed 0)::

    python scripts/make_copy_task_data.py --out data/copy \\
        --n_topics 26000 --n_train_topics 25000 --n_eval 100

The train topics make each copy-pretraining row near-single-occurrence
(100,000 rows against 2,500 steps of 32), as the JAX package's record
describes its run (``docs/BENCHMARKS.md``): at the script's default 400
train topics the generator memorises its 1,600 rows, whose codes are drawn
per row, instead of learning to copy.

The generator: ``LM_PRESETS["small"]`` (hidden 256, 4 layers, 8 heads, 4
kv heads, intermediate 512) over the train entry's SimpleTokenizer,
copy-pretrained by the port's own train entry in concat mode with the gold
passage supplied per row, which writes the checkpoint directory the two
demos read (``load_generator_checkpoint``)::

    python -m jsa_rag_tpu_torch.train --model_size small \\
        --gold_score_mode concat --use_file_passages true \\
        --qa_prompt_format '{question}' --n_context 1 --text_maxlength 96 \\
        --target_maxlength 8 \\
        --generation_max_length 4 --per_gpu_batch_size 32 --lr 1e-3 \\
        --lr_retriever 0 --weight_decay 0 --scheduler cosine \\
        --warmup_steps 50 --total_steps 2500 --precision fp32 \\
        --use_lora false --train_data data/copy/gen_pretrain.jsonl \\
        --eval_data data/copy/dev.jsonl \\
        --passages data/copy/passages.jsonl --save_freq 2500 \\
        --save_build_retriever_step 0 --eval_freq 1000000000 \\
        --log_freq 100 --checkpoint_dir out/ck --name copy-generator

``python -m jsa_rag_tpu_torch.demo.copy_task --data data/copy
--checkpoint_dir out/ck`` runs that command in this process, then reports
exact match with the gold passage on the unseen dev topics. The recipe of
``demo/pretrain_copy_generator`` is the same, but it needs the hard
encoder's vocabulary.

The retriever of both demos is a 0-layer ``mean_norm`` BERT (word
embeddings averaged and normalised: a random-projection bag of words)
over the generator's vocabulary, hidden 256, 96 positions
(``bow_retriever``; tied for the copy task, and set up as the mechanism
probe's towers by ``mechanism_towers``), its weights drawn from a
``torch.Generator`` seeded ``--seed``.
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import time

import torch

from ..config import Options
from ..convert import lm_params_from_numpy
from ..data.passages import PassageStore, load_passages_jsonl
from ..device import resolve_device
from ..evaluation import evaluate
from ..model_io import LM_PRESETS
from ..models.bert import BertConfig
from ..models.lm import LMConfig
from ..models.retriever import DualEncoderRetriever, RetrieverConfig
from ..train import __main__ as train_entry
from ..train.checkpoint import (load_checkpoint,
                                load_tokenizers_from_checkpoint)
from ..train.rag_model import RAGModel
from .pretrain_copy_generator import metric_losses

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_TOPICS = 26_000
N_TRAIN_TOPICS = 25_000
N_EVAL = 100
GENERATOR = "small"
# jsa_mechanism_demo.py: the prior query tower's key, 7, beside the
# passage tower's 0
PRIOR_SEED_OFFSET = 7


def make_data(out: str, n_topics: int = N_TOPICS,
              n_train_topics: int = N_TRAIN_TOPICS,
              n_eval: int = N_EVAL) -> str:
    """Write the copy-task files into ``out`` with
    ``scripts/make_copy_task_data.py`` (a subprocess); -> ``out``."""
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "scripts", "make_copy_task_data.py"),
                    "--out", out, "--n_topics", str(n_topics),
                    "--n_train_topics", str(n_train_topics), "--n_eval",
                    str(n_eval)], check=True, capture_output=True,
                   timeout=300)
    return out


def generator_argv(data: str, checkpoint_dir: str, name: str, steps: int,
                   seed: int, device: str) -> list[str]:
    """The train entry's flags that copy-pretrain the generator."""
    return ["--model_size", GENERATOR, "--gold_score_mode", "concat",
            "--use_file_passages", "true", "--qa_prompt_format",
            "{question}", "--n_context", "1",
            "--text_maxlength", "96", "--target_maxlength", "8",
            "--generation_max_length", "4", "--per_gpu_batch_size", "32",
            "--lr", "1e-3", "--lr_retriever", "0", "--weight_decay", "0",
            "--scheduler", "cosine", "--warmup_steps", "50",
            "--total_steps", str(steps), "--precision", "fp32",
            "--use_lora", "false",
            "--train_data", os.path.join(data, "gen_pretrain.jsonl"),
            "--eval_data", os.path.join(data, "dev.jsonl"),
            "--passages", os.path.join(data, "passages.jsonl"),
            "--save_freq", str(steps), "--save_build_retriever_step", "0",
            "--eval_freq", str(10 ** 9), "--log_freq", "100",
            "--seed", str(seed), "--checkpoint_dir", checkpoint_dir,
            "--name", name, "--device", device]


def load_generator_checkpoint(path: str, device="cuda"):
    """A run or step directory the train entry wrote (either package's)
    -> (``LMConfig`` at f32, f32 generator params on ``device``, the
    generator's ``SimpleTokenizer``), as the JAX demos read it."""
    state = load_checkpoint(path)
    tok, _ = load_tokenizers_from_checkpoint(path)
    cfg = LMConfig(vocab_size=tok.vocab_size, dtype=torch.float32,
                   **LM_PRESETS[GENERATOR])
    return cfg, lm_params_from_numpy(state["params"]["generator"],
                                     device), tok


def bow_config(vocab_size: int) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, hidden=256, layers=0, heads=4,
                      intermediate=64, max_positions=96, pooling="mean_norm",
                      dtype=torch.float32)


def bow_retriever(vocab_size: int, *, tied: bool, seed: int,
                  device) -> DualEncoderRetriever:
    dev = resolve_device(device)
    return DualEncoderRetriever(
        RetrieverConfig(bert=bow_config(vocab_size), tied=tied), device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))


def assemble_mechanism(a: DualEncoderRetriever, b: DualEncoderRetriever):
    """The mechanism probe's towers (``jsa_mechanism_demo.py:77-85``) from
    two untied retrievers: the prior pairs ``b``'s query tower with ``a``'s
    passage tower (the index's); the decoupled posterior's query tower is a
    copy of ``a``'s passage tower. -> (prior, posterior)."""
    prior = DualEncoderRetriever(a.cfg, towers={"query": b.query,
                                                "passage": a.passage})
    post = DualEncoderRetriever(a.cfg,
                                towers={"query": copy.deepcopy(a.passage)})
    return prior, post


def mechanism_towers(vocab_size: int, seed: int, device):
    """``assemble_mechanism`` over retrievers drawn from ``seed`` and
    ``seed + PRIOR_SEED_OFFSET``."""
    return assemble_mechanism(
        bow_retriever(vocab_size, tied=False, seed=seed, device=device),
        bow_retriever(vocab_size, tied=False,
                      seed=seed + PRIOR_SEED_OFFSET, device=device))


def gold_options(data: str, device: str) -> Options:
    """Evaluation with the gold passage supplied (concat, one passage)."""
    return Options(task="qa", gold_score_mode="concat",
                   use_file_passages=True, qa_prompt_format="{question}",
                   n_context=1, text_maxlength=96, target_maxlength=8,
                   generation_max_length=4, per_gpu_batch_size=32,
                   precision="fp32", use_lora=False,
                   eval_data=[os.path.join(data, "dev.jsonl")],
                   device=device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True,
                    help="the copy-task files (make_data)")
    ap.add_argument("--checkpoint_dir", required=True)
    ap.add_argument("--name", default="copy-generator")
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Copy-pretrain the generator through the train entry, then exact
    match with the gold passage on the unseen dev topics; -> {
    ``em_with_gold_unseen``, ``f1``, ``losses`` (the loop's logged (step,
    loss)), ``seconds``, ``checkpoint`` (the run directory)}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    train_entry.main(generator_argv(args.data, args.checkpoint_dir,
                                    args.name, args.steps, args.seed,
                                    dev.type))
    seconds = time.perf_counter() - t0
    run = os.path.join(args.checkpoint_dir, args.name)
    cfg, gen, tok = load_generator_checkpoint(run, dev)
    opt = gold_options(args.data, dev.type)
    store = PassageStore(passages=load_passages_jsonl(
        os.path.join(args.data, "passages.jsonl")))
    retriever = bow_retriever(tok.vocab_size, tied=True, seed=args.seed,
                              device=dev)
    model = RAGModel(opt, retriever, cfg, tok, tok, store)
    m = evaluate(model, None, {"retriever": retriever, "generator": gen},
                 opt, opt.eval_data[0])
    print("eval with gold:", {k: round(m[k], 3) for k in
                              ("exact_match", "f1")}, flush=True)
    return {"em_with_gold_unseen": m["exact_match"], "f1": m["f1"],
            "losses": metric_losses(os.path.join(run, "metrics.jsonl")),
            "seconds": seconds, "steps": args.steps, "checkpoint": run}


if __name__ == "__main__":
    main()
