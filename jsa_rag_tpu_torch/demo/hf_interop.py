"""The HF interop lifecycle through the port's entry points (counterpart of
``docs/demo/hf_interop_drive.py``): HF towers -> joint training with the
in-loop refresh -> checkpoint, retriever export and index save ->
evaluate -> the index round trip through Atlas's on-disk format ->
retrieval-only evaluate on the round-tripped index.

Five steps, each a subprocess under ``--work``:

1. ``scripts/make_synthetic_data.py`` at 300 passages, 200 train and 40
   dev questions;
2. ``python -m jsa_rag_tpu_torch.train`` from the two HF directories with
   the script's flags (``:143-161``: rag, 30 steps of batch 4, 2 of 4
   retrieved passages, refresh ``0-100:15``, the checkpoint, the retriever
   export and the index saved at the last step);
3. ``python -m jsa_rag_tpu_torch.evaluate`` on the checkpoint and the saved
   index, with ``--write_results``;
4. ``python -m jsa_rag_tpu_torch.index.atlas_io export`` (8 Atlas shards),
   then ``convert`` back;
5. retrieval-only ``evaluate`` on the round-tripped index, at the saved
   index's depth (``--retriever_n_context 2``, step 3's ``--n_context``),
   so its recall and step 3's ``retrieval_recall`` count the same top 2.

Between steps 4 and 5 the round trip is held to the index it came from
(``roundtrip_matches``): the same passages row for row and the same rows
at the fp16 the Atlas format stores. The towers are random, so the two
recalls read near 0 whatever the index holds; this check does not depend
on them.

The HF directories are written here, without ``transformers``
(``models/hf_write.py``), from a ``torch.Generator`` seeded ``--seed``
under HF's key names: a 2-layer ``BertModel`` (hidden 64, 4 heads,
intermediate 128, 128 positions; ``config.json``, ``model.safetensors``,
``vocab.txt`` over the corpus words) and a 2-layer ``GPT2LMHeadModel``
(n_embd 64, 4 heads, 256 positions; ``config.json``,
``model.safetensors``, and word-level ``vocab.json`` with an empty
``merges.txt``, as ``:91-108`` builds them). The vocabulary files are read
only where ``transformers`` is installed: the tokenizer loader
(``data/tokenizer.py::load_tokenizer``) otherwise gives each model a
``SimpleTokenizer`` of ``--max_vocab`` ids (set to the smaller vocabulary
here), and the transcript names the class each model got.

    python -m jsa_rag_tpu_torch.demo.hf_interop --work out/hf_interop \\
        --out out/transcript-hf-interop.md [--device cpu]

Each step's rc and seconds and its output's last lines go to the transcript
``--out``; a step that fails, or a round trip that differs, ends the run
with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import torch

from ..data.tokenizer import HFTokenizerWrapper, load_tokenizer
from ..device import resolve_device
from ..models.hf_write import (bert_state_dict, gpt2_state_dict, hf_init,
                               write_hf_dir, write_safetensors)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BERT_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
STEP_TIMEOUT_S = 1800


def corpus_words(data: str) -> list[str]:
    """Every lower-cased word of the synthetic set's titles, texts,
    questions and answers (``:121-131``)."""
    words = set()
    for fn in ("passages.jsonl", "train.jsonl", "dev.jsonl"):
        with open(os.path.join(data, fn)) as f:
            for line in f:
                row = json.loads(line)
                for v in (row.get("title", ""), row.get("text", ""),
                          row.get("question", ""),
                          *(row.get("answers") or [])):
                    words.update(v.lower().split())
    return sorted(words)


def gpt2_vocab(words: list[str]) -> dict:
    """Word-level byte-BPE entries (``Ġword`` and ``word``, then single
    characters): every corpus word is one token with no merges."""
    vocab = {"<|endoftext|>": 0}
    for w in words:
        vocab.setdefault("Ġ" + w, len(vocab))
        vocab.setdefault(w, len(vocab))
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789.?,:":
        vocab.setdefault(ch, len(vocab))
        vocab.setdefault("Ġ" + ch, len(vocab))
    return vocab


def write_bert(path: str, words: list[str], g: torch.Generator) -> dict:
    vocab = BERT_SPECIALS + words
    config = {"architectures": ["BertModel"], "model_type": "bert",
              "vocab_size": len(vocab), "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "max_position_embeddings": 128,
              "type_vocab_size": 2, "layer_norm_eps": 1e-12,
              "hidden_act": "gelu", "initializer_range": 0.02}
    write_hf_dir(path, config)
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab) + "\n")
    write_safetensors(os.path.join(path, "model.safetensors"),
                      bert_state_dict(config, hf_init(g)),
                      metadata={"format": "pt"})
    return config


def write_gpt2(path: str, words: list[str], g: torch.Generator) -> dict:
    vocab = gpt2_vocab(words)
    config = {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
              "vocab_size": len(vocab), "n_embd": 64, "n_layer": 2,
              "n_head": 4, "n_positions": 256, "n_ctx": 256,
              "layer_norm_epsilon": 1e-5, "initializer_range": 0.02}
    write_hf_dir(path, config)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    write_safetensors(os.path.join(path, "model.safetensors"),
                      gpt2_state_dict(config, hf_init(g)),
                      metadata={"format": "pt"})
    return config


def tokenizer_class(path: str, max_vocab: int) -> str:
    """The tokenizer class the entry points load for the directory."""
    tok = load_tokenizer(path, max_vocab=max_vocab)
    if isinstance(tok, HFTokenizerWrapper):
        return type(tok.t).__name__
    return type(tok).__name__


def dataset_metrics(output: str) -> dict:
    """The metrics of the last ``Dataset: <file> | v key | ...`` line the
    evaluate entry logged."""
    lines = [ln for ln in output.splitlines() if "Dataset: " in ln]
    if not lines:
        raise ValueError("no metrics line in the evaluate output")
    return {k: float(v) for v, k in re.findall(
        r"\| ([-\d.eE+naif]+) (\S+)", lines[-1])}


def roundtrip_matches(saved: str, passages: str, roundtrip: str) -> dict:
    """The Atlas round trip ``roundtrip`` (``atlas_io convert``'s output)
    against the saved index ``saved`` and its ``passages`` file, loaded on
    the CPU: -> {"rows", "rows_equal": the same rows at fp16 (the format's
    storage), "passages_equal": the same passage dicts in the same row
    order}."""
    from ..data.passages import load_passages_jsonl
    from ..index import load_index

    a, b = (load_index(d, device="cpu").embeddings_as_float().to(
        torch.float16) for d in (saved, roundtrip))
    return {"rows": b.shape[0],
            "rows_equal": a.shape == b.shape and torch.equal(a, b),
            "passages_equal": load_passages_jsonl(passages)
            == load_passages_jsonl(os.path.join(roundtrip, "passages.jsonl"))}


class Transcript:
    def __init__(self):
        self.sections, self.steps = [], []

    def run(self, title: str, cmd: list[str]) -> str:
        """Run one step in a subprocess from the repository's root; record
        its rc, seconds and last lines; raise on a non-zero rc."""
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                              env=env, timeout=STEP_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        out = proc.stdout + proc.stderr
        tail = "\n".join(out.strip().splitlines()[-12:])
        shown = " ".join(["python", *cmd[1:]])
        self.sections.append(f"## {title}\n\n`{shown}`\n\n"
                             f"rc={proc.returncode}, {seconds:.1f} s\n\n"
                             f"```\n{tail}\n```\n")
        self.steps.append({"step": title, "rc": proc.returncode,
                           "seconds": seconds})
        print(f"[{title}] rc={proc.returncode} ({seconds:.1f} s)",
              flush=True)
        if proc.returncode != 0:
            print(out[-3000:], flush=True)
            raise SystemExit(f"step failed: {title}")
        return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="the directory every step writes under")
    ap.add_argument("--out", required=True, help="the transcript (markdown)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """-> {"steps": [{step, rc, seconds}], "tokenizers": {retriever,
    generator}, "roundtrip" (``roundtrip_matches``), "recall_saved",
    "recall_roundtrip"}."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    work = os.path.abspath(args.work)
    data, ckpt = os.path.join(work, "data"), os.path.join(work, "ckpt")
    index, atlas, rt = (os.path.join(work, d) for d in
                        ("index", "atlas_fmt", "index_roundtrip"))
    py, device = sys.executable, ["--device", dev.type]
    tr = Transcript()
    tr.run("make synthetic data",
           [py, "scripts/make_synthetic_data.py", "--out", data,
            "--n_passages", "300", "--n_train", "200", "--n_dev", "40"])
    words = corpus_words(data)
    g = torch.Generator().manual_seed(args.seed)
    bert_dir, gpt2_dir = (os.path.join(work, d) for d in ("hf_bert",
                                                          "hf_gpt2"))
    bcfg = write_bert(bert_dir, words, g)
    gcfg = write_gpt2(gpt2_dir, words, g)
    max_vocab = min(bcfg["vocab_size"], gcfg["vocab_size"])
    tokenizers = {"retriever": tokenizer_class(bert_dir, max_vocab),
                  "generator": tokenizer_class(gpt2_dir, max_vocab)}
    tr.sections.append(
        f"## HF directories\n\nBertModel (2 x 64, vocab.txt of "
        f"{bcfg['vocab_size']} entries) -> `{bert_dir}`; GPT2LMHeadModel "
        f"(2 x 64, vocab.json of {gcfg['vocab_size']} entries) -> "
        f"`{gpt2_dir}`; seeded weights, safetensors. Tokenizers loaded: "
        f"retriever {tokenizers['retriever']}, generator "
        f"{tokenizers['generator']} (`--max_vocab {max_vocab}`).\n")
    print(f"tokenizers: {tokenizers}", flush=True)
    models = ["--retriever_model_path", bert_dir, "--generator_model_path",
              gpt2_dir, "--max_vocab", str(max_vocab)]
    lengths = ["--n_context", "2", "--retriever_n_context", "4",
               "--text_maxlength", "64"]
    steps = str(args.steps)
    tr.run("train (HF towers, joint rag, refresh, export)",
           [py, "-m", "jsa_rag_tpu_torch.train", "--name", "hf-interop",
            "--checkpoint_dir", ckpt, *models, "--task", "qa",
            "--gold_score_mode", "rag",
            "--train_data", os.path.join(data, "train.jsonl"),
            "--eval_data", os.path.join(data, "dev.jsonl"),
            "--passages", os.path.join(data, "passages.jsonl"),
            "--total_steps", steps, "--per_gpu_batch_size", "4", *lengths,
            "--target_maxlength", "16", "--generation_max_length", "8",
            "--refresh_index", "0-100:15", "--save_freq", steps,
            "--eval_freq", "1000000", "--save_build_retriever_step", steps,
            "--save_index_path", index, "--save_index_n_shards", "4",
            "--precision", "fp32", "--lr", "1e-4", "--lr_retriever", "1e-4",
            "--seed", str(args.seed), *device])
    step_dir = os.path.join(ckpt, "hf-interop", "latest")
    saved = dataset_metrics(tr.run(
        "evaluate (checkpoint + saved index)",
        [py, "-m", "jsa_rag_tpu_torch.evaluate", "--name", "hf-interop-eval",
         "--checkpoint_dir", ckpt, "--model_path", step_dir, *models,
         "--task", "qa", "--gold_score_mode", "rag",
         "--eval_data", os.path.join(data, "dev.jsonl"),
         "--passages", os.path.join(data, "passages.jsonl"),
         "--load_index_path", index, *lengths, "--target_maxlength", "16",
         "--generation_max_length", "8", "--precision", "fp32",
         "--write_results", *device]))
    tr.run("atlas_io export (Atlas's on-disk format)",
           [py, "-m", "jsa_rag_tpu_torch.index.atlas_io", "export", index,
            os.path.join(data, "passages.jsonl"), atlas, "--shards", "8",
            *device])
    tr.run("atlas_io convert (back to the index layout)",
           [py, "-m", "jsa_rag_tpu_torch.index.atlas_io", "convert", atlas,
            rt])
    same = roundtrip_matches(index, os.path.join(data, "passages.jsonl"), rt)
    tr.sections.append(
        f"## the round trip against the saved index\n\n{same['rows']} "
        f"rows; rows equal at fp16: {same['rows_equal']}; passages equal "
        f"row for row: {same['passages_equal']}\n")
    print(f"round trip: {json.dumps(same)}", flush=True)
    if not (same["rows_equal"] and same["passages_equal"]):
        raise SystemExit(f"the round trip differs from the saved index: "
                         f"{same}")
    roundtrip = dataset_metrics(tr.run(
        "evaluate retrieval-only on the round-tripped index",
        [py, "-m", "jsa_rag_tpu_torch.evaluate", "--name", "hf-interop-rt",
         "--checkpoint_dir", ckpt, "--model_path", step_dir, *models,
         "--task", "retrieval", "--eval_data",
         os.path.join(data, "dev.jsonl"),
         "--passages", os.path.join(rt, "passages.jsonl"),
         "--load_index_path", rt, "--n_context", "2",
         "--retriever_n_context", "2", "--text_maxlength", "64",
         "--precision", "fp32", *device]))
    result = {"steps": tr.steps, "tokenizers": tokenizers,
              "roundtrip": same,
              "recall_saved": saved["retrieval_recall"],
              "recall_roundtrip": roundtrip["recall"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write("# HF interop drive transcript\n\n"
                "Written by `python -m jsa_rag_tpu_torch.demo.hf_interop` "
                f"on {dev.type}: HF towers -> joint training with refresh "
                "-> checkpoint and index export -> Atlas-format round trip "
                "-> evaluate, through the port's entry points. The towers "
                "are random-weight 2-layer stand-ins trained "
                f"{args.steps} steps, so EM and recall are near chance by "
                "construction (saved "
                f"{result['recall_saved']:.4f}, round-tripped "
                f"{result['recall_roundtrip']:.4f}); the round trip keeps "
                "the saved index's rows and passages row for row.\n\n"
                + "\n".join(tr.sections))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
