"""Extract the retriever towers (and the generator, LoRA merged) from a
training checkpoint into standalone param files, as
``scripts/analysis/extract_towers.py`` does (reference:
src/utils/extract_state_dict.py):

    python -m jsa_rag_tpu_torch.analysis.extract_towers checkpoint/run \\
        [out_dir] [--device cuda]

Writes ``<owner>_<tower>.pkl`` for each retriever tower and
``generator.pkl``, numpy pytrees in the JAX package's layout; with LoRA
adapters in the checkpoint the generator is ``lora_merge_export`` of them
at the run's ``lora_rank``/``lora_alpha`` (its ``options.json``; the
defaults would mis-scale the delta by alpha/rank). The merge runs on
``--device`` (default cuda; cpu where asked).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

from ..convert import (lm_params_from_numpy, lm_params_to_numpy,
                       lora_params_from_numpy)
from ..device import resolve_device
from ..models.lora import LoRAConfig, lora_merge_export
from ..train.checkpoint import load_checkpoint


def run_lora_config(ckpt_path: str) -> LoRAConfig:
    """The run's LoRA rank and alpha from the checkpoint's options.json
    (the step dir, or the run dir's ``latest``); defaults where absent."""
    cfg = LoRAConfig()
    for d in (ckpt_path, os.path.join(ckpt_path, "latest")):
        path = os.path.join(d, "options.json")
        if os.path.exists(path):
            with open(path) as f:
                o = json.load(f)
            return LoRAConfig(rank=int(o.get("lora_rank", cfg.rank)),
                              alpha=float(o.get("lora_alpha", cfg.alpha)))
    return cfg


def merged_generator(params: dict, cfg: LoRAConfig, device) -> dict:
    """The generator tree with the adapters folded in, as numpy."""
    gen = lm_params_from_numpy(params["generator"], device)
    lora = lora_params_from_numpy(params["lora"], device)
    return lm_params_to_numpy(lora_merge_export(gen, lora, cfg))


def main(argv=None) -> list:
    """-> the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    state = load_checkpoint(a.ckpt)
    out_dir = a.out_dir or os.path.join(a.ckpt, "extracted")
    os.makedirs(out_dir, exist_ok=True)
    params = state["params"]
    written = []
    for owner in ("retriever", "post_retriever"):
        for tower in ("query", "passage", "shared"):
            sub = params.get(owner, {}).get(tower)
            if sub is None:
                continue
            path = os.path.join(out_dir, f"{owner}_{tower}.pkl")
            with open(path, "wb") as f:
                pickle.dump(sub, f, protocol=4)
            written.append(path)
    if "generator" in params:
        gen = params["generator"]
        if "lora" in params:
            gen = merged_generator(params, run_lora_config(a.ckpt), device)
        path = os.path.join(out_dir, "generator.pkl")
        with open(path, "wb") as f:
            pickle.dump(gen, f, protocol=4)
        written.append(path)
    print(f"step {state['step']}:")
    for p in written:
        print(f"  wrote {p}")
    return written


if __name__ == "__main__":
    main()
