"""Greedy decode's drift from a cache-free forward, by generator depth.

    python -m jsa_rag_tpu_torch.analysis.decode_drift 8 16 32

For each depth on the command line: a generator at Mistral-7B-v0.1's
widths (``LMConfig``'s defaults: 4096 wide, 32 heads / 8 kv heads, 14336,
vocab 32000), N(0, 0.02) weights from seed 0 stored in bf16, and 8 seeded
prompts of 512 ids (row r left-padded by 16 r). It decodes 32 greedy
tokens with the KV cache in bf16 and in f32 (the same bf16-stored
weights), and runs each decode's prompt + tokens through a cache-free
``lm_logits`` in both dtypes. Prints one JSON line per depth: for each
decode, the largest |log-prob| gap of its emitted tokens against the
cache-free bf16 and f32 forwards, the cache-free bf16 forward's gap to the
f32 one on the same tokens, and the steps whose token is the cache-free
argmax of its own dtype. A cached decode that is off its own dtype's
cache-free forward by much more than the two forwards are off each other
points at the cache; one that is off by no more is the dtype's rounding.
``chip_smoke.py``'s decode check holds the bf16 gap to 0.1 nats.
"""

from __future__ import annotations

import json
import sys

import torch

from jsa_rag_tpu_torch.device import exact_f32_matmul
from jsa_rag_tpu_torch.models.lm import LMConfig, greedy_generate, lm_init
from jsa_rag_tpu_torch.models.lm import lm_logits

ROWS, PROMPT, NEW = 8, 512, 32


def _tree(t, fn):
    if isinstance(t, dict):
        return {k: _tree(v, fn) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree(v, fn) for v in t]
    return fn(t)


def _picked(logp, toks):
    return torch.gather(logp, 2, toks[..., None])[..., 0]


def drift(layers: int, device, **widths) -> dict:
    """The gaps at one depth; ``widths`` override ``LMConfig``'s (tests
    run a narrow model on the CPU)."""
    g = torch.Generator(device=device).manual_seed(0)
    cfg = LMConfig(layers=layers, **widths)
    params = _tree(lm_init(cfg, device=device, generator=g),
                   lambda v: v.to(torch.bfloat16))
    ids = torch.randint(3, cfg.vocab_size, (ROWS, PROMPT), generator=g,
                        device=device)
    mask = torch.ones_like(ids)
    for r in range(ROWS):
        mask[r, :16 * r] = 0
        ids[r, :16 * r] = 0
    runs = {"bf16": (params, cfg),
            "f32": (_tree(params, lambda v: v.float()),
                    LMConfig(layers=layers, dtype=torch.float32, **widths))}
    out = {"layers": layers}
    with torch.no_grad():
        for name, (p, c) in runs.items():
            toks, lps = greedy_generate(p, c, ids, mask, max_new_tokens=NEW,
                                        eos_id=-1, pad_id=0,
                                        return_logprobs=True)
            full = torch.cat([ids, toks], 1)
            full_mask = torch.cat([mask, torch.ones_like(toks)], 1)
            free = {}
            for n, (pp, cc) in runs.items():
                logp = torch.log_softmax(lm_logits(pp, cc, full, full_mask),
                                         -1)[:, PROMPT - 1:-1]
                free[n] = _picked(logp, toks)
                if n == name:
                    argmax_equal = int((toks == logp.argmax(-1)).sum())
                del logp
            out[f"cached_{name}"] = {
                "gap_to_free_bf16": float((lps - free["bf16"]).abs().max()),
                "gap_to_free_f32": float((lps - free["f32"]).abs().max()),
                "free_bf16_gap_to_free_f32": float(
                    (free["bf16"] - free["f32"]).abs().max()),
                "argmax_equal_steps": [argmax_equal, toks.numel()]}
    return out


def main(argv=None) -> list:
    exact_f32_matmul()
    device = torch.device("cuda", 0)
    rows = []
    for layers in map(int, argv if argv is not None else sys.argv[1:]):
        rows.append(drift(layers, device))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
