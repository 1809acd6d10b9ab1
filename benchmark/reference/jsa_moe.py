"""The first steps of jsa training with a DeepSeek-V2 generator, by the plain
reference: ``jsa.py``'s recipe step (towers, exact search, union, chain,
loss, clipping, AdamW) with the generator's per-candidate loss computed by
``deepseek_v2.py::row_ce`` over ``benchmark/inputs_deepseek_v2.py``'s
weights and adapters, the generator kept in its ``torch_dtype`` and upcast
a layer at a time.

Where it follows a run, it also takes the run's expert choices: each MoE
layer's real tokens go to the experts the run chose (the weights stay the
reference's own router probabilities), so that a near tie in a router,
which bf16 may tip, does not set the two apart; it counts
``route_faults``, the (token, layer) pairs whose own f32 top-k differs
from the run's while its k-th and (k+1)-th probabilities lie more than
``margin`` apart; and it gives ``route_weight_gap``, the largest gap over
every real (token, MoE layer, expert taken) between the run's router
probability and its own. Where it runs in the program's place (the
control), it records the experts it chose itself and their probabilities
under ``routes``, in the form a run records them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import inputs, inputs_deepseek_v2
from . import deepseek_v2, jsa, prompts
from .precision import Matmul, exact_f32


@contextlib.contextmanager
def _as_generator(ref):
    """``jsa.Reference.step`` scores the candidates through its module's
    ``mistral.row_ce``; ``ref.row_ce`` takes its place while it runs."""
    old = jsa.mistral
    jsa.mistral = ref
    try:
        yield
    finally:
        jsa.mistral = old


class MoEReference(jsa.Reference):
    """``jsa.Reference`` with the DeepSeek-V2 generator."""

    def __init__(self, ctx, gen_mm: Matmul, tower_mm: Matmul,
                 margin: float | None = None):
        c, t, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.dev = ctx, dev
        self.gen_mm, self.tower_mm = gen_mm, tower_mm
        # the generator's config is the configuration's top level
        self.g, self.r = c, c["retriever"]
        self.o = {**c["recipe"], **t["options"]}
        self.margin = margin
        self.gen = inputs_deepseek_v2.lm_weights(
            self.g, inputs.derive_seed(ctx.seed, "generator"), dev,
            getattr(torch, self.g["torch_dtype"]))
        lora = inputs_deepseek_v2.lora_weights(
            self.g, int(self.o["lora_rank"]),
            inputs.derive_seed(ctx.seed, "lora"), dev)
        tower = inputs.bert_weights(self.r, inputs.derive_seed(
            ctx.seed, "tower"), dev, torch.float32)
        self.passage = tower
        self.prior_q = {k: v.clone().requires_grad_() for k, v in
                        tower.items()}
        self.post_q = {k: v.clone().requires_grad_() for k, v in
                       tower.items()}
        self.lora = {"layers": [{n: {"A": ab["A"].requires_grad_(),
                                     "B": ab["B"].requires_grad_()}
                                 for n, ab in layer.items()}
                                for layer in lora["layers"]]}
        self.leaves, self.labels = {}, {}
        for i, layer in enumerate(self.lora["layers"]):
            for n, ab in layer.items():
                for part in ("A", "B"):
                    key = f"lora/layers/{i}/{n}/{part}"
                    self.leaves[key], self.labels[key] = ab[part], "lm"
        for owner, w in (("retriever", self.prior_q),
                         ("post_retriever", self.post_q)):
            for name, v in w.items():
                key = f"{owner}/query/" + name.replace(".", "/")
                self.leaves[key], self.labels[key] = v, "retr"
        self.mu = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.leaves.items()}
        self.count = 0
        self.store = inputs.WikiPassages(
            int(c["index"]["rows"]), int(t["words"]),
            inputs.derive_seed(ctx.seed, "corpus"), t["passage_words"])
        n_words = int(t["words"])
        self.vocab_r = inputs.word_vocab(n_words, {"[SEP]": inputs.SEP_ID})
        self.vocab_g = inputs.word_vocab(n_words, prompts.prompt_words())
        self.mis_gen = torch.Generator(device=dev).manual_seed(
            inputs.derive_seed(ctx.seed, "mis"))
        self.rate = float(self.o["dropout"])
        self.drop_gen = torch.Generator().manual_seed(
            inputs.derive_seed(ctx.seed, "dropout"))
        self._follow, self._faults, self._taken = None, 0, None
        self._weight_gap = 0.0

    def step(self, s: int, question: str, answer: str, follow=None) -> dict:
        self._follow = follow
        self._faults, self._weight_gap = 0, 0.0
        self._taken = None
        with _as_generator(self):
            out = super().step(s, question, answer, follow)
        if follow is not None:
            out["route_faults"] = self._faults
            out["route_weight_gap"] = self._weight_gap
        else:
            out["routes"] = self._taken
        return out

    def _in_layout(self, arrays, ids: torch.Tensor, dtype):
        """The run's per-layer arrays (its (rows x length, k)) in this
        call's (rows x length, k) layout: the run's first rows, cut or
        padded with zeros to this call's length (padding positions are
        not real tokens)."""
        r_run, s_run = self._follow["routes"]["shape"]
        rows, s = ids.shape
        out = []
        for a in arrays:
            a = torch.as_tensor(np.asarray(a), device=ids.device).to(dtype)
            a = a.reshape(r_run, s_run, -1)[:rows]
            full = torch.zeros((rows, s, a.shape[-1]), dtype=dtype,
                               device=ids.device)
            n = min(s, s_run)
            full[:, :n] = a[:, :n]
            out.append(full.reshape(rows * s, -1))
        return out

    def row_ce(self, weights, lora, c, ids, mask, labels, mm, scale,
               logit_temp=1.0, drop=None):
        run = None if self._follow is None else self._follow.get("routes")
        routes = None
        if run is not None:
            routes = self._in_layout(run["ids"], ids, torch.long)
        taken = []
        ce, faults = deepseek_v2.row_ce(
            weights, lora, c, ids, mask, labels, mm, scale, logit_temp, drop,
            routes, self.margin, taken=taken)
        self._faults += faults
        if run is not None:
            real = mask.reshape(-1).bool()
            given = self._in_layout(run["probs"], ids, torch.float32)
            for (_, own), theirs in zip(taken, given):
                gap = float((own[real] - theirs[real]).abs().max())
                self._weight_gap = max(self._weight_gap, gap)
        elif self._follow is None:
            self._taken = {"shape": list(ids.shape),
                           "ids": [t.cpu().numpy().astype(np.int16)
                                   for t, _ in taken],
                           "probs": [p.cpu().numpy() for _, p in taken]}
        return ce


def run(ctx, questions, follow=None, gen_kind: str = "f32",
        tower_kind: str = "f32", margin: float | None = None) -> dict:
    """``jsa.run`` with the DeepSeek-V2 generator; ``margin`` as
    ``MoEReference`` takes it."""
    exact_f32()
    ref = MoEReference(ctx, Matmul(gen_kind), Matmul(tower_kind), margin)
    start = {n: v.detach().clone() for n, v in ref.leaves.items()}
    steps = []
    for s, (q, a) in enumerate(questions):
        steps.append(ref.step(s, q, a, None if follow is None
                              else follow["steps"][s]))
    delta = {n: float((v.detach() - start[n]).norm())
             for n, v in ref.leaves.items()}
    return {"steps": steps, "grad_norms": steps[0].pop("grad_norms"),
            "delta_norms": delta}
