"""``train_jsa``'s closed loop of jsa training steps with the DeepSeek-V2
generator (``models/lm.py``'s ``deepseek_v2``: latent attention, routed
experts with unmerged LoRA adapters): the same batches, step, window and
comparisons, by import. What differs:

- set-up builds the generator from ``configs/<name>.json``'s top level
  (DeepSeek-V2's ``config.json``, key for key, with ``torch_dtype`` and
  ``initializer_range``) through the program's HF config reader, its
  weights and adapters from ``inputs_deepseek_v2.py``;
- the judged steps also record every MoE layer's expert choices and their
  router probabilities (the forward's, not the remat recompute's): the
  reference follows the choices and holds the probabilities to its own;
- the work is counted by ``yardstick/flops_mla_moe.py``; the traced steps'
  grouped expert products (operations and bytes) go into the window's
  counters for ``moe.experts_roofline``;
- ``correct`` adds ``route_faults`` (``reference/jsa_moe.py``; its margin
  is ``limits/<workload>.json``'s ``route_faults.margin``) and
  ``route_weight_gap``.

Traffic parameters: ``train_jsa``'s. End-to-end: ``train_examples_per_s``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import inputs, inputs_deepseek_v2
from ..harness import checks_against
from ..reference import jsa_moe as ref_moe
from ..reference import prompts as ref_prompts
from ..yardstick import flops, flops_mla_moe
from . import train_jsa
from .common import bert_config, filled_index, sync

outputs = train_jsa.outputs
release = train_jsa.release


def lm_config(g: dict, remat: bool, dropout: float):
    from jsa_rag_tpu_torch.models.hf_import import deepseek_config_from_hf

    cfg = deepseek_config_from_hf(g, getattr(torch, g["torch_dtype"]))
    return dataclasses.replace(cfg, remat=remat, dropout=dropout)


def setup(ctx):
    """``train_jsa.setup`` with the DeepSeek-V2 generator."""
    c, t, dev = ctx.config, ctx.traffic, ctx.device
    opt = train_jsa.options(ctx)
    gcfg = lm_config(c, opt.use_gradient_checkpoint_generator, opt.dropout)
    from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer
    from jsa_rag_tpu_torch.models.bert import BertEncoder
    from jsa_rag_tpu_torch.models.lora import LoRAConfig
    from jsa_rag_tpu_torch.models.retriever import (DualEncoderRetriever,
                                                    RetrieverConfig)
    from jsa_rag_tpu_torch.train.modes import StepRng
    from jsa_rag_tpu_torch.train.optim import set_optim
    from jsa_rag_tpu_torch.train.rag_model import RAGModel
    from jsa_rag_tpu_torch.train.step import make_train_step

    r, g = c["retriever"], c
    bcfg = bert_config(c, opt.use_gradient_checkpoint_retriever, opt.dropout)
    weights = inputs.bert_weights(r, inputs.derive_seed(ctx.seed, "tower"),
                                  dev, torch.float32)
    towers = []
    for _ in range(3):
        enc = BertEncoder(bcfg, device=dev)
        enc.load_state_dict(weights)
        towers.append(enc)
    del weights
    rcfg = RetrieverConfig(bert=bcfg, tied=False,
                           query_side_only=opt.query_side_retriever_training)
    prior = DualEncoderRetriever(rcfg, towers={"query": towers[0],
                                               "passage": towers[1]})
    post = DualEncoderRetriever(rcfg, towers={"query": towers[2]})
    gen = inputs_deepseek_v2.lm_weights(
        g, inputs.derive_seed(ctx.seed, "generator"), dev, gcfg.dtype)
    lora = inputs_deepseek_v2.lora_weights(
        g, opt.lora_rank, inputs.derive_seed(ctx.seed, "lora"), dev)
    params = {"retriever": prior, "post_retriever": post, "generator": gen,
              "lora": lora}
    n_words = int(t["words"])
    rtok = SimpleTokenizer(vocab=inputs.word_vocab(
        n_words, {"[SEP]": inputs.SEP_ID}), max_vocab=int(r["vocab_size"]),
        frozen=True)
    gtok = SimpleTokenizer(vocab=inputs.word_vocab(
        n_words, ref_prompts.prompt_words()), max_vocab=int(g["vocab_size"]),
        frozen=True)
    store = inputs.WikiPassages(int(c["index"]["rows"]), n_words,
                                inputs.derive_seed(ctx.seed, "corpus"),
                                t["passage_words"])
    model = RAGModel(opt, prior, gcfg, rtok, gtok, store,
                     lora_cfg=LoRAConfig(rank=opt.lora_rank,
                                         alpha=opt.lora_alpha))
    index = filled_index(c["index"], ctx.seed, dev)
    tx = set_optim(opt, params)
    step = make_train_step(model, "jsa", tx)
    rng = StepRng.from_seed(inputs.derive_seed(ctx.seed, "mis"), dev)
    state = {"ctx": ctx, "model": model, "params": params, "index": index,
             "tx": tx, "step": step, "rng": rng}
    state["readings"] = judged_steps(state, int(t["judged_steps"]))
    sync(dev)
    return state


class Routes:
    """While ``recording()`` is open, the expert ids and router
    probabilities of the program's router calls (``models/lm.py::route``),
    kept per step (``begin()`` opens one): the first ``n_moe`` calls of a
    step, the forward's (the remat recompute calls it again, in the
    backward)."""

    def __init__(self, n_moe: int):
        self.n_moe = n_moe
        self.steps: list[list] = []

    def begin(self) -> None:
        self.steps.append([])

    @contextlib.contextmanager
    def recording(self):
        from jsa_rag_tpu_torch.models import lm

        real = lm.route

        def route(*args, **kw):
            weights, ids = real(*args, **kw)
            if self.steps and len(self.steps[-1]) < self.n_moe:
                self.steps[-1].append((
                    ids.detach().to(torch.int16).cpu().numpy(),
                    weights.detach().to(torch.float32).cpu().numpy()))
            return weights, ids
        lm.route = route
        try:
            yield self
        finally:
            lm.route = real


def judged_steps(state, n: int) -> dict:
    """``train_jsa.judged_steps`` with each step's expert choices recorded
    beside it (``routes``: the generator rows' (rows, length) shape, and an
    MoE layer's (rows x length, k) ids and router probabilities each)."""
    log = Routes(flops_mla_moe.n_moe_layers(state["ctx"].config))
    real = state["step"]

    def step(*args):
        log.begin()
        return real(*args)

    with log.recording():
        out = train_jsa.judged_steps({**state, "step": step}, n)
    for st, calls in zip(out["steps"], log.steps):
        if len(calls) != log.n_moe:
            raise RuntimeError(f"the step routed {len(calls)} MoE layers, "
                               f"not {log.n_moe}")
        st["routes"] = {"shape": list(st["rows"]["gen_ids"].shape),
                        "ids": [i for i, _ in calls],
                        "probs": [p for _, p in calls]}
    return out


def step_work(ctx, batch, index) -> dict:
    """``train_jsa.step_work`` with the generator counted by
    ``flops_mla_moe.train_flops``; ``expert_ops`` and ``expert_bytes``
    beside it: the step's grouped expert products."""
    c = ctx.config
    g, r = c, c["retriever"]
    rank = int(c["recipe"]["lora_rank"])
    host = train_jsa._host
    gmask = host(batch["gen_mask"]).sum(axis=1)
    labels = host(batch["gen_labels"])
    n_lab = (labels[:, 1:] != -100).sum(axis=1)
    valid = host(batch["union_valid"]).reshape(-1)
    u_tok = host(batch["union_passage_mask"]).reshape(len(valid), -1).sum(1)
    b, _ = batch["union_valid"].shape
    rows = [j for j in range(len(valid)) if valid[j]]
    fl = sum(flops_mla_moe.train_flops(g, rank, int(gmask[j]), int(n_lab[j]))
             for j in rows)
    for key in ("q_mask", "post_q_mask"):
        for n in host(batch[key]).sum(axis=1):
            fl += flops.bert_train_flops(r, int(n))
            fl += flops.bert_forward_flops(r, int(n))
    fl += sum(flops.bert_forward_flops(r, int(u_tok[j])) for j in rows)
    n, d = int(c["index"]["rows"]), int(c["index"]["dim"])
    k = int(ctx.traffic["options"]["n_context"])
    ops = flops.int8r_search_ops(2 * b, n, d, k, index.refine_r)
    e_ops, e_bytes = flops_mla_moe.expert_work(
        g, rank, int(sum(int(gmask[j]) for j in rows)))
    return {"bf16": fl, "int8": ops["int8"], "f32": ops["f32"],
            "expert_ops": e_ops, "expert_bytes": e_bytes}


def window(state, seconds: float, trace: bool):
    """``train_jsa.window`` counting the work with this module's
    ``step_work``; the profiled steps' grouped expert products in
    ``counters`` (``expert_ops``, ``expert_bytes``, ``traced_steps``).
    ``train_jsa.window`` asks a step's work once a precision, so a step's
    experts are counted at its first ask."""
    acc = {"expert_ops": 0.0, "expert_bytes": 0.0, "traced_steps": 0}
    last = []

    def work(ctx, batch, index):
        w = step_work(ctx, batch, index)
        if torch.autograd._profiler_enabled() and not (last and last[0]
                                                       is batch):
            acc["expert_ops"] += w["expert_ops"]
            acc["expert_bytes"] += w["expert_bytes"]
            acc["traced_steps"] += 1
        last[:] = [batch]
        return w

    old = train_jsa.step_work
    train_jsa.step_work = work
    try:
        win = train_jsa.window(state, seconds, trace)
    finally:
        train_jsa.step_work = old
    if trace and acc["traced_steps"]:
        win.counters.update(acc)
    return win


def margin(ctx) -> float:
    return float(ctx.limits["route_faults"]["margin"])


def compare(run: dict, ref: dict, o: dict) -> dict:
    """``train_jsa.compare``, ``route_faults`` (exact) and
    ``route_weight_gap`` (the largest over every real token, MoE layer and
    expert taken), over the judged steps."""
    out = train_jsa.compare(run, ref, o)
    out["route_faults"] = sum(st["route_faults"] for st in ref["steps"])
    out["route_weight_gap"] = max(st["route_weight_gap"]
                                  for st in ref["steps"])
    return out


def check(ctx, outs) -> list:
    questions = [(st["question"], st["answer"]) for st in outs["steps"]]
    ref = ref_moe.run(ctx, questions, follow=outs, margin=margin(ctx))
    return checks_against(ctx.limits, compare(
        outs, ref, {**ctx.config["recipe"], **ctx.traffic["options"]}))


def control_numbers(ctx) -> dict:
    """The control's compared numbers for one seed: the reference with fp8
    products in the generator and the towers (bf16 stated) in the
    program's place, followed by the float32 reference as a run is."""
    qs = [train_jsa.qa_batch(ctx, s) for s in
          range(int(ctx.traffic["judged_steps"]))]
    qs = [(q[0], a[0]) for q, a in qs]
    ctrl = ref_moe.run(ctx, qs, gen_kind="fp8", tower_kind="fp8")
    from ..harness import free
    free(ctx.device)
    judge = ref_moe.run(ctx, qs, follow=ctrl, margin=margin(ctx))
    return compare(ctrl, judge, {**ctx.config["recipe"],
                                 **ctx.traffic["options"]})


def route_gaps(ctx, outs) -> tuple[dict, np.ndarray, np.ndarray]:
    """For setting ``route_faults.margin``: the f32 reference following the
    readings ``outs`` (a run's, or the control's) with no margin, and over
    every real (token, MoE layer) of the judged steps its gap between its
    k-th and (k+1)-th router probabilities: -> (the reference's readings,
    the gaps where ``outs``'s experts differ from the reference's own
    top-k, every gap)."""
    questions = [(st["question"], st["answer"]) for st in outs["steps"]]
    bad, every = [], []
    real = ref_moe.deepseek_v2._moe

    def spy(x, base, lora, c, scale, mm, route=None, m=None):
        out = real(x, base, lora, c, scale, mm, route, m)
        if route is not None and torch.is_grad_enabled():
            given, ok = route
            probs = ref_moe.deepseek_v2.router_probs(x, base, mm).detach()
            k = c["num_experts_per_tok"]
            top = torch.topk(probs, k + 1, dim=-1)
            own = torch.sort(top.indices[:, :k], dim=-1).values
            other = torch.sort(given, dim=-1).values
            gap = top.values[:, k - 1] - top.values[:, k]
            bad.extend(gap[ok & (own != other).any(dim=-1)].tolist())
            every.extend(gap[ok].tolist())
        return out

    ref_moe.deepseek_v2._moe = spy
    try:
        ref = ref_moe.run(ctx, questions, follow=outs, margin=None)
    finally:
        ref_moe.deepseek_v2._moe = real
    return ref, np.asarray(bad), np.asarray(every)
