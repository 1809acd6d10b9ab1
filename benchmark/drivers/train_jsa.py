"""A closed loop of jsa training steps: each step a fresh batch of NQ-like
(question, answer) pairs from the seed, ``RAGModel.build_batch("jsa",
...)`` (both query towers, one search of both queries, the union, the
tokenisation) and then the step of ``train/step.py::make_train_step``
(the jsa loss over the towers and the generator, its backward, the AdamW
update).

Set-up builds the one step object and drives it through the first
``judged_steps`` steps, recording what they produced (the searches' ids,
the distributions, the candidates' log-likelihoods, the chain, the loss,
the first gradient as AdamW holds it, the trained leaves' change); the
window goes on with the same object. The reference follows those steps
once the window has closed.

Traffic parameters: ``options`` (the step's flags), ``words``,
``passage_words``, ``question_words``, ``answer_words``, ``judged_steps``,
``trace_after_s``, ``trace_steps``. End-to-end: ``train_examples_per_s``,
the examples of every step finished in the window over its seconds.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import inputs
from ..harness import Window, checks_against
from ..reference import jsa as ref_jsa
from ..reference import prompts as ref_prompts
from ..yardstick import flops
from ..yardstick.trace import Capture, span
from .common import Span, bert_config, filled_index, sync


def options(ctx):
    from jsa_rag_tpu_torch.config import Options

    keys = {f for f in Options.__dataclass_fields__}
    kw = {k: v for k, v in {**ctx.config["recipe"],
                            **ctx.traffic["options"]}.items() if k in keys}
    return Options(**kw, seed=ctx.seed, device=str(ctx.device))


def lm_config(g: dict, remat: bool, dropout: float):
    from jsa_rag_tpu_torch.models.lm import LMConfig

    return LMConfig(vocab_size=g["vocab_size"], hidden=g["hidden_size"],
                    layers=g["num_hidden_layers"],
                    heads=g["num_attention_heads"],
                    kv_heads=g["num_key_value_heads"],
                    intermediate=g["intermediate_size"],
                    rope_theta=float(g["rope_theta"]),
                    rms_eps=float(g["rms_norm_eps"]),
                    tie_embeddings=bool(g["tie_word_embeddings"]),
                    dtype=getattr(torch, g["torch_dtype"]), arch="llama",
                    remat=remat, dropout=dropout)


def qa_batch(ctx, step: int) -> tuple[list, list]:
    t = ctx.traffic
    pairs = [inputs.qa_pair(inputs.derive_seed(ctx.seed, "qa"), step, row,
                            int(t["words"]), t["question_words"],
                            t["answer_words"])
             for row in range(int(t["options"]["per_gpu_batch_size"]))]
    return [q for q, _ in pairs], [a for _, a in pairs]


def setup(ctx):
    from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer
    from jsa_rag_tpu_torch.models.bert import BertEncoder
    from jsa_rag_tpu_torch.models.lora import LoRAConfig
    from jsa_rag_tpu_torch.models.retriever import (DualEncoderRetriever,
                                                    RetrieverConfig)
    from jsa_rag_tpu_torch.train.modes import StepRng
    from jsa_rag_tpu_torch.train.optim import set_optim
    from jsa_rag_tpu_torch.train.rag_model import RAGModel
    from jsa_rag_tpu_torch.train.step import make_train_step

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    opt = options(ctx)
    r, g = c["retriever"], c["generator"]
    # the towers and the generator drop out at the recipe's --dropout, as
    # the program's model_io builds them
    bcfg = bert_config(c, opt.use_gradient_checkpoint_retriever, opt.dropout)
    weights = inputs.bert_weights(r, inputs.derive_seed(ctx.seed, "tower"),
                                  dev, torch.float32)
    # one bge tower's weights start the prior's two towers and the
    # posterior's query tower, as one checkpoint does in the recipe
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
    gcfg = lm_config(g, opt.use_gradient_checkpoint_generator, opt.dropout)
    gen = inputs.lm_weights(g, inputs.derive_seed(ctx.seed, "generator"),
                            dev, gcfg.dtype)
    lora = inputs.lora_weights(g, opt.lora_rank,
                               inputs.derive_seed(ctx.seed, "lora"), dev)
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


# the tokenised rows of a step's batch that the reference judges
ROWS = ("q_ids", "q_mask", "post_q_ids", "post_q_mask", "union_passage_ids",
        "union_passage_mask", "union_valid", "gen_ids", "gen_labels",
        "gen_mask")


class DropoutSeeds:
    """While ``recording()`` is open, the dropout seeds of every model call
    that drops out, in order, each site's beside the shape its mask was
    drawn at: ``take()`` -> ``[{"seeds", "shapes"}]`` since the last
    ``take``. It wraps the program's seed split and dropout, and calls
    them as they are."""

    def __init__(self):
        self.calls, self.drawn = [], {}

    @contextlib.contextmanager
    def recording(self):
        from jsa_rag_tpu_torch.models import bert, lm

        split, drop = bert.split_seeds, bert.dropout

        def split_seeds(rng, n):
            seeds = split(rng, n)
            if rng is not None:
                self.calls.append(seeds)
            return seeds

        def dropout(x, rate, seed):
            if seed is not None and rate > 0.0:
                self.drawn[seed] = tuple(x.shape)
            return drop(x, rate, seed)

        mods = (bert, lm)
        old = [(m.split_seeds, m.dropout) for m in mods]
        for m in mods:
            m.split_seeds, m.dropout = split_seeds, dropout
        try:
            yield self
        finally:
            for m, (a, b) in zip(mods, old):
                m.split_seeds, m.dropout = a, b

    def take(self) -> list:
        out = [{"seeds": list(seeds),
                "shapes": [self.drawn.get(x) for x in seeds]}
               for seeds in self.calls]
        self.calls, self.drawn = [], {}
        return out


def _host(x) -> np.ndarray:
    return torch.as_tensor(x).detach().cpu().numpy()


def judged_steps(state, n: int) -> dict:
    """The first ``n`` steps through the window's own call, with what the
    reference compares recorded: per step the ids, the distributions, the
    candidates' log-likelihoods, the chain, the loss, the dropout seeds
    and the tokenised rows; the first gradient of every trained leaf as
    AdamW holds it (mu / (1 - b1) after one update); each trained leaf's
    change over the ``n`` steps."""
    ctx, model, params, tx = (state["ctx"], state["model"], state["params"],
                              state["tx"])
    trained = [i for i, lab in enumerate(tx.labels) if lab != "frozen"]
    names = ["/".join(tx.paths[i]) for i in trained]
    start = [tx.leaves[i].detach().clone() for i in trained]
    steps, grad_norms = [], {}
    seeds = DropoutSeeds()
    for s in range(n):
        queries, targets = qa_batch(ctx, s)
        batch = model.build_batch("jsa", state["index"], params, queries,
                                  targets)
        info = model.last_info
        with seeds.recording():
            loss, aux = state["step"](params, batch, state["rng"])
        steps.append({
            "dropout": seeds.take(),
            "rows": {k: _host(batch[k]) for k in ROWS},
            "question": queries[0], "answer": targets[0],
            "prior_ids": [int(x) for x in info["prior_retrieved_ids"]],
            "post_ids": [int(x) for x in info["post_retrieved_ids"]],
            "loss": float(loss),
            "prior_probs": _host(aux["debug/prior_probs"]),
            "post_probs": _host(aux["debug/post_probs"]),
            "log_lm": _host(aux["debug/log_lm"]),
            "sample_probs": _host(aux["debug/sample_probs"]),
            "proposals": _host(aux["debug/proposal_ids"]),
            "accepts": _host(aux["debug/accept_decisions"]),
            "uniforms": _host(aux["debug/uniform_draws"])})
        if s == 0:
            grad_norms = {nm: float(tx.mu[i].norm()) / (1 - tx.b1)
                          for nm, i in zip(names, trained)}
    delta = {nm: float((tx.leaves[i].detach() - p0).norm())
             for nm, i, p0 in zip(names, trained, start)}
    return {"steps": steps, "grad_norms": grad_norms, "delta_norms": delta}


def step_work(ctx, batch, index) -> dict:
    """The operations one step asks for, from its rows' real lengths."""
    c = ctx.config
    g, r = c["generator"], c["retriever"]
    rank = int(ctx.config["recipe"]["lora_rank"])
    gmask = _host(batch["gen_mask"]).sum(axis=1)
    labels = _host(batch["gen_labels"])
    n_lab = (labels[:, 1:] != -100).sum(axis=1)
    valid = _host(batch["union_valid"]).reshape(-1)
    u_tok = _host(batch["union_passage_mask"]).reshape(len(valid), -1).sum(1)
    b, u = batch["union_valid"].shape
    rows = [j for j in range(b * u) if valid[j]]
    fl = sum(flops.lm_lora_train_flops(g, rank, int(gmask[j]), int(n_lab[j]))
             for j in rows)
    for key in ("q_mask", "post_q_mask"):
        for n in _host(batch[key]).sum(axis=1):
            # the loss's forward and backward, the retrieval's forward
            fl += flops.bert_train_flops(r, int(n))
            fl += flops.bert_forward_flops(r, int(n))
    fl += sum(flops.bert_forward_flops(r, int(u_tok[j])) for j in rows)
    n, d = int(c["index"]["rows"]), int(c["index"]["dim"])
    k = int(ctx.traffic["options"]["n_context"])
    ops = flops.int8r_search_ops(2 * b, n, d, k, index.refine_r)
    return {"bf16": fl, "int8": ops["int8"], "f32": ops["f32"]}


def window(state, seconds: float, trace: bool) -> Window:
    ctx, model, params = state["ctx"], state["model"], state["params"]
    dev = ctx.device
    t = ctx.traffic
    b = int(t["options"]["per_gpu_batch_size"])
    cap = Capture(dev.type) if trace else None
    traced, stopped = None, False
    losses, batch_ms, step_spans = [], [], []
    work = {"bf16": 0.0, "int8": 0.0, "f32": 0.0}
    s = int(t["judged_steps"])
    done = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        if cap is not None and traced is None and \
                time.perf_counter() - t0 >= float(t["trace_after_s"]):
            sync(dev)
            cap.start()
            traced = done
        queries, targets = qa_batch(ctx, s + done)
        a = time.perf_counter()
        with span("train.build_batch"):
            batch = model.build_batch("jsa", state["index"], params, queries,
                                      targets)
        if trace:
            sync(dev)
            batch_ms.append((time.perf_counter() - a) * 1e3)
            work = {k: v + step_work(ctx, batch, state["index"])[k]
                    for k, v in work.items()}
            sp = Span(dev)
            sp.start()
        with span("train.step"):
            loss, _ = state["step"](params, batch, state["rng"])
        if trace:
            sp.stop()
            step_spans.append(sp)
        losses.append(loss.detach().reshape(()))
        done += 1
        if traced is not None and not stopped and \
                done - traced >= int(t["trace_steps"]):
            sync(dev)
            cap.stop()
            stopped = True
        paused = cap.pause_s if cap else 0.0
        if time.perf_counter() - paused >= deadline and (cap is None
                                                         or stopped):
            break
    sync(dev)
    elapsed = time.perf_counter() - t0 - paused
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    spans = {}
    if trace:
        spans = {"train.batch_ms": batch_ms,
                 "train.step_ms": [sp.ms() for sp in step_spans]}
    return Window(e2e={"train_examples_per_s": done * b / elapsed},
                  attempted=done * b, failed=failed * b, window_s=elapsed,
                  spans=spans, work=work,
                  trace=cap.trace() if cap else None)


def outputs(state) -> dict:
    return state["readings"]


def release(state) -> None:
    state.clear()


def check(ctx, outs) -> list:
    questions = [(st["question"], st["answer"]) for st in outs["steps"]]
    ref = ref_jsa.run(ctx, questions, follow=outs)
    return checks_against(ctx.limits, compare(
        outs, ref, {**ctx.config["recipe"], **ctx.traffic["options"]}))


def _leaf_gap(run: dict, ref: dict, keep: list) -> float:
    """The worst leaf's gap between two norms, against the reference's norm
    of that leaf or the median leaf's, whichever is larger."""
    med = float(np.median([ref[n] for n in keep]))
    return max(abs(run[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep)


def chain_faults(step: dict, o: dict) -> int:
    """Where a run's chain breaks the recipe's rule: the chain replayed in
    float64 over the run's own distributions, log-likelihoods, proposals
    and uniforms; the acceptances that differ from the run's, and the
    candidates whose share of the samples differs from the run's
    ``sample_probs``."""
    post = np.asarray(step["post_probs"], np.float64)
    samples, accepts = ref_jsa.chain(
        post, np.asarray(step["prior_probs"], np.float64),
        np.asarray(step["log_lm"], np.float64), step["proposals"],
        np.asarray(step["uniforms"], np.float64),
        float(o["temperature_lm"]), float(o["eps"]))
    bad = int((np.asarray(accepts)
               != np.asarray(step["accepts"]).astype(bool)).sum())
    if not o["use_all_mis"]:
        samples = samples[-max(min(int(o["mis_step"]),
                                   int(o["n_context"])), 1):]
    share = np.bincount(samples, minlength=len(post)) / len(samples)
    return bad + int((np.abs(share - np.asarray(step["sample_probs"],
                                                np.float64)) > 1e-6).sum())


def compare(run: dict, ref: dict, o: dict) -> dict:
    """The numbers that decide ``correct`` for the training cell (each
    over the judged steps): ``ids_gap`` (how far the searches' answers lie
    below the exact search's), ``probs_gap`` (prior and posterior over the
    union), ``log_lm_gap`` (each valid candidate's log-likelihood),
    ``grad_gap`` and ``update_gap`` (worst leaf; leaves whose first
    reference gradient is under a thousandth of the median leaf's are left
    out), ``chain_faults`` (exact, over the run's own chain) and
    ``token_faults`` (exact: the rows the run tokenised). The loss itself
    is not compared: neither the control nor a fault moves it three times
    past what sound runs read (``PERF.md``)."""
    ids_gap = max(s["ids_gap"] for s in ref["steps"])
    probs_gap = log_lm_gap = 0.0
    for a, b in zip(run["steps"], ref["steps"]):
        valid = np.asarray(b["post_probs"]) > 0
        for key in ("prior_probs", "post_probs"):
            probs_gap = max(probs_gap, float(np.abs(
                np.asarray(a[key], np.float64) - b[key]).max()))
        log_lm_gap = max(log_lm_gap, float(np.abs(
            np.asarray(a["log_lm"], np.float64)[valid]
            - b["log_lm"][valid]).max()))
    g_ref = ref["grad_norms"]
    med = float(np.median(list(g_ref.values())))
    keep = [n for n, v in g_ref.items() if v >= 1e-3 * med]
    missing = [n for n in g_ref if n not in run["grad_norms"]]
    if missing:
        raise KeyError(f"the run recorded no leaf {missing[0]!r}")
    return {"ids_gap": ids_gap, "probs_gap": probs_gap,
            "log_lm_gap": log_lm_gap,
            "chain_faults": sum(chain_faults(st, o) for st in run["steps"]),
            "token_faults": sum(st.get("token_faults", 0)
                                for st in ref["steps"]),
            "grad_gap": _leaf_gap(run["grad_norms"], g_ref, keep),
            "update_gap": _leaf_gap(run["delta_norms"], ref["delta_norms"],
                                    keep)}
