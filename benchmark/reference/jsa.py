"""The first steps of jsa training, by the plain reference: the reference
recipe's jsa step (``src/rag.py:1789-2172``) for one question a step, its
gradient clipping and its AdamW (``src/util.py:173-238``: two learning-rate
groups, a linear warmup into a half-period cosine, weight decay on every
trained leaf).

One step: the prior's and the posterior's query towers embed the question
and ``question [SEP] answer``; each searches the index exactly for its top
``n_context``; the union (posterior first, first occurrence) is embedded
by the passage tower (no gradient: query-side training); the prior's and
the posterior's distributions over it are softmaxes of the scores over
``temperature_jsa``; the generator scores every candidate (its
length-normalised CE); a Metropolis independence chain of ``mis_step``
proposals from the posterior, accepted with
``exp(lm' - lm) * prior' * post / (prior * post')``, gives the empirical
distribution ``p`` the loss is weighted by:
``sum p * CE - sum p * (log prior + log post)``.

Where it follows a run (``follow``), the reference judges that run's
searches against its own exact search, then continues from the run's ids
and the run's chain samples, so that a tie in the search or a draw on the
edge of an acceptance (bf16 moves a candidate's log-likelihood by ~0.1)
does not set the two apart; it judges the rows the run tokenised against
its own, and the run's chain on its own against
the recipe's rule (``drivers/train_jsa.py::chain_faults``). It also takes
the run's dropout seeds (the recipe's ``--dropout`` drops out in the query
towers, the union's passage tower and the generator's attention) and makes
the masks again from them (``dropout.py``). Without ``follow`` (the
control) it searches, draws its chain and its dropout seeds for itself.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import inputs
from . import bert, dropout, mistral, prompts
from .precision import Matmul, exact_f32
from .search import scan

B1 = 0.9


def schedule(kind: str, lr: float, warmup: int, total: int, step: int,
             ratio: float = 0.1) -> float:
    """The recipe's learning rate at update ``step`` (float32 arithmetic)."""
    f = np.float32
    warmup = max(1, warmup)
    s = f(step)
    if kind == "cosine":
        half = f(total * 0.5)
        if s < warmup:
            val = s / f(warmup)
        elif s < half:
            t = (s - f(warmup)) / max(half - f(warmup), f(1.0))
            val = f(ratio) + f(1 - ratio) * f(math.cos(f(0.5 * math.pi) * t))
        else:
            val = f(ratio)
    elif kind == "linear":
        val = ((f(1 - ratio) * s / f(warmup) + f(ratio)) if s < warmup else
               max(f(1.0) + f(ratio - 1) * (s - f(warmup))
                   / max(f(1.0), f(total - warmup)), f(0.0)))
    else:
        val = s / f(warmup) if s < warmup else f(1.0)
    return float(f(lr) * f(val))


def chain(post, prior, log_lm, proposals, uniforms, temperature_lm: float,
          eps: float):
    """The chain over one question's candidates (numpy float64) ->
    (samples, accepts)."""
    idx, pv_post, pv_prior, pv_lm = 0, 1.0, 1.0, 0.0
    samples, accepts = [], []
    for t, (prop, u) in enumerate(zip(proposals, uniforms)):
        prop = int(prop)
        c_post, c_prior, c_lm = float(post[prop]), float(prior[prop]), \
            float(log_lm[prop])
        ratio = math.exp(min(max((c_lm - pv_lm) / temperature_lm, -50.0),
                             50.0))
        alpha = ratio * c_prior * pv_post / (pv_prior * c_post + eps)
        acc = True if t == 0 else bool(u <= alpha)
        if acc:
            idx, pv_post, pv_prior, pv_lm = prop, c_post, c_prior, c_lm
        samples.append(idx)
        accepts.append(acc)
    return samples, accepts


class Reference:
    """The reference's model and optimizer state, built from the seed."""

    def __init__(self, ctx, gen_mm: Matmul, tower_mm: Matmul):
        c, t, dev = ctx.config, ctx.traffic, ctx.device
        self.ctx, self.dev = ctx, dev
        self.gen_mm, self.tower_mm = gen_mm, tower_mm
        self.g, self.r = c["generator"], c["retriever"]
        self.o = {**c["recipe"], **t["options"]}
        # the generator as published: stored in its ``torch_dtype``
        self.gen = inputs.lm_weights(self.g, inputs.derive_seed(
            ctx.seed, "generator"), dev, getattr(torch, self.g["torch_dtype"]))
        lora = inputs.lora_weights(self.g, int(self.o["lora_rank"]),
                                   inputs.derive_seed(ctx.seed, "lora"), dev)
        tower = inputs.bert_weights(self.r, inputs.derive_seed(
            ctx.seed, "tower"), dev, torch.float32)
        self.passage = tower
        self.prior_q = {k: v.clone().requires_grad_() for k, v in
                        tower.items()}
        self.post_q = {k: v.clone().requires_grad_() for k, v in
                       tower.items()}
        self.lora = {"layers": [{n: {"A": ab["A"].clone().requires_grad_(),
                                     "B": ab["B"].clone().requires_grad_()}
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

    # ------------------------------------------------------------- pieces
    def _rows(self, n, d):
        return inputs.unit_rows(inputs.derive_seed(self.ctx.seed, "rows"), n,
                                d, self.dev)

    def search(self, q_emb, k: int, probe=None):
        n, d = (int(self.ctx.config["index"]["rows"]),
                int(self.ctx.config["index"]["dim"]))
        return scan(q_emb.detach(), self._rows(n, d), k, probe=probe)

    def tokens(self, texts) -> list:
        maxlen = int(self.o["text_maxlength"])
        return [prompts.retriever_ids(self.vocab_r, x, maxlen)
                for x in texts]

    def embed(self, w, texts, grad: bool, drop=None):
        with torch.set_grad_enabled(grad):
            return bert.encode_rows(w, self.r, self.tokens(texts),
                                    self.tower_mm, self.dev, checkpoint=grad,
                                    drop=drop)

    def drops(self, follow, calls: list) -> list:
        """The dropout masks of the step's four calls that drop out (the
        prior's and the posterior's query towers, the union's passage
        tower, the generator), in the program's order: the run's seeds
        where the reference follows a run, else its own, drawn over its
        own padded ``calls`` ((kind, rows, length) each)."""
        if self.rate == 0.0:
            return [None] * len(calls)
        if follow is not None:
            got = follow["dropout"]
            if len(got) != len(calls):
                raise ValueError(f"the run dropped out in {len(got)} calls "
                                 f"a step, not {len(calls)}")
            return [dropout.Drop(self.rate, c["seeds"], c["shapes"])
                    for c in got]
        shapes = {"bert": lambda n, s: dropout.bert_shapes(self.r, n, s),
                  "lm": lambda n, s: dropout.generator_shapes(self.g, n, s)}
        return [dropout.draw(self.drop_gen, self.rate, shapes[k](n, s))
                for k, n, s in calls]

    def token_faults(self, got: dict, want: list, gen: tuple, nv: int) -> int:
        """Rows the run fed its towers and its generator that differ from
        the recipe's text handling: the two queries and the union's
        passages (``want``, at their real lengths), the generator's rows
        and labels (``gen``), and a union of another size."""
        def real(ids, mask):
            return np.asarray(ids)[np.asarray(mask).astype(bool)].tolist()

        have = [real(got["q_ids"][0], got["q_mask"][0]),
                real(got["post_q_ids"][0], got["post_q_mask"][0])] + [
            real(got["union_passage_ids"][0][j],
                 got["union_passage_mask"][0][j]) for j in range(nv)]
        bad = sum(a != b for a, b in zip(have, want))
        ids, labels, mask = gen
        for j in range(nv):
            m = np.asarray(got["gen_mask"][j]).astype(bool)
            bad += int(np.asarray(got["gen_ids"][j])[m].tolist()
                       != real(ids[j], mask[j])
                       or np.asarray(got["gen_labels"][j])[m].tolist()
                       != real(labels[j], mask[j]))
        return bad + int(int(np.asarray(got["union_valid"][0]).sum()) != nv)

    # --------------------------------------------------------------- step
    def step(self, s: int, question: str, answer: str, follow=None) -> dict:
        o = self.o
        k = int(o["n_context"])
        t_jsa, eps = float(o["temperature_jsa"]), float(o["eps"])
        post_text = f"{question} [SEP] {answer}"
        out = {"question": question, "answer": answer}
        pq = self.embed(self.prior_q, [question], False)
        po = self.embed(self.post_q, [post_text], False)
        probe = None
        if follow is not None:
            probe = torch.tensor([follow["prior_ids"], follow["post_ids"]],
                                 device=self.dev)
        top_s, top_i, got = self.search(torch.cat([pq, po]), k, probe)
        if follow is not None:
            out["ids_gap"] = float((top_s - got).max())
            prior_ids, post_ids = follow["prior_ids"], follow["post_ids"]
        else:
            prior_ids, post_ids = top_i[0].tolist(), top_i[1].tolist()
        out["prior_ids"], out["post_ids"] = list(prior_ids), list(post_ids)
        union = list(dict.fromkeys(list(post_ids) + list(prior_ids)))
        u_full = 2 * k
        nv = len(union)
        passages = [self.store[i] for i in union]
        u_text = [prompts.passage_text(p) for p in passages]
        ids, labels, mask = prompts.generator_rows(
            self.vocab_g, question, passages, answer,
            int(o["text_maxlength"]), int(o["target_maxlength"]))
        dev = self.dev
        drops = self.drops(follow, [
            ("bert", 1, len(self.tokens([question])[0])),
            ("bert", 1, len(self.tokens([post_text])[0])),
            ("bert", nv, max(len(r) for r in self.tokens(u_text))),
            ("lm", nv, ids.shape[1])])
        if self.rate:
            out["dropout"] = [d.record() for d in drops]
        if follow is not None and "rows" in follow:  # a run of the program
            out["token_faults"] = self.token_faults(
                follow["rows"], self.tokens([question, post_text] + u_text),
                (ids, labels, mask), nv)
        with torch.no_grad():
            u_emb = self.embed(self.passage, u_text, False, drops[2])
        prior_q = self.embed(self.prior_q, [question], True, drops[0])
        post_q = self.embed(self.post_q, [post_text], True, drops[1])
        prior_p = torch.softmax(self.tower_mm.mm(prior_q, u_emb.T)[0] / t_jsa,
                                dim=-1)
        post_p = torch.softmax(self.tower_mm.mm(post_q, u_emb.T)[0] / t_jsa,
                               dim=-1)
        scale = float(o["lora_alpha"]) / float(o["lora_rank"])
        ce = mistral.row_ce(self.gen, self.lora, self.g,
                            torch.as_tensor(ids, device=dev),
                            torch.as_tensor(mask, device=dev),
                            torch.as_tensor(labels, device=dev), self.gen_mm,
                            scale, float(o["temperature_gold"]), drops[3])
        pad = lambda x: np.concatenate(  # noqa: E731  (U slots, pads 0)
            [x, np.zeros(u_full - nv, x.dtype)])
        post_np = pad(post_p.detach().double().cpu().numpy())
        prior_np = pad(prior_p.detach().double().cpu().numpy())
        lm_np = (-ce).detach().double().cpu().numpy()
        lm_np = np.concatenate([lm_np, np.full(u_full - nv, lm_np[0])])
        mis = int(o["mis_step"])
        if follow is not None:
            # the run's own chain samples (the chain is held to the
            # recipe's rule by itself: benchmark/tests)
            p_np = np.asarray(follow["sample_probs"], np.float64)
        else:
            props, unif = self._draw(post_np, mis)
            samples, accepts = chain(post_np, prior_np, lm_np, props, unif,
                                     float(o["temperature_lm"]), eps)
            p_np = np.bincount(samples, minlength=u_full) / mis
            out.update(proposals=props, uniforms=unif,
                       accepts=np.asarray(accepts))
        p = torch.as_tensor(p_np[:nv], device=dev, dtype=torch.float32)

        def safe_log(x):
            return torch.log(torch.clamp_min(x, 1e-37))

        gen_term = torch.sum(p * ce)
        retr = torch.sum(p * (safe_log(prior_p + eps) + safe_log(post_p
                                                                  + eps)))
        loss = gen_term - retr
        names = list(self.leaves)
        grads = torch.autograd.grad(loss, [self.leaves[n] for n in names],
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(self.leaves[n]))
                 for n, g in zip(names, grads)}
        clipped = self._update(grads)
        out.update(loss=float(loss.detach()), prior_probs=prior_np,
                   post_probs=post_np, log_lm=lm_np, sample_probs=p_np,
                   grad_norms={n: float(g.norm()) for n, g in clipped.items()})
        return out

    def _draw(self, post, mis: int):
        """Proposals from the posterior by inverse CDF and acceptance
        uniforms, from the run's chain seed."""
        post_t = torch.as_tensor(post, dtype=torch.float32, device=self.dev)
        cdf = torch.cumsum(post_t, dim=-1)
        r = torch.rand((1, mis), generator=self.mis_gen,
                       device=self.dev) * cdf[-1:]
        props = torch.searchsorted(cdf, r[0], right=True).clamp_max(
            len(post) - 1)
        unif = torch.rand((mis, 1), generator=self.mis_gen, device=self.dev)
        return props.cpu().numpy(), unif[:, 0].double().cpu().numpy()

    @torch.no_grad()
    def _update(self, grads: dict) -> dict:
        """Global-norm clip and AdamW -> the clipped gradients."""
        o = self.o
        norm = torch.sqrt(sum((g.float() * g).sum() for g in grads.values()))
        clip = float(o["clip"])
        factor = 1.0 if float(norm) < clip else clip / float(norm)
        b2, e, wd = float(o["beta2"]), float(o["epsilon"]), \
            float(o["weight_decay"])
        t = self.count + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.int32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.int32(t))
        lrs = {"lm": schedule(o["scheduler"], float(o["lr"]),
                              int(o["warmup_steps"]), int(o["total_steps"]),
                              self.count),
               "retr": schedule(o["scheduler"], float(o["lr_retriever"]),
                                int(o["warmup_steps"]),
                                int(o["total_steps"]), self.count)}
        clipped = {}
        for n, g in grads.items():
            g = g.float() * factor if factor != 1.0 else g.float()
            clipped[n] = g
            self.mu[n] = g * (1 - B1) + self.mu[n] * B1
            self.nu[n] = g * g * (1 - b2) + self.nu[n] * b2
            u = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + e)
            p = self.leaves[n]
            u = u + p * wd
            p.add_(u * -lrs[self.labels[n]])
        self.count = t
        return clipped


def run(ctx, questions, follow=None, gen_kind: str = "f32",
        tower_kind: str = "f32") -> dict:
    """The reference over the steps' (question, answer) pairs -> readings in
    the form the program's are recorded in, with ``delta_norms`` (each
    trained leaf's change over the steps) and ``grad_norms`` of the first
    step."""
    exact_f32()
    ref = Reference(ctx, Matmul(gen_kind), Matmul(tower_kind))
    start = {n: v.detach().clone() for n, v in ref.leaves.items()}
    steps = []
    for s, (q, a) in enumerate(questions):
        steps.append(ref.step(s, q, a, None if follow is None
                              else follow["steps"][s]))
    delta = {n: float((v.detach() - start[n]).norm())
             for n, v in ref.leaves.items()}
    return {"steps": steps, "grad_norms": steps[0].pop("grad_norms"),
            "delta_norms": delta}
