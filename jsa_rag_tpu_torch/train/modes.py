"""The training losses: concat, rag, vrag and jsa with its MIS chain
(counterpart of ``jsa_rag_tpu/train/modes.py``).

Each mode is a function ``loss(fns, params, batch, rng) -> (scalar, aux)``
over token tensors; retrieval, the union and tokenisation happen host-side
in ``rag_model.py``. The generator scores each unique union candidate once,
with gradient; the MIS chain reads detached per-candidate log-probs, and the
loss weights the same per-candidate CE by the chain's empirical
distribution (``modes.py:1-18``).

``params`` is the port's dict: ``retriever`` / ``post_retriever`` are
``DualEncoderRetriever`` modules, ``generator`` / ``lora`` dicts of tensors.
``rng`` is a ``StepRng``: a CPU generator for the dropout seeds and a
generator on the model's device for the MIS draws. ``mis_chain`` takes the
proposals and uniforms as inputs; ``draw_mis`` draws them, so a test can
replay another run's draws (torch's Philox and JAX's threefry differ).
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.lm import LMConfig, lm_loss
from ..models.lora import LoRAConfig, gen_params
from ..models.retriever import DualEncoderRetriever
from ..utils import trace

NEG_INF = -1e30


@dataclasses.dataclass
class StepRng:
    """One step's randomness: ``dropout`` (CPU) yields the per-layer
    dropout seeds, ``mis`` (on the model's device) the MIS draws."""
    dropout: torch.Generator
    mis: torch.Generator

    @classmethod
    def from_seed(cls, seed: int, device) -> "StepRng":
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(seed))


@dataclasses.dataclass(frozen=True)
class ApplyFns:
    """Static configuration threaded into the losses (``modes.py:36-88``)."""
    gen_cfg: LMConfig
    lora_cfg: LoRAConfig | None = None
    temperature_gold: float = 1.0
    temperature_score: float = 1.0
    temperature_jsa: float = 1.0
    temperature_lm: float = 1.0
    mis_step: int = 50
    mis_topk: int = 0
    n_context: int = 10
    use_all_mis: bool = True
    standard_mc: bool = False
    union_kl: bool = True
    kl_beta: float = 1.0
    simplify_jsa: bool = False
    decouple: bool = False
    contrastive: bool = False
    reduce_norm: bool = False
    eps: float = 1e-30
    # train-time dropout gate: eval forwards use a copy with it off
    train_dropout: bool = False

    def gen_params(self, params):
        return gen_params(params, self.lora_cfg,
                          getattr(self.gen_cfg, "tp", None))

    def expand(self, params):
        """With ``decouple_encoder`` the posterior owns only a query tower
        and reads the prior's passage tower, paired in here so its gradient
        accumulates from both retrievers; with no posterior at all
        (simplify_JSA) the prior serves both roles."""
        out = dict(params)
        post = params.get("post_retriever")
        if post is None:
            out["post_retriever"] = params["retriever"]
        elif self.decouple:
            out["post_retriever"] = DualEncoderRetriever(
                post.cfg, towers={"query": post.query,
                                  "passage": params["retriever"].passage})
        return out


def _dropout_rng(fns: ApplyFns, rng):
    return rng.dropout if (fns.train_dropout and rng is not None) else None


def _per_row_ce(fns: ApplyFns, params, gen_ids, gen_labels, gen_mask,
                rng=None):
    """Length-normalised CE per row (reference: src/rag.py:1349-1366)."""
    per_seq, _ = lm_loss(fns.gen_params(params), fns.gen_cfg, gen_ids,
                         gen_mask, gen_labels,
                         logit_temp=fns.temperature_gold, rng=rng)
    return per_seq


def _embed_rows(retriever, ids, mask, *, is_passages, rng=None):
    """(B, K, L) token tensors -> (B, K, H) embeddings."""
    b, k, l = ids.shape
    emb = retriever.embed(ids.reshape(b * k, l), mask.reshape(b * k, l),
                          is_passages=is_passages, rng=rng)
    return emb.reshape(b, k, -1)


def _doc_scores(q_emb, p_emb):
    return torch.einsum("bh,bkh->bk", q_emb.to(torch.float32),
                        p_emb.to(torch.float32))


def _safe_log(x):
    return torch.log(torch.clamp_min(x, 1e-37))


def _entropy(p):
    return torch.mean(-torch.sum(p * _safe_log(p), dim=-1))


def concat_loss(fns: ApplyFns, params, batch, rng=None):
    """Generator-only fine-tuning on the retrieved passages
    (``modes.py:125-132``; reference: src/rag.py:1286-1366). No retriever
    gradient. batch: gen_ids/gen_labels/gen_mask."""
    per_seq = _per_row_ce(fns, params, batch["gen_ids"], batch["gen_labels"],
                          batch["gen_mask"], rng=_dropout_rng(fns, rng))
    loss = torch.mean(per_seq)
    return loss, {"loss/generator_loss": loss.detach()}


def rag_loss(fns: ApplyFns, params, batch, rng=None):
    """RAG-sequence marginal likelihood (``modes.py:136-158``; reference:
    src/rag.py:1367-1567): p(y|x) = sum_z softmax(score(x, z)) exp(-CE_z);
    the retriever learns through the marginal.

    batch: q_ids/q_mask (B, L); passage_ids/passage_mask (B, K, L);
    gen_ids/gen_labels/gen_mask (B*K, L'), row b*K+k = (query b, passage
    k)."""
    prior = params["retriever"]
    drop = _dropout_rng(fns, rng)
    q_emb = prior.embed_queries(batch["q_ids"], batch["q_mask"], rng=drop)
    p_emb = _embed_rows(prior, batch["passage_ids"], batch["passage_mask"],
                        is_passages=True, rng=drop)
    scores = _doc_scores(q_emb, p_emb)  # (B, K)
    b, k, _ = batch["passage_ids"].shape
    ce = _per_row_ce(fns, params, batch["gen_ids"], batch["gen_labels"],
                     batch["gen_mask"], rng=drop).reshape(b, k)
    p_z = torch.softmax(scores, dim=-1)
    p_y = torch.sum(p_z * torch.exp(-ce), dim=-1) + fns.eps
    loss = -torch.mean(torch.log(p_y))
    return loss, {"loss/generator_loss": loss.detach(),
                  "train/prior_entropy": _entropy(p_z.detach())}


def vrag_loss(fns: ApplyFns, params, batch, rng=None):
    """Variational RAG (``modes.py:162-231``; reference:
    src/rag.py:1568-1788): generator CE on the posterior's top-k weighted by
    the posterior (mean CE under ``standard_mc``), plus kl_beta x
    KL(posterior || prior) over the prior/posterior union (``union_kl``,
    each side scoring the union with its own towers) or over the posterior's
    top-k. The CE weights use the posterior tempered by temperature_score;
    the KL distributions are untempered, as in the reference.

    batch: q_ids/q_mask, post_q_ids/post_q_mask (B, L); post_passage_ids/
    post_passage_mask (B, K, L); gen_* (B*K, L'); optional post_valid (B, K)
    (use_file pads); with union_kl union_passage_ids/union_passage_mask
    (B, U, L) and union_valid (B, U)."""
    params = fns.expand(params)
    prior, post = params["retriever"], params["post_retriever"]
    drop = _dropout_rng(fns, rng)
    prior_q = prior.embed_queries(batch["q_ids"], batch["q_mask"], rng=drop)
    post_q = post.embed_queries(batch["post_q_ids"], batch["post_q_mask"],
                                rng=drop)
    post_p = _embed_rows(post, batch["post_passage_ids"],
                         batch["post_passage_mask"], is_passages=True,
                         rng=drop)
    post_scores = _doc_scores(post_q, post_p)  # (B, K)
    if "post_valid" in batch:
        # use_file pads short supplied lists with duplicates: no mass
        post_scores = torch.where(batch["post_valid"], post_scores, NEG_INF)
    posterior_dist = torch.softmax(post_scores / fns.temperature_score,
                                   dim=-1) + fns.eps

    b, k, _ = batch["post_passage_ids"].shape
    ce = _per_row_ce(fns, params, batch["gen_ids"], batch["gen_labels"],
                     batch["gen_mask"], rng=drop).reshape(b, k)
    if fns.standard_mc:
        loss = torch.mean(torch.mean(ce, dim=-1))
    else:
        loss = torch.mean(torch.sum(posterior_dist * ce, dim=-1))

    if fns.union_kl:
        u_ids, u_mask = batch["union_passage_ids"], batch["union_passage_mask"]
        valid = batch["union_valid"]  # (B, U) bool
        prior_u = _embed_rows(prior, u_ids, u_mask, is_passages=True,
                              rng=drop)
        post_u = _embed_rows(post, u_ids, u_mask, is_passages=True, rng=drop)
        prior_logits = torch.where(valid, _doc_scores(prior_q, prior_u),
                                   NEG_INF)
        post_logits = torch.where(valid, _doc_scores(post_q, post_u),
                                  NEG_INF)
        log_prior = torch.log_softmax(prior_logits, dim=-1)
        post_dist = torch.softmax(post_logits, dim=-1)
        kl = torch.mean(torch.sum(torch.where(
            valid, post_dist * (_safe_log(post_dist) - log_prior), 0.0),
            dim=-1))
    else:
        # the prior's scores on the posterior's top-k (post-tower passage
        # embeddings, src/rag.py:1765-1782); use_file pads masked
        prior_scores = _doc_scores(prior_q, post_p)
        if "post_valid" in batch:
            prior_scores = torch.where(batch["post_valid"], prior_scores,
                                       NEG_INF)
        log_prior = torch.log_softmax(prior_scores, dim=-1)
        kl = torch.mean(torch.sum(
            posterior_dist * (_safe_log(posterior_dist) - log_prior), dim=-1))
    total = loss + fns.kl_beta * kl
    return total, {"loss/generator_loss": loss.detach(), "KL": kl.detach()}


def jsa_loss(fns: ApplyFns, params, batch, rng: StepRng | None):
    """JSA: Metropolis-Independence-Sampling over the prior/posterior union
    (``modes.py:235-385``; reference: src/rag.py:1789-2172).

    batch: q_ids/q_mask, post_q_ids/post_q_mask (B, L); union_passage_ids/
    union_passage_mask (B, U, L); union_valid (B, U) bool; gen_ids/
    gen_labels/gen_mask (B*U, L'), row b*U+u = (query b, candidate u)."""
    params = fns.expand(params)
    prior, post = params["retriever"], params["post_retriever"]
    b, u, _ = batch["union_passage_ids"].shape
    drop = _dropout_rng(fns, rng)

    with trace.span("jsa.towers"):
        prior_q = prior.embed_queries(batch["q_ids"], batch["q_mask"],
                                      rng=drop)
        post_q = post.embed_queries(batch["post_q_ids"], batch["post_q_mask"],
                                    rng=drop)
        # the union embedded with the posterior's passage tower for both
        # scores (reference: src/rag.py:1855-1875)
        union_emb = _embed_rows(post, batch["union_passage_ids"],
                                batch["union_passage_mask"], is_passages=True,
                                rng=drop)
        valid = batch["union_valid"]
        prior_logits = torch.where(
            valid, _doc_scores(prior_q, union_emb) / fns.temperature_jsa,
            NEG_INF)
        post_logits = torch.where(
            valid, _doc_scores(post_q, union_emb) / fns.temperature_jsa,
            NEG_INF)
        prior_probs = torch.softmax(prior_logits, dim=-1)
        post_probs = torch.softmax(post_logits, dim=-1)

    # one generator forward over every unique candidate, with gradient
    with trace.span("jsa.generator"):
        per_seq = _per_row_ce(fns, params, batch["gen_ids"],
                              batch["gen_labels"], batch["gen_mask"],
                              rng=drop)
    ce = per_seq.reshape(b, u)
    log_lm = (-ce).detach()  # get_llm_score (src/rag.py:2328)
    post_sg = post_probs.detach()
    prior_sg = prior_probs.detach()

    if fns.simplify_jsa:
        probabilities = post_sg
        accept_rate = torch.ones((), device=ce.device)
    else:
        with trace.span("jsa.mis"):
            proposals, uniforms = draw_mis(rng.mis, post_sg, fns.mis_step)
            sampled, accept_rate, chain_info = mis_chain(
                post_sg, prior_sg, log_lm, proposals, uniforms,
                temperature_lm=fns.temperature_lm, eps=fns.eps)
            if fns.use_all_mis:
                probabilities = empirical_distribution(sampled, u)
            else:
                # last-K chain states, uniform weights (src/rag.py:2008)
                k_last = max(min(fns.mis_step, fns.n_context), 1)
                probabilities = empirical_distribution(sampled, u,
                                                       last_k=k_last)
            if fns.mis_topk:
                # keep the mis_topk most-sampled candidates, not
                # renormalised (src/rag.py:1981-1986)
                topk = min(fns.mis_topk, probabilities.shape[-1])
                thresh = -torch.sort(-probabilities,
                                     dim=-1).values[:, topk - 1]
                probabilities = torch.where(
                    probabilities >= thresh[:, None], probabilities, 0.0)

    gen_term = torch.sum(probabilities * ce, dim=-1)  # (B,)
    if fns.contrastive:
        # expected log-softmax of the sampled candidates against the union
        # and, when the batch carries them, sampled negatives
        # (src/rag.py:2016-2041)
        pl_all, po_all = prior_logits, post_logits
        if "neg_passage_ids" in batch:
            neg_prior = _embed_rows(prior, batch["neg_passage_ids"],
                                    batch["neg_passage_mask"],
                                    is_passages=True)
            neg_post = _embed_rows(post, batch["neg_passage_ids"],
                                   batch["neg_passage_mask"],
                                   is_passages=True)
            pl_all = torch.cat(
                [prior_logits,
                 _doc_scores(prior_q, neg_prior) / fns.temperature_jsa], -1)
            po_all = torch.cat(
                [post_logits,
                 _doc_scores(post_q, neg_post) / fns.temperature_jsa], -1)
        retr_term = (
            torch.sum(probabilities
                      * torch.log_softmax(pl_all, -1)[:, :u], -1)
            + torch.sum(probabilities
                        * torch.log_softmax(po_all, -1)[:, :u], -1))
    elif fns.reduce_norm:
        # norm control (src/rag.py:2042-2068): raw-score contrast with the
        # query embedding detached
        prior_raw = torch.where(
            valid, _doc_scores(prior_q.detach(), union_emb), 0.0)
        post_raw = torch.where(
            valid, _doc_scores(post_q.detach(), union_emb), 0.0)
        prior_obj = (torch.sum(probabilities * prior_raw, -1)
                     - torch.sum(prior_sg * prior_raw, -1))
        post_obj = (torch.sum(probabilities * post_raw, -1)
                    - torch.sum(post_sg * post_raw, -1))
        retr_term = (
            torch.sum(probabilities * _safe_log(prior_probs + fns.eps), -1)
            + prior_obj
            + torch.sum(probabilities * _safe_log(post_probs + fns.eps), -1)
            + post_obj)
    else:
        retr_term = torch.sum(
            probabilities * (_safe_log(prior_probs + fns.eps)
                             + _safe_log(post_probs + fns.eps)), dim=-1)
    loss = torch.mean(gen_term - retr_term)
    aux = {
        "loss/generator_loss": torch.mean(gen_term).detach(),
        "accept_rate": accept_rate,
        "train/post_entropy": _entropy(post_sg),
        # first-example introspection arrays for training_info dumps
        "debug/prior_probs": prior_sg[0],
        "debug/post_probs": post_sg[0],
        "debug/log_lm": log_lm[0],
        "debug/sample_probs": probabilities[0].detach(),
    }
    if not fns.simplify_jsa:
        aux["debug/proposal_ids"] = chain_info["proposals"][:, 0]
        aux["debug/accept_decisions"] = chain_info["accepts"][:, 0]
        aux["debug/uniform_draws"] = chain_info["uniforms"][:, 0]
    return loss, aux


def draw_mis(gen: torch.Generator, post_probs, mis_step: int):
    """The chain's random inputs: ``mis_step`` proposals per row drawn from
    the posterior (categorical, by inverse CDF: no host sync) and as many
    uniforms in [0, 1) -> ((mis_step, B) int64, (mis_step, B) f32), on
    ``post_probs``'s device. Zero-probability candidates are never drawn."""
    b, u = post_probs.shape
    dev = post_probs.device
    cdf = torch.cumsum(post_probs, dim=-1)
    r = torch.rand((b, mis_step), generator=gen, device=dev) * cdf[:, -1:]
    proposals = torch.searchsorted(cdf, r, right=True).clamp_max(u - 1).T
    uniforms = torch.rand((mis_step, b), generator=gen, device=dev)
    return proposals, uniforms


def mis_chain(post_probs, prior_probs, log_lm, proposals, uniforms, *,
              temperature_lm: float = 1.0, eps: float = 1e-30):
    """Metropolis-Independence-Sampling chain over union candidates
    (``modes.py:388-449``; reference: src/rag.py:1887-1961), batched.

    Proposal z' ~ posterior (the given ``proposals``); acceptance
      alpha = exp((log_lm' - log_lm)/T_lm) * prior' * post / (prior * post')
    tested against the given ``uniforms``; the first step always accepts.
    Returns (sampled ids (mis_step, B) int32, accept rate over steps 2..n,
    {"proposals", "accepts", "uniforms"})."""
    b = post_probs.shape[0]
    dev = post_probs.device
    rows = torch.arange(b, device=dev)
    idx = torch.zeros((b,), dtype=torch.int32, device=dev)
    pv_post = torch.ones((b,), device=dev)
    pv_prior = torch.ones((b,), device=dev)
    pv_lm = torch.zeros((b,), device=dev)
    sampled, accepts = [], []
    for step in range(proposals.shape[0]):
        prop = proposals[step].long()
        c_post = post_probs[rows, prop]
        c_prior = prior_probs[rows, prop]
        c_lm = log_lm[rows, prop]
        ratio = torch.exp(torch.clamp((c_lm - pv_lm) / temperature_lm,
                                      -50.0, 50.0))
        alpha = ratio * c_prior * pv_post / (pv_prior * c_post + eps)
        accept = uniforms[step] <= alpha
        if step == 0:
            accept = torch.ones_like(accept)
        idx = torch.where(accept, prop.to(torch.int32), idx)
        pv_post = torch.where(accept, c_post, pv_post)
        pv_prior = torch.where(accept, c_prior, pv_prior)
        pv_lm = torch.where(accept, c_lm, pv_lm)
        sampled.append(idx)
        accepts.append(accept)
    sampled = torch.stack(sampled)
    accepts = torch.stack(accepts)
    if accepts.shape[0] > 1:
        accept_rate = accepts[1:].to(torch.float32).mean()
    else:
        # mis_step=1: only the always-accepted first step exists
        accept_rate = torch.ones((), device=dev)
    info = {"proposals": proposals, "accepts": accepts, "uniforms": uniforms}
    return sampled, accept_rate, info


def empirical_distribution(sampled, n_candidates: int,
                           last_k: int | None = None):
    """(mis_step, B) sampled ids -> (B, n_candidates) empirical probs."""
    if last_k is not None:
        sampled = sampled[-last_k:]
    onehot = torch.nn.functional.one_hot(sampled.long(), n_candidates).to(
        torch.float32)
    return onehot.sum(dim=0) / sampled.shape[0]


MODE_LOSSES = {
    "concat": concat_loss,
    "rag": rag_loss,
    "vrag": vrag_loss,
    "jsa": jsa_loss,
}
