"""RAG orchestration: retrieval, live rescoring, index build, the jsa
training batch and loss, and generation.

Counterpart of ``jsa_rag_tpu/train/rag_model.py``. Host side as in the JAX
package: tokenisation, id -> passage resolution, the prior/posterior union
and the fast_deocde1/2 selection run on numpy; the towers, the index search,
the losses and the decode run on the model's device. ``params`` is the dict
of ``model_io.load_or_initialize_model``: ``params["retriever"]`` (and, in
the jsa mode, ``params["post_retriever"]``) is the ``DualEncoderRetriever``
module whose weights a call uses, ``params["generator"]``/``params["lora"]``
the generator's tensors.

Training covers every mode: ``retrieval_ctx``/``build_batch`` search with
``retrieve`` (one tower) for rag and concat and with ``retrieve_pair`` plus
``build_union`` for vrag and jsa; ``loss_and_grad_fn`` differentiates the
mode's loss. Under ``--retrieve_with_rerank`` every search over-retrieves
``max(n_to_rerank_with_retrieve_with_rerank, k)`` candidates and re-sorts
them by the live passage tower's re-embedding (``rag_model.py:287-306``);
``retrieve_pair`` then takes two ``retrieve`` calls, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import Options
from ..data.passages import PassageStore
from ..data.prompts import (PromptConfig, build_generation_batch,
                            build_training_batch, global_max_len)
from ..device import resolve_device
from ..index.build import build_index as _build_index, make_encode_fn
from ..index.flat import ShardedFlatIndex
from ..models.lm import (LMConfig, beam_generate, greedy_generate,
                         lm_loss, lm_sequence_logprob)
from ..models.lora import LoRAConfig
from ..models.retriever import DualEncoderRetriever
from ..parallel.mesh import process_count
from ..utils import trace
from .modes import MODE_LOSSES, ApplyFns

BERT_MAX_SEQ_LENGTH = 512  # reference: src/rag.py:40


class RAGModel:
    def __init__(
        self,
        opt: Options,
        retriever: DualEncoderRetriever,
        gen_cfg: LMConfig,
        retriever_tokenizer,
        generator_tokenizer,
        store: PassageStore,
        lora_cfg: LoRAConfig | None = None,
    ):
        self.opt = opt
        self.device = resolve_device(opt.device)
        self.retriever = retriever
        self.gen_cfg = gen_cfg
        self.lora_cfg = lora_cfg
        self.retriever_tokenizer = retriever_tokenizer
        self.generator_tokenizer = generator_tokenizer
        self.store = store
        self.prompt_cfg = PromptConfig(
            family=opt.generator_model_type,
            concat_doc=opt.concat_doc,
            dialog=opt.dialog,
            text_maxlength=opt.text_maxlength,
            target_maxlength=opt.target_maxlength,
        )
        self.fns = ApplyFns(
            gen_cfg=gen_cfg,
            lora_cfg=lora_cfg,
            temperature_gold=opt.temperature_gold,
            temperature_score=opt.temperature_score,
            temperature_jsa=opt.temperature_jsa,
            temperature_lm=opt.temperature_lm,
            mis_step=opt.mis_step,
            mis_topk=opt.mis_topk,
            n_context=opt.n_context,
            use_all_mis=opt.use_all_mis,
            standard_mc=opt.standard_mc,
            union_kl=opt.union_kl,
            kl_beta=opt.kl_beta,
            simplify_jsa=opt.simplify_JSA,
            decouple=opt.decouple_encoder,
            contrastive=opt.contrastive_learning,
            reduce_norm=opt.reduce_norm,
            eps=opt.eps,
            train_dropout=opt.dropout > 0.0,
        )

    def gen_params(self, params) -> dict:
        """The generator weights a forward uses (LoRA merged when on)."""
        return self.fns.gen_params(params)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    # ------------------------------------------------------------ tokenizing
    def retriever_tokenize(self, texts: list[str]):
        return self.retriever_tokenizer.encode_batch(
            texts, self._retriever_max_len())

    def _retriever_max_len(self) -> int:
        """text_maxlength clamped to the tower's position table (a sequence
        past max_positions has no position embedding; truncate instead)."""
        return min(self.opt.text_maxlength, BERT_MAX_SEQ_LENGTH,
                   self.retriever.cfg.bert.max_positions)

    def passage_texts(self, ids_matrix: np.ndarray) -> list[list[dict]]:
        """(B, K) global passage ids -> passages (host-side resolution).
        Each dict carries its global id as ``_gid``."""
        n = len(self.store)
        if np.max(ids_matrix) >= n:
            raise ValueError(
                f"retrieved passage id {int(np.max(ids_matrix))} >= corpus "
                f"size {n} — the index was built over a different corpus "
                f"than --passages")
        if np.min(ids_matrix) < 0:
            raise ValueError(
                "retrieval returned unfilled slots (id -1) — n_probe too "
                "small for k, or k exceeds the reachable candidates")
        return [[dict(self.store[int(i)], _gid=int(i)) for i in row]
                for row in ids_matrix]

    def _tokenize_passage_matrix(self, passages: list[list[dict]]):
        """(B, K) passages -> (B, K, L) retriever token arrays."""
        fstr = self.opt.retriever_format
        flat = [fstr.format(**{"title": p.get("title", ""),
                               "text": p.get("text", "")})
                for row in passages for p in row]
        ids, mask = self.retriever_tokenize(flat)
        b, k = len(passages), len(passages[0])
        return ids.reshape(b, k, -1), mask.reshape(b, k, -1)

    # -------------------------------------------------------------- retrieval
    def _posterior_params(self, params) -> DualEncoderRetriever:
        """The posterior retriever: its own towers, the prior's passage
        tower paired in under decouple, or the prior when there is no
        posterior (simplify_JSA)."""
        return self.fns.expand(params)["post_retriever"]

    def embed_queries(self, params, texts, posterior: bool = False):
        """(B,) texts -> (B, H) query embeddings on the model's device
        (retrieval: no autograd)."""
        with trace.span("rag.embed_queries"):
            ids, mask = self.retriever_tokenize(texts)
            tower = (self._posterior_params(params) if posterior
                     else params["retriever"])
            with torch.no_grad():
                return tower.embed_queries(self._tensor(ids),
                                           self._tensor(mask))

    def retrieve(self, index, params, queries: list[str], topk: int,
                 posterior: bool = False, iter_stats: dict | None = None,
                 batch_metadata=None, filtering_fun=None, q_emb=None):
        """Search the index; returns (ids (B,k) np, scores (B,k) np,
        passages). ``filtering_fun`` is the task's anti-cheat filter
        (retrieval over-fetches 8 so filtered rows still fill topk); pass
        ``q_emb`` when the caller already embedded the queries."""
        t0 = time.time()
        if q_emb is None:
            q_emb = self.embed_queries(params, queries, posterior=posterior)
        fetch_k = topk + (8 if filtering_fun is not None else 0)
        if self.opt.retrieve_with_rerank:
            ids, scores = self._retrieve_rerank(index, params, q_emb,
                                                fetch_k, posterior)
        else:
            scores, ids = index.search(q_emb, fetch_k)
        with trace.span("rag.fetch_ids"):
            if not self.opt.retrieve_with_rerank:  # the rerank's are on host
                ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
            passages = self.passage_texts(ids)
        if filtering_fun is not None:
            passages, score_lists = filtering_fun(
                batch_metadata, passages,
                [s.tolist() for s in scores], topk)
            passages = [list(p) for p in passages]
            scores = np.asarray([list(s) for s in score_lists], np.float32)
            ids = np.asarray(
                [[int(p.get("_gid", -1)) if "_gid" in p else -1
                  for p in row] for row in passages], np.int64)
        else:
            ids, scores = ids[:, :topk], scores[:, :topk]
            passages = [row[:topk] for row in passages]
        if iter_stats is not None:
            iter_stats["runtime/search"] = (time.time() - t0, 1)
        return ids, scores, passages

    def _retrieve_rerank(self, index, params, q_emb, topk: int,
                         posterior: bool):
        """retrieve_with_rerank (src/rag.py:177-247): over-retrieve
        ``n_to_rerank``, re-embed those passages with the live passage
        tower (the posterior's for posterior queries) in
        ``per_gpu_embedder_batch_size`` chunks, dot them with the query
        embedding in f32 on the host, and re-sort with the JAX package's
        ``np.argsort(-scores)`` (not stable: equal scores keep its
        order). -> (ids (B, topk), scores (B, topk)) numpy."""
        n_rr = max(self.opt.n_to_rerank_with_retrieve_with_rerank, topk)
        _, cand_ids = index.search(q_emb, n_rr)
        cand_ids = cand_ids.cpu().numpy()
        p_ids, p_mask = self._tokenize_passage_matrix(
            self.passage_texts(cand_ids))
        p_ids = p_ids.reshape(-1, p_ids.shape[-1])
        p_mask = p_mask.reshape(-1, p_mask.shape[-1])
        tower = (self._posterior_params(params) if posterior
                 else params["retriever"])
        chunk = max(1, self.opt.per_gpu_embedder_batch_size)
        with torch.no_grad():
            p_emb = torch.cat([
                tower.embed_passages(self._tensor(p_ids[i:i + chunk]),
                                     self._tensor(p_mask[i:i + chunk]))
                .to(torch.float32) for i in range(0, len(p_ids), chunk)])
        b = cand_ids.shape[0]
        p_emb = p_emb.cpu().numpy().reshape(b, cand_ids.shape[1], -1)
        scores = np.einsum("bh,bkh->bk",
                           q_emb.to(torch.float32).cpu().numpy(), p_emb)
        order = np.argsort(-scores, axis=-1)[:, :topk]
        return (np.take_along_axis(cand_ids, order, axis=1),
                np.take_along_axis(scores, order, axis=1))

    def live_rescore(self, params, queries: list[str],
                     passages: list[list[dict]], q_emb=None) -> np.ndarray:
        """(B, K) retrieval scores from the LIVE towers: the query tower's
        embedding dotted with the passage tower's re-embedding of each
        retrieved passage (reference: evaluate.py:175-186); the dot runs on
        the host in f32, as in the JAX package."""
        if q_emb is None:
            q_emb = self.embed_queries(params, queries)
        q_emb = q_emb.to(torch.float32).cpu().numpy()
        p_ids, p_mask = self._tokenize_passage_matrix(passages)
        with torch.no_grad():
            p_emb = params["retriever"].embed_passages(
                self._tensor(p_ids.reshape(-1, p_ids.shape[-1])),
                self._tensor(p_mask.reshape(-1, p_mask.shape[-1])))
        b, k = len(passages), len(passages[0])
        p_emb = p_emb.to(torch.float32).cpu().numpy().reshape(b, k, -1)
        return np.einsum("bh,bkh->bk", q_emb, p_emb)

    # ------------------------------------------------------------ index build
    def build_index(self, index, params, iter_stats: dict | None = None):
        """(Re)build the index with the live passage tower (reference:
        src/rag.py:102-130)."""
        stats = _build_index(
            index, self.store, make_encode_fn(params["retriever"]),
            self.retriever_tokenizer,
            batch_size=self.opt.per_gpu_embedder_batch_size,
            max_length=self._retriever_max_len(),
            passage_fmt=self.opt.retriever_format,
        )
        if iter_stats is not None:
            iter_stats.update(stats)
        return stats

    # -------------------------------------------------- supplied passages
    def supplied_pool(self, file_passages):
        """use_file candidate pool: the supplied lists capped at
        ``retriever_n_context``, padded to the batch's width by repeating
        each row's last passage; ``valid`` (B, K) marks the genuinely
        supplied slots so a pad never wins a selection."""
        width = min(max(1, self.opt.retriever_n_context),
                    max(1, max(len(p) for p in file_passages)))
        if process_count() > 1:
            # the batch-max width is per-rank data; the static cap gives
            # every rank the same shapes (``rag_model.py:364-370``)
            width = max(1, self.opt.retriever_n_context)
        pool = self._supplied_passages(file_passages, width)
        valid = np.zeros((len(file_passages), width), bool)
        for i, p in enumerate(file_passages):
            valid[i, :max(min(len(p), width), 1)] = True
        return pool, valid

    def _supplied_passages(self, file_passages, k):
        """closed_book / use_file_passages passage sources."""
        if self.opt.closed_book:
            return [[{"title": "", "text": ""}] for _ in file_passages]
        out = []
        for p in file_passages:
            row = list(p[:k])
            if not row:
                row = [{"title": "", "text": ""}]
            while len(row) < k:
                row.append(dict(row[-1]))
            out.append(row)
        return out

    # --------------------------------------------------------- training
    def retrieve_pair(self, index, params, queries, post_queries, topk,
                      iter_stats: dict | None = None):
        """Prior + posterior retrieval: both query towers embed, then ONE
        search over the concatenated 2B queries (``rag_model.py:198-262``).
        Returns (prior ids, post ids, prior passages, post passages). Under
        ``retrieve_with_rerank``, over an index that is not flat, or over
        several processes: two ``retrieve`` calls, posterior first
        (``rag_model.py:203-218``). An IVF search scores the union of the
        lists its batch probes, so one search of the 2B queries would return
        other ids than two of B; a sharded search gathers each rank's own
        queries (``index.search``), which the fused call does not."""
        if (self.opt.retrieve_with_rerank
                or not isinstance(index, ShardedFlatIndex)
                or process_count() > 1):
            post_ids, _, post_passages = self.retrieve(
                index, params, post_queries, topk, posterior=True,
                iter_stats=iter_stats)
            prior_ids, _, prior_passages = self.retrieve(
                index, params, queries, topk, iter_stats=iter_stats)
            return prior_ids, post_ids, prior_passages, post_passages
        t0 = time.time()
        prior_q = self.embed_queries(params, queries)
        post_q = self.embed_queries(params, post_queries, posterior=True)
        q_all = torch.cat([prior_q, post_q]).to(torch.float32)
        # storage operands fetched per call: a refresh rewrites the rows
        # (and hybrid re-derives its coarse copy)
        search, store_ops = index.fused_search_fn(min(topk,
                                                      index.n_passages))
        _, ids = search(q_all, *store_ops)
        with trace.span("rag.fetch_ids"):
            ids = ids.cpu().numpy()
            b = len(queries)
            prior_ids, post_ids = ids[:b], ids[b:]
            if iter_stats is not None:
                iter_stats["runtime/search"] = (time.time() - t0, 1)
            return (prior_ids, post_ids, self.passage_texts(prior_ids),
                    self.passage_texts(post_ids))

    @staticmethod
    def build_union(post_ids: np.ndarray, prior_ids: np.ndarray):
        """First-occurrence union of (post, prior) id lists per row, padded
        to the static width U = post_K + prior_K with a validity mask
        (``rag_model.py:328-346``)."""
        b, k1 = post_ids.shape
        k2 = prior_ids.shape[1]
        u = k1 + k2
        union = np.zeros((b, u), np.int64)
        valid = np.zeros((b, u), bool)
        for i in range(b):
            seen: dict[int, None] = {}
            for x in np.concatenate([post_ids[i], prior_ids[i]]):
                seen.setdefault(int(x))
            ids = list(seen)
            union[i, :len(ids)] = ids
            union[i, len(ids):] = ids[0]  # pad with a real id (masked out)
            valid[i, :len(ids)] = True
        return union, valid

    def _generator_rows(self, queries, passages, targets):
        ids, labels, mask = build_training_batch(
            self.generator_tokenizer, queries, passages, targets,
            self.prompt_cfg)
        return self._tensor(ids), self._tensor(labels), self._tensor(mask)

    def retrieval_ctx(self, mode: str, index, params, queries, targets,
                      iter_stats: dict | None = None, file_passages=None,
                      batch_metadata=None, filtering_fun=None) -> dict:
        """The retrieval phase of ``build_batch`` (``rag_model.py:396-467``):
        everything that touches the index, none of the tokenisation, so the
        loop can prefetch the next batch's (``--pipeline_retrieval``). rag
        and concat: one search with the prior's query tower; vrag and jsa:
        both searches, the union and its passages."""
        topk = self.opt.n_context
        if self.opt.closed_book and file_passages is None:
            file_passages = [[] for _ in queries]
        use_file = ((self.opt.use_file_passages or self.opt.closed_book)
                    and file_passages is not None)
        # retrieval queries have dialog speaker tags stripped
        # (reference: src/rag.py:688-691)
        from ..data.prompts import remove_speakers

        queries_r = [remove_speakers(q) for q in queries]
        retr_kw = dict(iter_stats=iter_stats, batch_metadata=batch_metadata,
                       filtering_fun=filtering_fun)
        ctx: dict = {"use_file": use_file,
                     "last_info": {"query": queries[0],
                                   "response": targets[0]}}
        if mode in ("concat", "rag"):
            if use_file:
                ctx["passages"] = self._supplied_passages(file_passages, topk)
            else:
                _, _, ctx["passages"] = self.retrieve(
                    index, params, queries_r, topk, **retr_kw)
            return ctx
        post_queries = [f"{q} [SEP] {t}" for q, t in zip(queries_r, targets)]
        if use_file:
            # the supplied lists capped at retriever_n_context; no search
            u_passages, valid = self.supplied_pool(file_passages)
            post_passages = [p[:topk] for p in u_passages]
        elif filtering_fun is not None:
            # filtering is host-side: two calls
            post_ids, _, post_passages = self.retrieve(
                index, params, post_queries, topk, posterior=True, **retr_kw)
            prior_ids, _, _ = self.retrieve(index, params, queries_r, topk,
                                            **retr_kw)
            with trace.span("rag.union"):
                union, valid = self.build_union(post_ids, prior_ids)
                u_passages = self.passage_texts(union)
        else:
            prior_ids, post_ids, prior_passages, post_passages = \
                self.retrieve_pair(index, params, queries_r, post_queries,
                                   topk, iter_stats=iter_stats)
            with trace.span("rag.union"):
                union, valid = self.build_union(post_ids, prior_ids)
                u_passages = self.passage_texts(union)
            ctx["last_info"].update({
                "prior_retrieved_ids": prior_ids[0].tolist(),
                "post_retrieved_ids": post_ids[0].tolist(),
                "prior_retrieved_texts": [p.get("text", "")
                                          for p in prior_passages[0]],
            })
        ctx.update(u_passages=u_passages, post_passages=post_passages,
                   valid=valid, post_queries=post_queries)
        return ctx

    def build_batch(self, mode: str, index, params, queries, targets,
                    iter_stats: dict | None = None, file_passages=None,
                    batch_metadata=None, filtering_fun=None,
                    retrieval: dict | None = None) -> dict:
        """Retrieve and tokenise everything the mode's loss needs
        (``rag_model.py:469-575``) -> dict of tensors on the model's
        device. ``retrieval``: a prefetched ``retrieval_ctx`` to consume
        instead of searching here."""
        if mode not in MODE_LOSSES:
            raise ValueError(f"unknown mode {mode!r}")
        with trace.span("rag.build_batch"):
            if retrieval is None:
                retrieval = self.retrieval_ctx(
                    mode, index, params, queries, targets,
                    iter_stats=iter_stats, file_passages=file_passages,
                    batch_metadata=batch_metadata,
                    filtering_fun=filtering_fun)
            self.last_info = retrieval["last_info"]
            with trace.span("rag.tokenize"):
                return self._tokenized_batch(mode, retrieval, queries,
                                             targets)

    def _tokenized_batch(self, mode: str, retrieval: dict, queries,
                         targets) -> dict:
        """``build_batch``'s tokenisation of a retrieval: the retriever's
        and the generator's rows of ``mode``, on the model's device."""
        t = self._tensor
        if mode == "concat":
            g = self._generator_rows(queries, retrieval["passages"], targets)
            return {"gen_ids": g[0], "gen_labels": g[1], "gen_mask": g[2]}
        q_ids, q_mask = self.retriever_tokenize(queries)
        if mode == "rag":
            passages = retrieval["passages"]
            p_ids, p_mask = self._tokenize_passage_matrix(passages)
            g = self._generator_rows(queries, passages, targets)
            return {"q_ids": t(q_ids), "q_mask": t(q_mask),
                    "passage_ids": t(p_ids), "passage_mask": t(p_mask),
                    "gen_ids": g[0], "gen_labels": g[1], "gen_mask": g[2]}
        u_passages = retrieval["u_passages"]
        post_passages = retrieval["post_passages"]
        valid = retrieval["valid"]
        pq_ids, pq_mask = self.retriever_tokenize(retrieval["post_queries"])
        if mode == "vrag":
            pp_ids, pp_mask = self._tokenize_passage_matrix(post_passages)
            g = self._generator_rows(queries, post_passages, targets)
            batch = {"q_ids": t(q_ids), "q_mask": t(q_mask),
                     "post_q_ids": t(pq_ids), "post_q_mask": t(pq_mask),
                     "post_passage_ids": t(pp_ids),
                     "post_passage_mask": t(pp_mask),
                     "gen_ids": g[0], "gen_labels": g[1], "gen_mask": g[2]}
            if retrieval["use_file"]:
                # supplied lists may be padded with duplicates: masked out
                # of the posterior softmax
                batch["post_valid"] = t(valid[:, :len(post_passages[0])])
            if self.opt.union_kl:
                u_ids, u_mask = self._tokenize_passage_matrix(u_passages)
                batch.update(union_passage_ids=t(u_ids),
                             union_passage_mask=t(u_mask),
                             union_valid=t(valid))
            return batch
        if not self.opt.unil_postandprior:
            # candidate set = posterior top-k only (src/rag.py:1873-1896);
            # supplied rows keep their pad mask
            u_passages = post_passages
            if retrieval["use_file"]:
                valid = valid[:, :len(post_passages[0])]
            else:
                valid = np.ones((len(queries), len(post_passages[0])), bool)
        u_ids, u_mask = self._tokenize_passage_matrix(u_passages)
        g = self._generator_rows(queries, u_passages, targets)
        batch = {
            "q_ids": t(q_ids), "q_mask": t(q_mask),
            "post_q_ids": t(pq_ids), "post_q_mask": t(pq_mask),
            "union_passage_ids": t(u_ids), "union_passage_mask": t(u_mask),
            "union_valid": t(valid),
            "gen_ids": g[0], "gen_labels": g[1], "gen_mask": g[2],
        }
        if self.opt.contrastive_learning and self.opt.training_sample_num:
            # corpus-uniform negatives for the contrastive normaliser
            # (rag_model.py:559-573)
            self._neg_seed = getattr(self, "_neg_seed", 0) + 1
            rng = np.random.default_rng(self.opt.seed * 100003
                                        + self._neg_seed)
            neg_ids = rng.integers(
                0, len(self.store),
                (len(queries), self.opt.training_sample_num))
            n_ids, n_mask = self._tokenize_passage_matrix(
                self.passage_texts(neg_ids))
            batch["neg_passage_ids"] = t(n_ids)
            batch["neg_passage_mask"] = t(n_mask)
        return batch

    def loss_and_grad_fn(self, mode: str):
        """-> fn(params, batch, rng, leaves) -> ((loss, aux), grads): the
        mode loss and its gradients with respect to ``leaves`` (a list of
        tensors), None where the loss does not reach a leaf."""
        if mode not in MODE_LOSSES:
            raise ValueError(
                f"unknown training mode {mode!r}; expected one of "
                f"{sorted(MODE_LOSSES)} (gold_score_mode / gen_method)")
        loss_fn = MODE_LOSSES[mode]

        def value_and_grad(params, batch, rng, leaves):
            with trace.span("step.loss"):
                loss, aux = loss_fn(self.fns, params, batch, rng)
            with trace.span("step.grad"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return (loss.detach(), aux), grads

        return value_and_grad

    def forward(self, mode: str, index, params, queries, targets, rng,
                iter_stats: dict | None = None):
        """One forward (loss only), dropout off (the reference's .eval(),
        evaluate.py:215)."""
        if mode not in MODE_LOSSES:
            raise ValueError(f"unknown training mode {mode!r}")
        batch = self.build_batch(mode, index, params, queries, targets,
                                 iter_stats=iter_stats)
        eval_fns = dataclasses.replace(self.fns, train_dropout=False)
        with torch.no_grad():
            return MODE_LOSSES[mode](eval_fns, params, batch, rng)

    # -------------------------------------------------------------- generation
    def generate(self, params, queries, passages, *, max_new_tokens=None,
                 force_concat: bool = False, return_logprobs: bool = False):
        """Decode on left-padded prompts -> (B or B*K, L_new) ids (numpy),
        and the per-token log-probs with ``return_logprobs``: greedy when
        ``generation_num_beams == 1``, else beam search with
        ``generation_length_penalty`` (``rag_model.py:632-647``); both with
        ``generation_min_length`` new tokens at least.
        ``decoder_prompt_format`` forces each row's formatted query prefix
        first; ``force_concat`` builds one passages-concatenated prompt per
        query (the reference's ``gen_method == 'concat'``,
        src/rag.py:533-538)."""
        cfg = self.prompt_cfg
        if force_concat and not cfg.concat_doc:
            cfg = dataclasses.replace(cfg, concat_doc=True)
        gids, gmask = build_generation_batch(
            self.generator_tokenizer, queries, passages, cfg)
        eos = self.generator_tokenizer.eos_id
        kw = dict(
            max_new_tokens=max_new_tokens or self.opt.generation_max_length,
            # no eos token -> -1 never matches; decode runs to max length
            eos_id=-1 if eos is None else eos,
            pad_id=self.generator_tokenizer.pad_id,
            min_new_tokens=self.opt.generation_min_length or 0,
            return_logprobs=return_logprobs,
        )
        if self.opt.decoder_prompt_format:
            kw["forced_prefix"], kw["forced_len"] = self._forced_prefix(
                queries, n_rows=gids.shape[0])
        args = (self.gen_params(params), self.gen_cfg, self._tensor(gids),
                self._tensor(gmask))
        beams = self.opt.generation_num_beams
        if beams > 1:
            out = beam_generate(
                *args, num_beams=beams,
                length_penalty=self.opt.generation_length_penalty, **kw)
        else:
            out = greedy_generate(*args, **kw)
        if return_logprobs:
            toks, lps = out
            return toks.cpu().numpy(), lps.cpu().numpy()
        return out.cpu().numpy()

    def _forced_prefix(self, queries, n_rows):
        """(rows, P) forced decoder-prompt ids + per-row lengths, one row
        per generation-batch row (query-major, matching build rows)."""
        fmt = self.opt.decoder_prompt_format
        # trim each encoded row to its mask length: a padded forced_len
        # would force the decoder to emit pad tokens after the real prefix
        enc = [self.generator_tokenizer.encode_batch(
            [fmt.format_map({"query": q})],
            self.opt.target_maxlength, add_special=False)
            for q in queries]
        per_q = [ids[0][: int(mask[0].sum())] for ids, mask in enc]
        rep = n_rows // len(queries)
        rows = [list(ids) for ids in per_q for _ in range(rep)]
        plen = global_max_len(max(1, max(len(r) for r in rows)))
        prefix = np.zeros((n_rows, plen), np.int32)
        lens = np.zeros((n_rows,), np.int32)
        for i, r in enumerate(rows):
            prefix[i, :len(r)] = r
            lens[i] = len(r)
        return self._tensor(prefix), self._tensor(lens)

    def method_generate(self, params, queries, passages, ret_scores,
                        *, max_new_tokens=None):
        """fast_deocde1/2 (sic, reference: src/rag.py:2282-2326): one
        answer per (query, passage) pair, the best of K by
        sent_prob x softmax(ret_score / gen_doc_scores) (fast_deocde1) or
        sent_logp + ret_score / gen_doc_scores (fast_deocde2)."""
        b = len(queries)
        k = len(passages[0])
        gen, lps = self.generate(params, queries, passages,
                                 max_new_tokens=max_new_tokens,
                                 return_logprobs=True)  # (B*K, L_new)
        sent_logp = self._greedy_sent_logp(gen, lps).reshape(b, k)
        ret = np.asarray(ret_scores, np.float32)
        if self.opt.gen_method == "fast_deocde2":
            total = sent_logp + ret / self.opt.gen_doc_scores
        else:  # fast_deocde1
            probs = np.exp(sent_logp)
            e = np.exp(ret / self.opt.gen_doc_scores -
                       np.max(ret / self.opt.gen_doc_scores, -1,
                              keepdims=True))
            total = probs * (e / e.sum(-1, keepdims=True))
        best = np.argmax(total, axis=-1)
        gen = gen.reshape(b, k, -1)
        return gen[np.arange(b), best], gen

    def _greedy_sent_logp(self, gen, lps):
        """Length-normalised sequence score from the decode's per-token
        log-probs; numerator and denominator use the same (gen != pad)
        mask, so an EOS that reads as pad drops out of both."""
        tok_mask = gen != self.generator_tokenizer.pad_id
        n_tok = np.maximum(tok_mask.sum(-1), 1)
        return (lps * tok_mask).sum(-1) / n_tok

    def _score_generations(self, params, queries, passages, gen_tokens):
        """Length-normalised log-prob of each generated continuation, by a
        full forward (the slow-path oracle of ``_greedy_sent_logp``)."""
        gids, gmask = build_generation_batch(
            self.generator_tokenizer, queries, passages, self.prompt_cfg)
        pad = self.generator_tokenizer.pad_id
        gen_mask = (gen_tokens != pad).astype(np.int32)
        full_ids = np.concatenate([gids, gen_tokens], axis=1)
        full_mask = np.concatenate([gmask, gen_mask], axis=1)
        labels = np.concatenate(
            [np.full_like(gids, -100),
             np.where(gen_mask == 1, gen_tokens, -100)], axis=1)
        with torch.no_grad():
            out = lm_sequence_logprob(
                self.gen_params(params), self.gen_cfg,
                self._tensor(full_ids), self._tensor(full_mask),
                self._tensor(labels))
        return out.cpu().numpy()

    def eval_loss(self, params, queries, passages, targets) -> np.ndarray:
        """Per-row generator CE of the gold targets, (B*K,) — the eval
        harness's ``eval_ce`` program (``evaluation.py:44-46``)."""
        ids, labels, mask = build_training_batch(
            self.generator_tokenizer, queries, passages, targets,
            self.prompt_cfg)
        with torch.no_grad():
            per_seq, _ = lm_loss(self.gen_params(params), self.gen_cfg,
                                 self._tensor(ids), self._tensor(mask),
                                 self._tensor(labels))
        return per_seq.cpu().numpy()
