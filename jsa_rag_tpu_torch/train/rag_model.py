"""RAG orchestration, the inference half: retrieval, live rescoring, index
build and generation.

Counterpart of ``jsa_rag_tpu/train/rag_model.py`` (:45-325 and :603-735).
Host side as in the JAX package: tokenisation, id -> passage resolution and
the fast_deocde1/2 selection run on numpy; the towers, the index search and
the decode run on the model's device. ``params`` is the dict of
``model_io.load_or_initialize_model``: ``params["retriever"]`` is the
``DualEncoderRetriever`` module whose weights a call uses,
``params["generator"]``/``params["lora"]`` the generator's tensors.

The training half — ``retrieve_pair``, ``build_union``, ``retrieval_ctx``,
``build_batch``, ``loss_and_grad_fn``, ``forward`` and the
``retrieve_with_rerank`` path — comes with the training slice (ROADMAP queue
A items 7-9); reaching it raises ``NotImplementedError``.
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
from ..models.lm import (LMConfig, greedy_generate, lm_loss,
                         lm_sequence_logprob)
from ..models.lora import LoRAConfig, gen_params
from ..models.retriever import DualEncoderRetriever

BERT_MAX_SEQ_LENGTH = 512  # reference: src/rag.py:40
TRAINING_SLICE = "belongs to the training slice: ROADMAP queue A items 7-9"


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

    def gen_params(self, params) -> dict:
        """The generator weights a forward uses (LoRA merged when on)."""
        return gen_params(params, self.lora_cfg)

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
    def embed_queries(self, params, texts, posterior: bool = False):
        """(B,) texts -> (B, H) query embeddings on the model's device."""
        if posterior:
            raise NotImplementedError(f"the posterior tower {TRAINING_SLICE}")
        ids, mask = self.retriever_tokenize(texts)
        with torch.no_grad():
            return params["retriever"].embed_queries(self._tensor(ids),
                                                     self._tensor(mask))

    def retrieve(self, index, params, queries: list[str], topk: int,
                 posterior: bool = False, iter_stats: dict | None = None,
                 batch_metadata=None, filtering_fun=None, q_emb=None):
        """Search the index; returns (ids (B,k) np, scores (B,k) np,
        passages). ``filtering_fun`` is the task's anti-cheat filter
        (retrieval over-fetches 8 so filtered rows still fill topk); pass
        ``q_emb`` when the caller already embedded the queries."""
        if self.opt.retrieve_with_rerank:
            raise NotImplementedError(f"retrieve_with_rerank {TRAINING_SLICE}")
        t0 = time.time()
        if q_emb is None:
            q_emb = self.embed_queries(params, queries, posterior=posterior)
        fetch_k = topk + (8 if filtering_fun is not None else 0)
        scores, ids = index.search(q_emb, fetch_k)
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

    # ----------------------------------------------------- training half
    def retrieve_pair(self, *args, **kwargs):
        raise NotImplementedError(f"retrieve_pair {TRAINING_SLICE}")

    @staticmethod
    def build_union(*args, **kwargs):
        raise NotImplementedError(f"build_union {TRAINING_SLICE}")

    def retrieval_ctx(self, *args, **kwargs):
        raise NotImplementedError(f"retrieval_ctx {TRAINING_SLICE}")

    def build_batch(self, *args, **kwargs):
        raise NotImplementedError(f"build_batch {TRAINING_SLICE}")

    def loss_and_grad_fn(self, *args, **kwargs):
        raise NotImplementedError(f"loss_and_grad_fn {TRAINING_SLICE}")

    def forward(self, *args, **kwargs):
        raise NotImplementedError(f"forward {TRAINING_SLICE}")

    # -------------------------------------------------------------- generation
    def generate(self, params, queries, passages, *, max_new_tokens=None,
                 force_concat: bool = False, return_logprobs: bool = False):
        """Greedy decode on left-padded prompts -> (B or B*K, L_new) ids
        (numpy), and the per-token log-probs with ``return_logprobs``.
        ``decoder_prompt_format`` forces each row's formatted query prefix
        first; ``force_concat`` builds one passages-concatenated prompt per
        query (the reference's ``gen_method == 'concat'``,
        src/rag.py:533-538). Beam search (``generation_num_beams > 1``) is
        ROADMAP queue A item 12."""
        if self.opt.generation_num_beams > 1:
            raise NotImplementedError(
                "beam decoding (generation_num_beams > 1) is not ported yet: "
                "ROADMAP queue A item 12")
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
        )
        if self.opt.decoder_prompt_format:
            kw["forced_prefix"], kw["forced_len"] = self._forced_prefix(
                queries, n_rows=gids.shape[0])
        out = greedy_generate(
            self.gen_params(params), self.gen_cfg, self._tensor(gids),
            self._tensor(gmask),
            min_new_tokens=self.opt.generation_min_length or 0,
            return_logprobs=return_logprobs, **kw)
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
