"""Evaluation metrics: SQuAD-normalized EM/F1, Rouge, BLEU, substring recall,
coverage@k (src/metrics.py, build_server/metrics.py:15-24), and MRR and
recall@k of passage ids (recall.py:54-63), which ``analysis/recall_mrr.py``
reads.

The port's own copy of ``jsa_rag_tpu/utils/metrics.py`` (framework-neutral,
copied so the port imports nothing of the JAX package)."""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Callable, Sequence

import numpy as np

RE_ART = re.compile(r"\b(a|an|the)\b")


def normalize_answer(s: str) -> str:
    """SQuAD normalization (src/metrics.py:23-37)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = RE_ART.sub(" ", s)
    return " ".join(s.split())


def em(prediction: str, ground_truth: str, normalize_fn: Callable) -> float:
    return float(normalize_fn(prediction) == normalize_fn(ground_truth))


def exact_match_score(prediction: str, ground_truths: Sequence[str],
                      normalize_fn: Callable = lambda x: x) -> float:
    return max(em(prediction, gt, normalize_fn) for gt in ground_truths)


def f1(prediction: str, ground_truth: str, normalize_fn: Callable) -> float:
    p_tokens = normalize_fn(prediction).split()
    g_tokens = normalize_fn(ground_truth).split()
    common = Counter(p_tokens) & Counter(g_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(p_tokens)
    recall_ = num_same / len(g_tokens)
    return 2 * precision * recall_ / (precision + recall_)


def f1_score(prediction: str, ground_truths: Sequence[str],
             normalize_fn: Callable = lambda x: x) -> float:
    return max(f1(prediction, gt, normalize_fn) for gt in ground_truths)


def recall(passages: Sequence[str], ground_truths: Sequence[str]) -> float:
    """Substring recall: fraction of gold answers appearing verbatim in any
    retrieved passage (src/metrics.py:48-60, evaluate.py:30-42)."""
    if not ground_truths:
        return 0.0
    passages = [p.lower() for p in passages]
    hits = 0
    for g in ground_truths:
        g = g.lower()
        hits += float(any(g in p for p in passages))
    return hits / len(ground_truths)


def coverage_at_k(passages: Sequence[str], ground_truths: Sequence[str],
                  ks: Sequence[int] = (5, 10, 20, 50)) -> dict[str, float]:
    """Answer coverage at several cutoffs (build_server/metrics.py:15-24)."""
    out = {}
    for k in ks:
        out[f"coverage@{k}"] = float(recall(passages[:k], ground_truths) > 0)
    return out


def mrr_at_k(ranked_ids: Sequence, gold_ids: set, k: int = 10) -> float:
    """Mean reciprocal rank of the first gold id (recall.py:54-63)."""
    for r, pid in enumerate(ranked_ids[:k]):
        if pid in gold_ids:
            return 1.0 / (r + 1)
    return 0.0


def recall_at_k(ranked_ids: Sequence, gold_ids: set, k: int) -> float:
    return float(any(pid in gold_ids for pid in ranked_ids[:k]))


# ------------------------------------------------------------------- rouge
def rouge_score(prediction: str, ground_truths: Sequence[str]):
    """Rouge-1/2/L f-measures, max over references (src/metrics.py:83-104).
    Uses the `rouge` package when available, else a pure-python fallback."""
    ground_truths = [x for x in ground_truths if len(x) > 0]
    if len(prediction) == 0 or len(ground_truths) == 0:
        return 0.0, 0.0, 0.0
    try:
        from rouge import Rouge

        r = Rouge()

        def one(gt):
            try:
                s = r.get_scores(prediction, gt, avg=True)
                return (s["rouge-1"]["f"], s["rouge-2"]["f"],
                        s["rouge-l"]["f"])
            except Exception:
                return (0.0, 0.0, 0.0)

        scores = [one(gt) for gt in ground_truths]
    except ImportError:
        scores = [_rouge_fallback(prediction, gt) for gt in ground_truths]
    return tuple(max(s[i] for s in scores) for i in range(3))


def _rouge_fallback(pred: str, ref: str):
    pt, rt = pred.split(), ref.split()

    def f_measure(match, plen, rlen):
        if plen == 0 or rlen == 0 or match == 0:
            return 0.0
        p, r = match / plen, match / rlen
        return 2 * p * r / (p + r)

    m1 = sum((Counter(pt) & Counter(rt)).values())
    bi_p = Counter(zip(pt, pt[1:]))
    bi_r = Counter(zip(rt, rt[1:]))
    m2 = sum((bi_p & bi_r).values())
    lcs = _lcs_len(pt, rt)
    return (f_measure(m1, len(pt), len(rt)),
            f_measure(m2, max(len(pt) - 1, 0), max(len(rt) - 1, 0)),
            f_measure(lcs, len(pt), len(rt)))


def _lcs_len(a, b):
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


# -------------------------------------------------------------------- bleu
def bleu_score(prediction: str, ground_truths: Sequence[str],
               n: int = 4) -> float:
    """Sentence BLEU-n on SQuAD-normalized text (src/metrics.py:142-156);
    nltk when available, else geometric-mean n-gram precision."""
    hyp = normalize_answer(prediction).split()
    refs = [normalize_answer(r).split() for r in ground_truths]
    if not hyp or not refs:
        return 0.0
    try:
        from nltk.translate.bleu_score import sentence_bleu, SmoothingFunction

        return float(sentence_bleu(
            refs, hyp, weights=[1.0 / n] * n,
            smoothing_function=SmoothingFunction().method1))
    except ImportError:
        precisions = []
        for i in range(1, n + 1):
            hyp_ng = Counter(tuple(hyp[j:j + i])
                             for j in range(len(hyp) - i + 1))
            ref_ng = Counter()
            for ref in refs:
                ref_ng |= Counter(tuple(ref[j:j + i])
                                  for j in range(len(ref) - i + 1))
            total = sum(hyp_ng.values())
            hit = sum((hyp_ng & ref_ng).values())
            precisions.append(hit / total if total else 0.0)
        if min(precisions) == 0:
            return 0.0
        return float(np.exp(np.mean(np.log(precisions))))
