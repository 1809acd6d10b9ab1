"""R@1 / R@10 / MRR@10 of predictions against a gold-passage file, as
``scripts/analysis/recall_mrr.py`` prints them (reference: recall.py:3-63):

    python -m jsa_rag_tpu_torch.analysis.recall_mrr gold.jsonl \\
        predictions.jsonl

gold.jsonl rows:        {"question": ..., "gold_doc": <passage id>}
predictions.jsonl rows: {"query"/"question": ..., "passages": [{"id": ...}]}
"""

from __future__ import annotations

import json
import sys

from ..utils.metrics import mrr_at_k, recall_at_k


def load_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def main(argv=None) -> dict:
    gold_path, pred_path = argv if argv is not None else sys.argv[1:3]
    gold = {g["question"]: g["gold_doc"] for g in load_jsonl(gold_path)}
    r1 = r10 = mrr = n = 0
    for row in load_jsonl(pred_path):
        q = row.get("question") or row.get("query")
        if q not in gold:
            continue
        ids = [p["id"] for p in row["passages"]]
        gold_ids = {gold[q]}
        r1 += recall_at_k(ids, gold_ids, 1)
        r10 += recall_at_k(ids, gold_ids, 10)
        mrr += mrr_at_k(ids, gold_ids, 10)
        n += 1
    out = {"recall@1": r1 / max(n, 1), "recall@10": r10 / max(n, 1),
           "MRR@10": mrr / max(n, 1), "n": n}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
