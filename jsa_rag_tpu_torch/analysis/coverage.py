"""Answer coverage@{5,10,20,50} over a predictions jsonl, as
``scripts/analysis/coverage.py`` prints it (reference:
build_server/metrics.py:15-24)::

    python -m jsa_rag_tpu_torch.analysis.coverage predictions.jsonl

Each row: ``{"passages": [{"text": ...}, ...], "answers": [...]}``; a row
covers at k when one of its answers appears in one of its first k
passages. Prints the means and the row count ``n`` as one JSON line.
"""

from __future__ import annotations

import json
import sys

from ..utils.metrics import coverage_at_k


def main(argv=None) -> dict:
    (pred_path,) = argv if argv is not None else sys.argv[1:2]
    totals: dict[str, float] = {}
    n = 0
    with open(pred_path) as f:
        for line in f:
            row = json.loads(line)
            texts = [p.get("text", "") for p in row.get("passages", [])]
            for k, v in coverage_at_k(texts, row.get("answers", [])).items():
                totals[k] = totals.get(k, 0.0) + v
            n += 1
    out = {k: v / max(n, 1) for k, v in totals.items()}
    out["n"] = n
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
