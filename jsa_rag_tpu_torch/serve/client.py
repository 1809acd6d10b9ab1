"""HTTP retrieve/rebuild client (reference: src/post.py:6-31
``call_retrieve_api`` posting flattened query embeddings). stdlib urllib —
``requests`` is not required. The port's own copy of
``jsa_rag_tpu/serve/client.py``."""

from __future__ import annotations

import json
import urllib.request

import numpy as np


def call_retrieve_api(query_embs, topk: int = 10,
                      url: str = "http://127.0.0.1:29501"):
    """query_embs: (B, d) array-like f32 -> (docs, scores)."""
    q = np.asarray(query_embs, np.float32)
    payload = {
        "query_embs": q.reshape(-1).tolist(),
        "bsz": int(q.shape[0]),
        "topk": int(topk),
    }
    req = urllib.request.Request(
        f"{url}/retrieve", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        docs, scores = json.loads(resp.read())
    return docs, scores


def call_rebuild_api(load_dir: str | None = None,
                     url: str = "http://127.0.0.1:29501"):
    """Trigger an index rebuild (reference's gRPC run_build /
    POST /rebuild, train.py:194-199, build_server/server_start.py:191-196)."""
    req = urllib.request.Request(
        f"{url}/rebuild", data=json.dumps({"load_dir": load_dir}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=3600) as resp:
        return json.loads(resp.read())
