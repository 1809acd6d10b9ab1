"""Thin HTTP serving wrapper around the in-process index.

Counterpart of ``jsa_rag_tpu/serve/server.py`` (:26-255); the index search
runs on the index's device and answers come back as numpy.

Parity with the reference's standalone FastAPI index server
(build_server/server_start.py:181-201: POST /retrieve with flattened query
embeddings -> [docs, scores]; POST /rebuild reloading from a checkpoint dir)
— but as an *optional* veneer: in this framework training never needs the
server (the index lives in the same program; SURVEY.md §5.8), so this exists
for external consumers / serving deployments only. stdlib http.server
(fastapi is not in this image), threaded.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

logger = logging.getLogger(__name__)


def _host(t) -> np.ndarray:
    """Search output (a tensor on any device, or an array) -> numpy."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


class _SearchBatcher:
    """Coalesce concurrent searches into one bucketed device dispatch.

    Two serving problems this solves (neither exists in the reference,
    whose FAISS server is CPU-side and shape-oblivious):

    - ragged per-request batch sizes and k would give the search (and its
      CUDA kernel) a new shape per client, so request rows are padded to
      power-of-two buckets (min 8) and k to a power-of-two bucket: the
      kernel sees a few stable shapes and the pool sizing is per bucket;
    - concurrent requests each pay a full device dispatch: requests
      arriving within ``window_s`` are concatenated and searched as ONE
      batch, then sliced back per request. A single worker thread owns
      the device, so searches never interleave.
    """

    def __init__(self, index, window_s: float = 0.003,
                 max_rows: int = 1024):
        self.index = index
        self.window_s = window_s
        self.max_rows = max_rows
        self._lock = threading.Lock()
        self._pending: list[dict] = []
        self._kick = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def search(self, q: np.ndarray, topk: int):
        """Blocking: enqueue one request's rows, wait for its slice."""
        item = {"q": q, "k": topk, "done": threading.Event()}
        with self._lock:
            if self._stop:
                raise RuntimeError("search batcher stopped")
            self._pending.append(item)
        self._kick.set()
        # bounded waits so a dead worker thread can never hang the caller
        while not item["done"].wait(timeout=1.0):
            if not self._thread.is_alive():
                # the worker may have delivered this item (dispatch or
                # shutdown drain) in the gap between the wait timing out
                # and the liveness check — re-check before raising
                if item["done"].is_set():
                    break
                raise RuntimeError("search batcher worker died")
        if "err" in item:
            raise item["err"]
        return item["scores"], item["ids"]

    def _loop(self):
        while not self._stop:
            self._kick.wait(timeout=0.1)
            # clear BEFORE reading pending: a set() that lands after this
            # point survives for the next iteration, so a request enqueued
            # between the check and the clear is never delayed
            self._kick.clear()
            if self._stop:
                break
            with self._lock:
                if not self._pending:
                    continue
            time.sleep(self.window_s)  # collection window
            with self._lock:
                batch, self._pending = self._pending, []
            while batch:
                # respect max_rows per dispatch
                take, rows = [], 0
                while batch and rows + batch[0]["q"].shape[0] <= self.max_rows:
                    take.append(batch.pop(0))
                    rows += take[-1]["q"].shape[0]
                if not take:  # single oversized request: dispatch alone
                    take = [batch.pop(0)]
                    rows = take[0]["q"].shape[0]
                self._dispatch(take, rows)
        # fail anything still queued so no waiter hangs at shutdown
        with self._lock:
            leftover, self._pending = self._pending, []
        for it in leftover:
            it["err"] = RuntimeError("search batcher stopped")
            it["done"].set()

    def _dispatch(self, take: list[dict], rows: int):
        try:
            qs = np.concatenate([it["q"] for it in take])
            k_max = max(it["k"] for it in take)
            k_pad = 1 << max(0, k_max - 1).bit_length()
            r_pad = max(8, 1 << max(0, rows - 1).bit_length())
            if r_pad > rows:
                qs = np.pad(qs, ((0, r_pad - rows), (0, 0)))
            s, i = self.index.search(qs, k_pad)
            s, i = _host(s), _host(i)
        except Exception as e:  # propagate to every waiter
            for it in take:
                it["err"] = e
                it["done"].set()
            return
        o = 0
        for it in take:
            b = it["q"].shape[0]
            kk = min(it["k"], s.shape[1])  # search clamps k to n_passages
            it["scores"], it["ids"] = s[o:o + b, :kk], i[o:o + b, :kk]
            o += b
            it["done"].set()

    def stop(self):
        with self._lock:
            self._stop = True
        self._kick.set()
        self._thread.join(timeout=2)


class IndexServer:
    """Serve an index + passage store over HTTP.

    endpoints:
      POST /retrieve {"query_embs": [flat f32], "bsz": B, "topk": K}
            -> [[passages per query], [scores per query]]
      POST /rebuild  {"load_dir": optional} -> {"status": "ok"}
            (invokes the registered rebuild callback — the in-process
             re-embed, replacing the reference's checkpoint reload)
      GET  /health   -> {"status": "ok", "n_passages": N}
    """

    def __init__(self, index, store, dim: int, rebuild_fn=None,
                 host: str = "127.0.0.1", port: int = 29501,
                 coalesce_window_s: float = 0.003):
        self.index = index
        self.store = store
        self.dim = dim
        self.rebuild_fn = rebuild_fn
        self.host, self.port = host, port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # 0 disables coalescing (each request dispatches directly)
        self.batcher = (_SearchBatcher(index, window_s=coalesce_window_s)
                        if coalesce_window_s > 0 else None)

    # ------------------------------------------------------------------ http
    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                logger.debug(fmt, *args)

            def _send(self, code: int, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    self._send(200, {"status": "ok",
                                     "n_passages": len(server.store)})
                else:
                    self._send(404, {"error": "unknown endpoint"})

            def do_POST(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    data = json.loads(self.rfile.read(length) or b"{}")
                except Exception as e:
                    self._send(400, {"error": f"bad json: {e}"})
                    return
                if self.path == "/retrieve":
                    self._retrieve(data)
                elif self.path == "/rebuild":
                    self._rebuild(data)
                else:
                    self._send(404, {"error": "unknown endpoint"})

            def _retrieve(self, data):
                try:
                    bsz = int(data["bsz"])
                    topk = int(data.get("topk", 10))
                    q = np.asarray(data["query_embs"], np.float32)
                    q = q.reshape(bsz, server.dim)
                except Exception as e:
                    self._send(400, {"error": f"bad request: {e}"})
                    return
                try:
                    if server.batcher is not None:
                        scores, ids = server.batcher.search(q, topk)
                    else:
                        scores, ids = server.index.search(q, topk)
                    scores, ids = _host(scores), _host(ids)
                    # -1 marks unfilled slots (IVF with n_probe too small
                    # for topk); a raw store[int(i)] would wrap to the LAST
                    # passage via python negative indexing
                    docs = [[({} if i < 0 else
                              dict(server.store[int(i)]))
                             for i in row] for row in ids]
                    self._send(200, [docs, scores.tolist()])
                except Exception as e:  # search/store failure -> JSON 500
                    self._send(500, {"error": str(e)})

            def _rebuild(self, data):
                if server.rebuild_fn is None:
                    self._send(400, {"error": "no rebuild callback"})
                    return
                try:
                    server.rebuild_fn(data.get("load_dir"))
                except Exception as e:
                    self._send(500, {"error": str(e)})
                    return
                self._send(200, {"status": "ok"})

        return Handler

    # --------------------------------------------------------------- control
    def start(self) -> int:
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler())
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("index server on %s:%d", self.host, self.port)
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd = None
        if self.batcher is not None:
            self.batcher.stop()
