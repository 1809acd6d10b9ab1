"""Port parity of the serving slice: ``build_index`` with the port's encoder
against JAX's over ``PassageStore.synthetic``, and the HTTP server started
by ``jsa_rag_tpu_torch.serve.__main__.main`` (``--device cpu``) against the
JAX server on the same saved index.

Tolerances: the towers agree to 1e-5 (``test_torch_bert``), so built
indexes are compared by their decoded rows at 5e-5 — the encoder difference
plus up to one plane-2 quantisation step (s2 ~ 1.6e-5 on unit rows at
d=32) — and plane-1 codes may differ by one step in under 1% of cells where
a value sits on a rounding boundary. Served scores agree to 1e-5 and ids as
in ``test_torch_mips`` (ties compared as sets)."""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.data.passages import PassageStore as JaxStore
from jsa_rag_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from jsa_rag_tpu.index.build import build_index as jax_build_index
from jsa_rag_tpu.index.build import make_encode_fn as jax_make_encode_fn
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
from jsa_rag_tpu.models.bert import BertConfig as JaxBertConfig
from jsa_rag_tpu.models.retriever import (DualEncoderRetriever as JaxRetriever,
                                          RetrieverConfig as JaxRetrieverConfig)
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu.serve.__main__ import main as jax_serve_main
from jsa_rag_tpu_torch.convert import retriever_params_from_numpy
from jsa_rag_tpu_torch.data import PassageStore, SimpleTokenizer
from jsa_rag_tpu_torch.index.build import build_index, make_encode_fn
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex
from jsa_rag_tpu_torch.models import (BertConfig, DualEncoderRetriever,
                                      RetrieverConfig)
from jsa_rag_tpu_torch.serve.__main__ import main as serve_main
from jsa_rag_tpu_torch.serve.client import (call_rebuild_api,
                                            call_retrieve_api)
from jsa_rag_tpu_torch.serve.server import _SearchBatcher

from test_torch_mips import _unit_rows, assert_same_topk

GEOM = dict(vocab_size=1200, hidden=32, layers=2, heads=4, intermediate=64,
            max_positions=64, pooling="cls_norm")


def test_build_index_matches_jax():
    """Length buckets, sort windows (with a ragged last window) and the
    unsort fill the same int8r rows in both packages."""
    n = 300
    jstore, tstore = JaxStore.synthetic(n, seed=0), PassageStore.synthetic(
        n, seed=0)
    assert [tstore[i] for i in range(n)] == [jstore[i] for i in range(n)]
    # one fixed vocabulary: the build tokenises on two threads, so a
    # growing vocabulary would number words in whichever order they ran
    warm = JaxTokenizer(max_vocab=GEOM["vocab_size"])
    for text in jstore.texts():
        warm.tokenize(text)
    jtok = JaxTokenizer(vocab=warm.vocab, max_vocab=GEOM["vocab_size"],
                        frozen=True)
    ttok = SimpleTokenizer(vocab=warm.vocab, max_vocab=GEOM["vocab_size"],
                           frozen=True)

    jr = JaxRetriever(JaxRetrieverConfig(bert=JaxBertConfig(**GEOM)))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: (rng.normal(0.0, 0.05, x.shape)
                   + (1.0 if x.ndim == 1 else 0.0)).astype(np.float32),
        jr.init(jax.random.PRNGKey(0)))
    tr = DualEncoderRetriever(RetrieverConfig(bert=BertConfig(**GEOM)),
                              device="cpu")
    tr.load_state_dict(retriever_params_from_numpy(tree))

    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    jidx = JaxIndex(mesh, n, GEOM["hidden"], dtype="int8r")
    encode = jax_make_encode_fn(jr)
    kw = dict(batch_size=32, max_length=48, sort_window=4)
    jax_build_index(jidx, jstore, lambda i, m: encode(tree, i, m), jtok, **kw)
    tidx = ShardedFlatIndex(n, GEOM["hidden"], device="cpu")
    stats = build_index(tidx, tstore, make_encode_fn(tr.eval()), ttok, **kw)
    assert stats["indexing/passages_per_sec"][0] > 0

    np.testing.assert_allclose(tidx.embeddings_as_float().numpy(),
                               np.asarray(jidx.embeddings_as_float()),
                               rtol=0, atol=5e-5)
    v1_j = np.asarray(jidx.embeddings)[:, :n].T.astype(np.int32)
    v1_t = tidx.embeddings[:n].numpy().astype(np.int32)
    assert np.abs(v1_t - v1_j).max() <= 1
    assert (v1_t != v1_j).mean() < 0.01
    # corpus order survived the length sort: row i is passage i
    ids, mask = ttok.encode_batch([f"{p['title']} {p['text']}" for p in
                                   (tstore[5], tstore[250])], 48)
    with torch.no_grad():
        direct = tr.embed_passages(torch.from_numpy(ids),
                                   torch.from_numpy(mask))
    np.testing.assert_allclose(tidx.embeddings_as_float()[[5, 250]].numpy(),
                               direct.numpy(), rtol=0, atol=5e-5)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX-built int8r index and its passages jsonl on disk."""
    root = tmp_path_factory.mktemp("served")
    n, d = 200, 32
    e = _unit_rows(n, d, seed=21)
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    idx = JaxIndex(mesh, n, d, dtype="int8r")
    idx.set_embeddings(0, e)
    idx.save(str(root / "index"), n_files=3)
    with open(root / "passages.jsonl", "w") as f:
        for i in range(n):
            f.write(json.dumps(
                {"id": str(i), "title": f"t{i}", "text": f"body {i}"}) + "\n")
    return root, e


@pytest.fixture(scope="module")
def servers(saved):
    root, e = saved
    argv = ["--index_path", str(root / "index"),
            "--passages", str(root / "passages.jsonl"), "--port", "0"]
    tsrv = serve_main(argv + ["--device", "cpu"], block=False)
    jsrv = jax_serve_main(argv, block=False)
    yield (f"http://127.0.0.1:{tsrv.port}", f"http://127.0.0.1:{jsrv.port}",
           e, tsrv)
    tsrv.stop()
    jsrv.stop()


def test_http_roundtrip_matches_jax_server(servers):
    turl, jurl, e, tsrv = servers
    assert tsrv.index.device == torch.device("cpu")
    rng = np.random.default_rng(3)
    gold = rng.integers(0, len(e), 5)
    q = e[gold] + 0.05 * rng.standard_normal(e[gold].shape).astype(
        np.float32)
    for topk in (1, 10, 37):
        tdocs, tscores = call_retrieve_api(q, topk=topk, url=turl)
        jdocs, jscores = call_retrieve_api(q, topk=topk, url=jurl)
        ti = np.array([[int(d["id"]) for d in row] for row in tdocs])
        ji = np.array([[int(d["id"]) for d in row] for row in jdocs])
        assert ti.shape == (5, topk)
        assert_same_topk(tscores, ti, jscores, ji)
        assert (ti[:, 0] == gold).all()
        assert tdocs[0][0] == {"id": str(gold[0]), "title": f"t{gold[0]}",
                               "text": f"body {gold[0]}"}


def test_health_and_rebuild(servers):
    turl, _, e, _ = servers
    with urllib.request.urlopen(f"{turl}/health") as r:
        assert json.loads(r.read()) == {"status": "ok",
                                        "n_passages": len(e)}
    with pytest.raises(urllib.error.HTTPError) as ei:
        call_rebuild_api("some/dir", url=turl)
    assert ei.value.code == 400
    req = urllib.request.Request(
        f"{turl}/retrieve", data=b"not json",
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req)
    assert ei.value.code == 400


def test_native_store_matches_jax_and_serves(saved, servers, tmp_path):
    """The port compiles ``native/passage_store.cpp`` itself; its store
    reads back what the JAX package's does, and ``--mmap_store`` serves."""
    from jsa_rag_tpu.data import native_store as jax_native
    from jsa_rag_tpu_torch.data import native_store

    root, e = saved
    rows = [{"id": "0", "title": 'quotes "in"', "text": "tab\there é中文"},
            {"id": "1", "title": "", "text": "emoji \U0001f600 \\ end"}]
    with open(tmp_path / "odd.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    assert native_store.build_store(str(tmp_path / "odd.jsonl"),
                                    str(tmp_path / "odd.bin")) == 2
    jax_native.build_store(str(tmp_path / "odd.jsonl"),
                           str(tmp_path / "odd_jax.bin"))
    mine = native_store.NativePassageStore(str(tmp_path / "odd.bin"))
    theirs = jax_native.NativePassageStore(str(tmp_path / "odd_jax.bin"))
    assert [mine[i] for i in range(2)] == rows == [theirs[i] for i in
                                                   range(2)]
    mine.close()
    theirs.close()

    native_store.build_store(str(root / "passages.jsonl"),
                             str(tmp_path / "store.bin"))
    srv = serve_main(["--index_path", str(root / "index"), "--mmap_store",
                      str(tmp_path / "store.bin"), "--port", "0",
                      "--device", "cpu"], block=False)
    try:
        docs, _ = call_retrieve_api(e[[7]], topk=2,
                                    url=f"http://127.0.0.1:{srv.port}")
        assert docs[0][0] == {"id": "7", "title": "t7", "text": "body 7"}
    finally:
        srv.stop()


def test_main_rejects_wrong_corpus_and_missing_cuda(saved, tmp_path):
    root, _ = saved
    with open(tmp_path / "short.jsonl", "w") as f:
        f.write(json.dumps({"id": "0", "title": "t", "text": "x"}) + "\n")
    with pytest.raises(SystemExit):
        serve_main(["--index_path", str(root / "index"), "--passages",
                    str(tmp_path / "short.jsonl"), "--port", "0",
                    "--device", "cpu"], block=False)
    if not torch.cuda.is_available():  # the default device is cuda
        with pytest.raises(RuntimeError, match="cuda"):
            serve_main(["--index_path", str(root / "index"), "--passages",
                        str(root / "passages.jsonl"), "--port", "0"],
                       block=False)


class _RecordingIndex:
    """Stands in for the index: records (rows, k) of each dispatch and
    answers row r of a batch with ids r*100 .. r*100+k-1."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def search(self, q, k):
        with self.lock:
            self.calls.append((q.shape[0], k))
        ids = torch.arange(q.shape[0])[:, None] * 100 + torch.arange(k)
        scores = torch.from_numpy(np.asarray(q)[:, :1]).expand(-1, k)
        return scores.contiguous(), ids.to(torch.int32)


def test_batcher_power_of_two_buckets():
    """Rows pad to a power of two (at least 8) and k to a power of two;
    every caller gets exactly its own rows, cut to its own k."""
    idx = _RecordingIndex()
    batcher = _SearchBatcher(idx, window_s=0.0)
    try:
        for rows, k, want in ((3, 5, (8, 8)), (9, 100, (16, 128)),
                              (8, 1, (8, 1)), (33, 64, (64, 64))):
            q = np.arange(rows, dtype=np.float32)[:, None].repeat(4, 1)
            scores, ids = batcher.search(q, k)
            assert idx.calls[-1] == want
            assert scores.shape == (rows, k) and ids.shape == (rows, k)
            np.testing.assert_array_equal(scores[:, 0], np.arange(rows))

        # concurrent callers: invariants hold however they coalesce
        results = {}

        def client(i):
            q = np.full((2, 4), float(i), np.float32)
            results[i] = batcher.search(q, 3)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        for i, (scores, ids) in results.items():
            assert scores.shape == (2, 3)
            assert (scores == i).all()
        assert all(r >= 8 and r & (r - 1) == 0 and k == 4
                   for r, k in idx.calls[4:])
    finally:
        batcher.stop()
