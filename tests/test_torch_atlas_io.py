"""Port parity: the Atlas-format interop of ``jsa_rag_tpu_torch`` (shards
written in the reference's layout: torch-saved (dim, n) fp16 tensors and
pickled passage lists, src/index.py:62-112) — ``tests/test_atlas_io.py``'s
six tests against the port, then each package reading what the other
wrote, ``convert``'s output in both ``load_index``, the tower import against
the JAX package's arrays, an IVF index fed from the shards, and the CLI.

Tolerances: rows, passages and imported tower arrays are compared exactly
(fp16 values move between the layouts unchanged; the towers are the same
float32 tensors). Searches over the same fp16 rows: equal ids."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.index import atlas_io as jatlas
from jsa_rag_tpu.index import load_index as jload_index
from jsa_rag_tpu.index.flat import ShardedFlatIndex as JFlat
from jsa_rag_tpu.parallel.mesh import make_mesh
from jsa_rag_tpu_torch.index import atlas_io as tatlas
from jsa_rag_tpu_torch.index import load_index
from jsa_rag_tpu_torch.index.flat import ShardedFlatIndex as TFlat
from jsa_rag_tpu_torch.index.ivf import ShardedIVFIndex as TIVF

N, D, SHARDS = 100, 32, 4


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def atlas_dir(tmp_path_factory):
    """Shards written as the reference's save_index does: fp16 (dim, n_i)
    tensors and pickled passage lists."""
    path = tmp_path_factory.mktemp("atlas_fmt")
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((N, D)).astype(np.float16)
    passages = [{"id": str(i), "title": f"t{i}", "text": f"body {i}"}
                for i in range(N)]
    per = -(-N // SHARDS)
    for shard, s in enumerate(range(0, N, per)):
        e = min(s + per, N)
        torch.save(torch.from_numpy(emb[s:e].T.copy()),
                   path / f"embeddings.{shard}.pt")
        with open(path / f"passages.{shard}.pt", "wb") as f:
            pickle.dump(passages[s:e], f, protocol=pickle.HIGHEST_PROTOCOL)
    return str(path), emb, passages


def _read_all(mod, path):
    rows, docs = [], []
    for r, p in mod.iter_atlas_shards(path):
        assert r.shape[0] == len(p)
        rows.append(r)
        docs.extend(p)
    return np.concatenate(rows), docs


def _port_f16(path, n=N):
    idx = TFlat(n, D, "float16", device="cpu")
    tatlas.load_atlas_into_index(idx, path)
    return idx


# ------------------------------------------- tests/test_atlas_io.py, ported
def test_detect_and_iterate(atlas_dir):
    path, emb, passages = atlas_dir
    assert tatlas.detect_n_shards(path) == SHARDS
    rows, docs = _read_all(tatlas, path)
    np.testing.assert_array_equal(rows, emb)
    assert docs == passages
    with pytest.raises(FileNotFoundError):
        tatlas.detect_n_shards(os.path.dirname(path))


def test_convert_then_load_flat(atlas_dir, tmp_path):
    path, emb, passages = atlas_dir
    dst = str(tmp_path / "converted")
    meta = tatlas.convert_atlas_index(path, dst)
    assert meta["n_passages"] == N and meta["dim"] == D
    assert meta["store_f16_bits"] and meta["dtype"] == "int16"
    assert meta["converted_from"] == "atlas"
    with open(os.path.join(dst, "passages.jsonl")) as f:
        assert [json.loads(line) for line in f] == passages
    idx = load_index(dst, device="cpu")
    assert idx.n_passages == N and idx.storage == "float16"
    np.testing.assert_array_equal(
        idx.embeddings_as_float().numpy().astype(np.float16), emb)
    _, ids = idx.search(emb[7:8].astype(np.float32), 5)
    assert int(ids[0, 0]) == 7


def test_load_atlas_into_live_index(atlas_dir):
    path, emb, _ = atlas_dir
    idx = TFlat(N, D, "float32", device="cpu", method="exact")
    assert tatlas.load_atlas_into_index(idx, path) == N
    np.testing.assert_array_equal(idx.embeddings_as_float().numpy(),
                                  emb.astype(np.float32))
    with pytest.raises(ValueError, match="hold 100"):
        tatlas.load_atlas_into_index(TFlat(N - 1, D, "float32",
                                           device="cpu"), path)


def test_export_back_to_atlas_format(atlas_dir, tmp_path):
    path, emb, passages = atlas_dir
    out = str(tmp_path / "exported")
    tatlas.save_index_atlas_format(_port_f16(path), passages, out,
                                   total_saved_shards=8)
    assert tatlas.detect_n_shards(out) == 8
    rows, docs = _read_all(tatlas, out)
    np.testing.assert_array_equal(rows, emb)
    assert docs == passages
    with pytest.raises(ValueError, match="passages vs"):
        tatlas.save_index_atlas_format(_port_f16(path), passages[:-1], out)


def _bert_checkpoint(tmp_path):
    """A model.pth.tar with untied query/passage BERT towers under the
    reference's key naming, a generator key, and the towers."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(vocab_size=64, hidden_size=32,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  intermediate_size=64,
                                  max_position_embeddings=64)
    torch.manual_seed(0)
    q_tower, p_tower = (transformers.BertModel(cfg),
                        transformers.BertModel(cfg))
    sd = {}
    for pre, m in [("retriever.query_contriever.", q_tower),
                   ("retriever.passage_contriever.", p_tower)]:
        sd.update({pre + k: v for k, v in m.state_dict().items()})
    sd["generator.something"] = torch.zeros(1)
    path = str(tmp_path / "model.pth.tar")
    torch.save({"model": sd, "step": 123}, path)
    return path, q_tower, p_tower


def test_import_atlas_retriever_towers(tmp_path):
    path, q_tower, p_tower = _bert_checkpoint(tmp_path)
    towers = tatlas.import_atlas_retriever_towers(path, n_layers=2)
    assert towers is not None
    q, p = towers
    for tree, m in ((q, q_tower), (p, p_tower)):
        np.testing.assert_array_equal(
            tree["embed"]["word"],
            m.state_dict()["embeddings.word_embeddings.weight"].numpy())
    torch.save({"model": {"generator.w": torch.zeros(1)}},
               str(tmp_path / "gen_only.pth.tar"))
    assert tatlas.import_atlas_retriever_towers(
        str(tmp_path / "gen_only.pth.tar"), 2) is None


def test_export_writes_exact_shard_count(atlas_dir, tmp_path):
    """Exactly total_saved_shards files, ragged and empty tails included."""
    path, emb, passages = atlas_dir
    for shards in (13, 128):
        out = str(tmp_path / f"exp{shards}")
        tatlas.save_index_atlas_format(_port_f16(path), passages, out,
                                       total_saved_shards=shards)
        assert tatlas.detect_n_shards(out) == shards
        rows, docs = _read_all(tatlas, out)
        np.testing.assert_array_equal(rows, emb)
        assert docs == passages


# ---------------------------------------------------- across the packages
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_reads_the_others_export(atlas_dir, tmp_path, mesh1,
                                                writer):
    path, emb, passages = atlas_dir
    out = str(tmp_path / "out")
    if writer == "jax":
        j = JFlat(mesh1, N, D, dtype=jnp.float16)
        jatlas.load_atlas_into_index(j, path)
        jatlas.save_index_atlas_format(j, passages, out,
                                       total_saved_shards=7)
        reader = tatlas
    else:
        tatlas.save_index_atlas_format(_port_f16(path), passages, out,
                                       total_saved_shards=7)
        reader = jatlas
    assert reader.detect_n_shards(out) == 7
    rows, docs = _read_all(reader, out)
    np.testing.assert_array_equal(rows, emb)
    assert docs == passages


@pytest.mark.parametrize("converter", ["jax", "port"])
def test_convert_output_loads_in_both_packages(atlas_dir, tmp_path, mesh1,
                                               converter):
    path, emb, _ = atlas_dir
    dst = str(tmp_path / "conv")
    mod = jatlas if converter == "jax" else tatlas
    meta = mod.convert_atlas_index(path, dst)
    with open(os.path.join(dst, "meta.json")) as f:
        assert json.load(f) == meta
    t = load_index(dst, device="cpu", method="exact")
    j = jload_index(dst, mesh1, method="exact")
    np.testing.assert_array_equal(
        t.embeddings_as_float().numpy(), np.asarray(j.embeddings_as_float()))
    q = np.random.default_rng(3).standard_normal((4, D)).astype(np.float32)
    _, ti = t.search(q, 5)
    _, ji = j.search(jnp.asarray(q), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_tower_import_matches_jax(tmp_path):
    path, _, _ = _bert_checkpoint(tmp_path)
    want = jatlas.import_atlas_retriever_towers(path, n_layers=2)
    got = tatlas.import_atlas_retriever_towers(path, n_layers=2)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=str(p))


def test_load_atlas_into_ivf_finalises_it(atlas_dir):
    path, emb, _ = atlas_dir
    idx = TIVF(N, D, device="cpu", n_lists=4, n_probe=4, storage="pq",
               code_size=8, refine=True)
    assert tatlas.load_atlas_into_index(idx, path) == N
    assert idx._staging is None and idx.codebooks is not None
    assert sorted(idx.list_ids.tolist()) == list(range(N))
    q = emb[[3, 50, 97]].astype(np.float32)
    _, ids = idx.search(q, 5)
    assert ids[:, 0].tolist() == [3, 50, 97]


def test_cli_round_trips_with_the_jax_package(atlas_dir, tmp_path):
    """``convert`` a directory the JAX package exported, then ``export``
    the converted index (--device cpu): the JAX package reads back the
    rows and passages it wrote."""
    path, emb, passages = atlas_dir
    jexp = str(tmp_path / "jexp")
    jatlas.convert_atlas_index(path, str(tmp_path / "jconv"))
    j = jload_index(str(tmp_path / "jconv"),
                    make_mesh(n_data=1, n_index=1,
                              devices=jax.devices()[:1]))
    jatlas.save_index_atlas_format(j, passages, jexp, total_saved_shards=5)
    conv = str(tmp_path / "tconv")
    meta = tatlas.main(["convert", jexp, conv])
    assert meta["n_passages"] == N and meta["n_files"] == 5
    out = str(tmp_path / "texp")
    res = tatlas.main(["export", conv, os.path.join(conv, "passages.jsonl"),
                       out, "--shards", "6", "--device", "cpu"])
    assert res == {"exported": N, "shards": 6, "dst": out}
    rows, docs = _read_all(jatlas, out)
    np.testing.assert_array_equal(rows, emb)
    assert docs == passages
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tatlas.main(["export", conv, os.path.join(conv,
                                                      "passages.jsonl"),
                         out])
