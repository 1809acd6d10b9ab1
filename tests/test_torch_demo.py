"""The port's hard-copy demo (``jsa_rag_tpu_torch/demo/``) against the JAX
scripts it ports: the InfoNCE step and one AdamW update against
``scripts/pretrain_hard_encoder.py``'s optax step built here, the
tokenizer and the batch sampler bit for bit, the artifact pickles loading
in both packages, and tiny CPU runs of the three modules."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jsa_rag_tpu.data.tokenizer import SimpleTokenizer as JTok
from jsa_rag_tpu.models import lm as jlm
from jsa_rag_tpu.models.bert import BertConfig as JBert
from jsa_rag_tpu.models.retriever import DualEncoderRetriever as JRetriever
from jsa_rag_tpu.models.retriever import RetrieverConfig as JRetrieverConfig
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch.demo import (e2e_hard_copy, pretrain_copy_generator,
                                    pretrain_hard_encoder, read_jsonl)
from jsa_rag_tpu_torch.models import lm as tlm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from scripts.pretrain_copy_generator import \
    load_generator as jload_generator  # noqa: E402
from scripts.pretrain_hard_encoder import \
    load_artifact as jload_artifact  # noqa: E402

ARTIFACTS = os.path.join(ROOT, "docs", "demo", "artifacts")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A small ``make_copy_task_data.py --hard`` set (60 topics)."""
    out = tmp_path_factory.mktemp("hardcopy")
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "scripts", "make_copy_task_data.py"),
                    "--out", str(out), "--hard", "--n_topics", "60",
                    "--n_train_topics", "40", "--n_eval", "8",
                    "--train_per_topic", "2"], check=True,
                   capture_output=True, timeout=60)
    return str(out)


def _batch(rng, vocab: int, b: int, length: int):
    ids = rng.integers(6, vocab, (b, length)).astype(np.int32)
    mask = np.ones((b, length), np.int32)
    for r, n in enumerate(rng.integers(3, length, b)):
        ids[r, n:], mask[r, n:] = 0, 0
    return ids, mask


def test_infonce_step_matches_jax():
    """The same numpy params (the JAX retriever's init, carried across by
    ``convert.py``) and batch: the symmetric InfoNCE loss within 1e-5 of
    the script's (``:120-131``), and every param after one AdamW step
    (optax.adamw(3e-4, weight_decay=0.01)) within 1e-6."""
    vocab, hidden, b, tau, lr = 64, 32, 8, 0.05, 3e-4
    jcfg = JBert(vocab_size=vocab, hidden=hidden, layers=2, heads=4,
                 intermediate=2 * hidden, max_positions=64,
                 pooling="mean_norm", dtype=jnp.float32)
    jret = JRetriever(JRetrieverConfig(bert=jcfg, tied=True))
    params = jret.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    qi, qm = _batch(rng, vocab, b, 16)
    pi, pm = _batch(rng, vocab, b, 48)

    def loss_fn(p):
        logits = (jret.embed_queries(p, qi, qm)
                  @ jret.embed_passages(p, pi, pm).T) / tau
        lbl = jnp.arange(b)
        return (optax.softmax_cross_entropy_with_integer_labels(logits, lbl)
                + optax.softmax_cross_entropy_with_integer_labels(
                    logits.T, lbl)).mean() / 2

    tx = optax.adamw(lr, weight_decay=0.01)

    @jax.jit
    def step(p):
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, _ = tx.update(g, tx.init(p), p)
        return loss, optax.apply_updates(p, updates)

    want_loss, stepped = step(params)
    want = convert.retriever_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, stepped))

    tcfg = pretrain_hard_encoder.encoder_config(vocab, 2, hidden)
    assert {k: v for k, v in dataclasses.asdict(tcfg).items()
            if k != "dtype"} == {k: v for k, v in
                                 dataclasses.asdict(jcfg).items()
                                 if k != "dtype"}
    tret = pretrain_hard_encoder.make_retriever(tcfg, "cpu", 0)
    tret.load_state_dict(convert.retriever_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    ttx = pretrain_hard_encoder.adamw(tret, lr, 0.01, torch.device("cpu"))
    t = torch.from_numpy
    got_loss = pretrain_hard_encoder.train_step(
        tret, ttx, (t(qi), t(qm), t(pi), t(pm)), tau)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-5
    got = tret.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    assert ttx.count == 1


def test_tokenizer_matches_script(data):
    """``build_tokenizer``'s vocabulary equals the JAX ``SimpleTokenizer``
    built as the script builds it (``:97-102``), id for id."""
    passages = read_jsonl(os.path.join(data, "passages.jsonl"))
    train = read_jsonl(os.path.join(data, "train.jsonl"))
    want = JTok(max_vocab=8192)
    for p in passages:
        want.encode(f"{p['title']} {p['text']}", 48)
    for r in train[:len(passages)]:
        want.encode(r["question"], 16)
    got = pretrain_hard_encoder.build_tokenizer(passages, train)
    assert got.vocab == want.vocab and got.frozen
    assert got.vocab_size == want.vocab_size == 8192


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_batch_matches_script(data, seed):
    """Five batches of ``sample_batch`` equal the script's sampler's
    (``:136-150``, its lines copied here) for one seed, bit for bit."""
    train = read_jsonl(os.path.join(data, "train.jsonl"))
    gold = np.asarray([int(r["passages"][0]["id"]) for r in train])
    topic_rows: dict[int, list[int]] = {}
    for j, g in enumerate(gold):
        topic_rows.setdefault(int(g), []).append(j)
    topic_ids = np.asarray(sorted(topic_rows))
    rng = np.random.default_rng(seed)
    want = []
    for _ in range(5):
        ts = rng.choice(topic_ids, 16, replace=False)
        want.append(np.asarray(
            [topic_rows[int(t)][rng.integers(len(topic_rows[int(t)]))]
             for t in ts]))
    rows, ids = pretrain_hard_encoder.topic_rows(gold)
    rng = np.random.default_rng(seed)
    for w in want:
        got = pretrain_hard_encoder.sample_batch(rng, rows, ids, 16)
        np.testing.assert_array_equal(got, w)
        assert len(set(gold[got].tolist())) == 16  # distinct topics


def _question_ids(tok, data, n=4, length=16):
    rows = read_jsonl(os.path.join(data, "dev.jsonl"))[:n]
    return tok.encode_batch([r["question"] for r in rows], length)


def test_port_pickles_load_in_jax(data, tmp_path):
    """An encoder and a generator pickle the port wrote load through the
    JAX scripts' ``load_artifact`` / ``load_generator`` and give the port's
    embeddings and logits within 1e-4."""
    passages = read_jsonl(os.path.join(data, "passages.jsonl"))
    train = read_jsonl(os.path.join(data, "train.jsonl"))
    tok = pretrain_hard_encoder.build_tokenizer(passages, train)
    ret = pretrain_hard_encoder.make_retriever(
        pretrain_hard_encoder.encoder_config(tok.vocab_size, 2, 32), "cpu",
        1)
    enc_path = str(tmp_path / "enc.pkl")
    pretrain_hard_encoder.save_artifact(enc_path, ret, tok, {"steps": 0})
    cfg = pretrain_copy_generator.generator_config(tok.vocab_size)
    gen = tlm.lm_init(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(2))
    gen_path = str(tmp_path / "gen.pkl")
    pretrain_copy_generator.save_generator(gen_path, cfg, gen, tok,
                                           {"steps": 0})

    ids, mask = _question_ids(tok, data)
    jret, jparams, jtok = jload_artifact(enc_path)
    assert jtok.vocab == tok.vocab
    tret, ttok = pretrain_hard_encoder.load_artifact(enc_path, "cpu")
    assert ttok.vocab == tok.vocab
    with torch.no_grad():
        got = tret.embed_queries(torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jret.embed_queries(jparams, ids, mask)), atol=1e-4)

    jcfg, jgen, _ = jload_generator(gen_path)
    tcfg, tgen, _ = pretrain_copy_generator.load_generator(gen_path, "cpu")
    assert {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(jcfg)
            if f.name != "dtype"} == {
                f.name: getattr(jcfg, f.name)
                for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    with torch.no_grad():
        got = tlm.lm_logits(tgen, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jlm.lm_logits(jgen, jcfg, ids, mask)), atol=1e-4)


def test_committed_jax_pickles_load_in_the_port(data):
    """The committed encoder and generator (written by the JAX scripts)
    load in the port's ``load_artifact`` / ``load_generator``: the same
    tokenizer, embeddings and logits within 1e-4 of the JAX loaders'."""
    enc = os.path.join(ARTIFACTS, "hard_encoder.pkl")
    gen = os.path.join(ARTIFACTS, "hard_generator.pkl")
    tret, ttok = pretrain_hard_encoder.load_artifact(enc, "cpu")
    jret, jparams, jtok = jload_artifact(enc)
    assert ttok.vocab == jtok.vocab and ttok.frozen
    assert tret.cfg.tied and tret.cfg.bert.layers == 2
    ids, mask = _question_ids(jtok, data)
    with torch.no_grad():
        got = tret.embed_queries(torch.from_numpy(ids),
                                 torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jret.embed_queries(jparams, ids, mask)), atol=1e-4)
    tcfg, tgen, gtok = pretrain_copy_generator.load_generator(gen, "cpu")
    jcfg, jgen, _ = jload_generator(gen)
    assert gtok.vocab == jtok.vocab
    assert (tcfg.hidden, tcfg.layers, tcfg.heads, tcfg.kv_heads) == (
        256, 4, 8, 4)
    with torch.no_grad():
        got = tlm.lm_logits(tgen, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jlm.lm_logits(jgen, jcfg, ids, mask)), atol=1e-4)


def test_demo_modules_run_on_the_cpu(data, tmp_path):
    """The three modules end to end at a tiny size with ``--device cpu``:
    the encoder (3 InfoNCE steps), the generator (3 copy steps through the
    train loop), the joint run on their artifacts (3 rag steps, the index
    rebuilt at step 2). Every logged loss is finite and the two metric
    lines have the keys of the JAX package's record."""
    enc_path, gen_path = str(tmp_path / "enc.pkl"), str(tmp_path / "gen.pkl")
    ck = str(tmp_path / "ck")
    enc = pretrain_hard_encoder.main([
        "--data", data, "--out", enc_path, "--steps", "3", "--batch", "8",
        "--hidden", "32", *CPU])
    assert enc["steps"] == 3 and 0.0 <= enc["recall@4_unseen"] <= 1.0
    assert all(np.isfinite(v) for _, v in enc["losses"])
    gen = pretrain_copy_generator.main([
        "--data", data, "--encoder", enc_path, "--out", gen_path,
        "--checkpoint_dir", ck, "--steps", "3", "--batch", "4", *CPU])
    assert gen["steps"] == 3 and gen["losses"]
    assert all(np.isfinite(v) for _, v in gen["losses"])
    out = tmp_path / "metrics.jsonl"
    calls = []
    real = e2e_hard_copy.ShardedFlatIndex.set_embeddings

    def counted(self, *args):
        calls.append(1)
        return real(self, *args)

    e2e_hard_copy.ShardedFlatIndex.set_embeddings = counted
    try:
        joint = e2e_hard_copy.main([
            "--data", data, "--encoder", enc_path, "--generator", gen_path,
            "--out", str(out), "--checkpoint_dir", ck, "--steps", "3",
            "--refresh_index", "0-10:2", *CPU])
    finally:
        e2e_hard_copy.ShardedFlatIndex.set_embeddings = real
    # the build before the zero-shot eval, the loop's initial build and
    # the refresh at step 2: one window of 60 passages each
    assert len(calls) == 3
    assert joint["steps"] == 3 and joint["losses"]
    assert all(np.isfinite(v) for _, v in joint["losses"])
    with open(os.path.join(ARTIFACTS, "..", "metrics-e2e-hard.jsonl")) as f:
        keys = [set(json.loads(line)) for line in f]
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert [set(r) for r in lines] == keys
    assert [r["phase"] for r in lines] == ["zero_shot", "after_joint_3"]
