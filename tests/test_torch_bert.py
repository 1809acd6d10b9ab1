"""Port parity: the BERT dual-encoder retriever of ``jsa_rag_tpu_torch``
against the JAX package's, on the same numpy weights carried by
``jsa_rag_tpu_torch.convert``, for all five poolings and tied and untied
towers.

Tolerance: f32 atol 1e-5 (and rtol 1e-5) — the same f32 arithmetic with
matmul sums taken in another order by XLA and torch, through 2 layers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.models.bert import BertConfig as JaxBertConfig
from jsa_rag_tpu.models.retriever import (DualEncoderRetriever as JaxRetriever,
                                          RetrieverConfig as JaxRetrieverConfig,
                                          l2_normalize as jax_l2_normalize)
from jsa_rag_tpu_torch.convert import (retriever_params_from_numpy,
                                       retriever_params_to_numpy)
from jsa_rag_tpu_torch.models import (BertConfig, DualEncoderRetriever,
                                      RetrieverConfig, l2_normalize)

GEOM = dict(vocab_size=97, hidden=64, layers=2, heads=4, intermediate=128,
            max_positions=16)
ATOL = RTOL = 1e-5


def _pair(pooling, tied, seed=0):
    """A JAX retriever with random numpy weights (every leaf random, so
    biases and LayerNorm parameters count too) and the port's retriever
    loaded from the same numpy tree."""
    jr = JaxRetriever(JaxRetrieverConfig(
        bert=JaxBertConfig(pooling=pooling, **GEOM), tied=tied))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda x: (rng.normal(0.0, 0.05, x.shape)
                   + (1.0 if x.ndim == 1 else 0.0)).astype(np.float32),
        jr.init(jax.random.PRNGKey(seed)))
    tr = DualEncoderRetriever(RetrieverConfig(
        bert=BertConfig(pooling=pooling, **GEOM), tied=tied), device="cpu")
    tr.load_state_dict(retriever_params_from_numpy(tree))
    return jr, tree, tr.eval()


def _inputs(b, s, seed=1, lengths=None):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, GEOM["vocab_size"] + 20, (b, s)).astype(np.int32)
    lengths = lengths or [s] * b
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    return ids, mask


def _both(jr, tree, tr, ids, mask, is_passages):
    jfn = jr.embed_passages if is_passages else jr.embed_queries
    tfn = tr.embed_passages if is_passages else tr.embed_queries
    want = np.asarray(jfn(tree, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tfn(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    return got, want


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("pooling",
                         ["cls", "cls_norm", "mean", "mean_norm", "sqrt"])
def test_retriever_matches_jax(pooling, tied):
    """Both towers, a padded batch (ids past the vocabulary clip like
    ``jnp.take(mode="clip")``)."""
    jr, tree, tr = _pair(pooling, tied)
    ids, mask = _inputs(4, 12, lengths=[12, 7, 1, 5])
    for is_passages in (False, True):
        got, want = _both(jr, tree, tr, ids, mask, is_passages)
        assert got.shape == (4, GEOM["hidden"])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not tied:  # untied towers really differ
        q, _ = _both(jr, tree, tr, ids, mask, False)
        p, _ = _both(jr, tree, tr, ids, mask, True)
        assert np.abs(q - p).max() > 1e-3


def test_padding_mask_and_max_positions():
    """Pad tokens do not change the embedding; a sequence at
    ``max_positions`` and one past it (positions clip) match JAX."""
    jr, tree, tr = _pair("mean", False, seed=3)
    ids, mask = _inputs(3, 10, seed=4, lengths=[10, 6, 3])
    other = ids.copy()
    other[mask == 0] = 5  # different pad ids under the same mask
    a, _ = _both(jr, tree, tr, ids, mask, True)
    b, _ = _both(jr, tree, tr, other, mask, True)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    for s in (GEOM["max_positions"], GEOM["max_positions"] + 4):
        ids, mask = _inputs(2, s, seed=s)
        for is_passages in (False, True):
            got, want = _both(jr, tree, tr, ids, mask, is_passages)
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_convert_roundtrip_keeps_names_and_layout():
    jr, tree, tr = _pair("cls_norm", False, seed=5)
    back = retriever_params_to_numpy(tr)
    assert set(back) == {"query", "passage"}
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert back["query"]["layers"][0]["ffn_in_w"].shape == (64, 128)  # (in, out)
    with pytest.raises(ValueError):
        retriever_params_from_numpy({"prior": tree["query"]})


def test_seeded_init_is_deterministic():
    cfg = RetrieverConfig(bert=BertConfig(pooling="cls", **GEOM))

    def make(seed):
        g = torch.Generator().manual_seed(seed)
        return DualEncoderRetriever(cfg, device="cpu", generator=g)

    a, b, c = make(7).state_dict(), make(7).state_dict(), make(8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query.layers.0.q_w"], c["query.layers.0.q_w"])
    assert not torch.equal(a["query.layers.0.q_w"], a["passage.layers.0.q_w"])
    assert float(a["query.embed.word"].std()) == pytest.approx(0.02, rel=0.1)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(2).standard_normal((5, 7)).astype(np.float32)
    x[1] = 0.0
    np.testing.assert_allclose(
        l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jax_l2_normalize(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
