"""Port parity: the llama/GQA generator of ``jsa_rag_tpu_torch.models.lm``
and ``models.lora`` against ``jsa_rag_tpu.models`` on the same converted
weights and numpy inputs (JAX on the CPU).

Tolerances. At float32 both packages do the same arithmetic in another
summation order: logits and losses agree to 1e-4 (absolute and relative),
greedy tokens are identical and their log-probs agree to 1e-4. At bfloat16
the activations round at each matmul output in places that differ between
XLA and torch (SiLU, the attention product), so logits agree only to 0.05
absolute (logits of size ~1 on these weights, ~12 bf16 roundings deep);
there the port's greedy decode is held to its own cache-free forward (token
= argmax, log-prob to 2e-2) instead of to JAX's tokens, which may flip at
near-ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.models import lm as jlm
from jsa_rag_tpu.models import lora as jlora
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch.models import lm as tlm
from jsa_rag_tpu_torch.models import lora as tlora

GEOM = dict(vocab_size=97, hidden=32, layers=2, heads=4, kv_heads=2,
            intermediate=64)
TOL = 1e-4


def _pair(dtype="float32", seed=0, **kw):
    """(jax cfg, jax params, torch cfg, torch params): one numpy tree."""
    geom = {**GEOM, **kw}
    jcfg = jlm.LMConfig(dtype=getattr(jnp, dtype), **geom)
    tcfg = tlm.LMConfig(dtype=getattr(torch, dtype), **geom)
    tree = jax.tree_util.tree_map(np.asarray,
                                  jlm.lm_init(jax.random.PRNGKey(seed), jcfg))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            convert.lm_params_from_numpy(tree))


def _batch(b=3, s=12, seed=0, left=True):
    """Token ids with a padded row (left- or right-padded) and labels over
    the last 4 real tokens."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(6, GEOM["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    pad = slice(0, 4) if left else slice(s - 4, s)
    ids[0, pad], mask[0, pad] = 0, 0
    labels = np.full_like(ids, -100)
    labels[:, -4:] = ids[:, -4:]
    if not left:
        labels[0] = -100
        labels[0, 4:8] = ids[0, 4:8]
    return ids, mask, labels


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("left", [True, False])
def test_logits_and_loss_match_jax(left):
    jcfg, jp, tcfg, tp = _pair()
    ids, mask, labels = _batch(left=left)
    jl = np.asarray(jlm.lm_logits(jp, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    tl = tlm.lm_logits(tp, tcfg, _t(ids), _t(mask))
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    for temp in (1.0, 0.5):
        for norm in (True, False):
            jper, jsum = jlm.lm_loss(jp, jcfg, jnp.asarray(ids),
                                     jnp.asarray(mask), jnp.asarray(labels),
                                     length_normalized=norm, logit_temp=temp)
            tper, tsum = tlm.lm_loss(tp, tcfg, _t(ids), _t(mask),
                                     _t(labels), length_normalized=norm,
                                     logit_temp=temp)
            np.testing.assert_allclose(tper.numpy(), np.asarray(jper),
                                       rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum),
                                       rtol=TOL, atol=TOL)
    jlp = jlm.lm_sequence_logprob(jp, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask), jnp.asarray(labels))
    tlp = tlm.lm_sequence_logprob(tp, tcfg, _t(ids), _t(mask), _t(labels))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=TOL,
                               atol=TOL)


def test_rms_norm_rope_positions_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32) * 3
    scale = rng.standard_normal((8,)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        jx = jnp.asarray(x, getattr(jnp, dt))
        tx = _t(x).to(getattr(torch, dt))
        jn = jlm._rms_norm(jx, jnp.asarray(scale), 1e-5)
        tn = tlm._rms_norm(tx, _t(scale), 1e-5)
        assert tn.dtype == tx.dtype  # f32 inside, cast back
        np.testing.assert_allclose(tn.float().numpy(),
                                   np.asarray(jn.astype(jnp.float32)),
                                   rtol=1e-2 if dt == "bfloat16" else 1e-6,
                                   atol=1e-6)
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 0]], np.int32)
    jpos = jlm.positions_from_mask(jnp.asarray(mask))
    tpos = tlm.positions_from_mask(_t(mask))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    jr = jlm._rope(jnp.asarray(x), jpos, 10000.0)
    tr = tlm._rope(_t(x), tpos, 10000.0)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5)


CASES = {
    "eos": dict(eos_id=7),
    "min_new_tokens": dict(eos_id=7, min_new_tokens=3),
    "no_eos": dict(eos_id=-1, min_new_tokens=2),
    "forced_prefix": dict(eos_id=7, forced=True),
}


def _eos_heavy(tree):
    """Bias the head toward token 7 on some rows so EOS really fires and
    rows finish at different steps."""
    tree = dict(tree)
    head = np.array(tree["lm_head"])
    head[:, 7] += 0.35 * np.sign(head[:, 7])
    tree["lm_head"] = head
    return tree


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generate_matches_jax(case):
    kw = dict(CASES[case])
    forced = kw.pop("forced", False)
    jcfg, jp, tcfg, tp = _pair(seed=3)
    tree = _eos_heavy(convert.lm_params_to_numpy(tp))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = convert.lm_params_from_numpy(tree)
    ids, mask, _ = _batch(b=4, s=10, seed=2)
    if forced:
        prefix = np.array([[11, 12, 13], [14, 15, 0], [16, 0, 0],
                           [0, 0, 0]], np.int32)
        lens = np.array([3, 2, 1, 0], np.int32)
        kw.update(forced_prefix=prefix, forced_len=lens)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    jt, jl = jlm.greedy_generate(jp, jcfg, jnp.asarray(ids),
                                 jnp.asarray(mask), max_new_tokens=8,
                                 pad_id=0, return_logprobs=True, **jkw)
    tt, tl = tlm.greedy_generate(tp, tcfg, _t(ids), _t(mask),
                                 max_new_tokens=8, pad_id=0,
                                 return_logprobs=True, **tkw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    toks = tt.numpy()
    if kw.get("eos_id", -1) >= 0:
        for row in toks:  # pad after EOS, and EOS banned before min_new
            hits = np.nonzero(row == 7)[0]
            if len(hits):
                assert (row[hits[0] + 1:] == 0).all()
                assert hits[0] >= kw.get("min_new_tokens", 0)
    if case == "eos":
        assert (toks == 7).any() and (toks == 0).any()
    if forced:
        assert toks[0, :3].tolist() == [11, 12, 13]
        assert toks[1, :2].tolist() == [14, 15]
    # the early exit leaves what a full-length loop leaves: a longer
    # budget reproduces the first 8 tokens
    longer = tlm.greedy_generate(tp, tcfg, _t(ids), _t(mask),
                                 max_new_tokens=11, pad_id=0, **tkw)
    np.testing.assert_array_equal(longer[:, :8].numpy(), toks)


def test_bf16_logits_and_greedy():
    jcfg, jp, tcfg, tp = _pair("bfloat16", seed=5)
    ids, mask, _ = _batch(b=3, s=10, seed=6)
    jl = np.asarray(jlm.lm_logits(jp, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    tl = tlm.lm_logits(tp, tcfg, _t(ids), _t(mask))
    live = mask.astype(bool)
    np.testing.assert_allclose(tl.numpy()[live], jl[live], rtol=0,
                               atol=0.05)
    toks, lps = tlm.greedy_generate(tp, tcfg, _t(ids), _t(mask),
                                    max_new_tokens=5, eos_id=-1, pad_id=0,
                                    return_logprobs=True)
    full_ids = torch.cat([_t(ids).long(), toks], dim=1)
    full_mask = torch.cat([_t(mask), torch.ones_like(toks)], dim=1).int()
    ref = torch.log_softmax(tlm.lm_logits(tp, tcfg, full_ids, full_mask),
                            dim=-1)[:, ids.shape[1] - 1:-1]
    for t in range(5):
        top = ref[:, t].max(dim=-1).values
        mine = ref[:, t].gather(1, toks[:, t:t + 1])[:, 0]
        # the token is the argmax, or ties it within the bf16 tolerance
        assert (top - mine <= 2e-2).all()
        np.testing.assert_allclose(lps[:, t].numpy(), mine.numpy(),
                                   atol=2e-2, rtol=0)


def test_lora_apply_matches_jax():
    """``lora_apply`` = W + (alpha/rank) A@B at the targeted leaves, the
    rest untouched; the merged generator gives the JAX logits."""
    jcfg, jp, tcfg, tp = _pair()
    lcfg = jlora.LoRAConfig(rank=4, alpha=8.0)
    jl = jlora.lora_init(jax.random.PRNGKey(9), jp, lcfg)
    rng = np.random.default_rng(9)
    jl = jax.tree_util.tree_map(  # a trained adapter: B != 0
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), jl)
    tl = convert.lora_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jl))
    tcfg_l = tlora.LoRAConfig(rank=4, alpha=8.0)
    jm = jax.tree_util.tree_map(np.asarray,
                                jlora.lora_apply(jp, jl, lcfg))
    tm = tlora.lora_apply(tp, tl, tcfg_l)
    for got, want in zip(
            jax.tree_util.tree_leaves(convert.lm_params_to_numpy(tm)),
            jax.tree_util.tree_leaves(jm)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # untouched leaves are the base's storage, detached (not copied)
    assert (tm["layers"][0]["attn_norm"].data_ptr()
            == tp["layers"][0]["attn_norm"].data_ptr())
    ids, mask, _ = _batch()
    merged = tlora.gen_params({"generator": tp, "lora": tl}, tcfg_l)
    np.testing.assert_allclose(
        tlm.lm_logits(merged, tcfg, _t(ids), _t(mask)).numpy(),
        np.asarray(jlm.lm_logits(jax.tree_util.tree_map(jnp.asarray, jm),
                                 jcfg, jnp.asarray(ids), jnp.asarray(mask))),
        rtol=TOL, atol=TOL)
    # B = 0 at init: the adapter is the identity, and without a config the
    # base weights are used as they are
    fresh = tlora.lora_init(tp, tcfg_l, generator=torch.Generator(),
                            device="cpu")
    assert set(fresh["layers"][0]) == set(tlm.MATMUL_WEIGHTS)
    same = tlora.lora_apply(tp, fresh, tcfg_l)
    assert torch.equal(same["layers"][1]["down_w"], tp["layers"][1]["down_w"])
    assert tlora.gen_params({"generator": tp, "lora": tl}, None) is tp


def test_convert_round_trip_and_unported():
    _, jp, tcfg, tp = _pair()
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = convert.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # the gpt2 architecture is ported: its init has the JAX tree's leaves
    # and shapes; beam decoding returns (B, max_new_tokens) ids
    gcfg = dict(GEOM, kv_heads=GEOM["heads"])
    jg = jlm.lm_init(jax.random.PRNGKey(0),
                     jlm.LMConfig(arch="gpt2", **gcfg))
    tg = tlm.lm_init(tlm.LMConfig(arch="gpt2", **gcfg), device="cpu",
                     generator=torch.Generator())
    assert jax.tree_util.tree_structure(jg) == \
        jax.tree_util.tree_structure(tg)
    for a, b in zip(jax.tree_util.tree_leaves(jg),
                    jax.tree_util.tree_leaves(tg)):
        assert tuple(a.shape) == tuple(b.shape)
    ids, mask, _ = _batch()
    out = tlm.beam_generate(tp, tcfg, _t(ids), _t(mask), max_new_tokens=3,
                            eos_id=7, pad_id=0, num_beams=2)
    assert out.shape == (ids.shape[0], 3) and out.dtype == torch.long


def test_decode_drift_tool_holds_the_cache_at_f32():
    """analysis/decode_drift.py at a narrow width: the f32 cached decode
    equals its cache-free forward within 1e-4 nats, and every gap is
    finite."""
    from jsa_rag_tpu_torch.analysis.decode_drift import drift

    r = drift(2, torch.device("cpu"), hidden=64, heads=4, kv_heads=2,
              intermediate=128, vocab_size=1000)
    assert r["cached_f32"]["gap_to_free_f32"] < 1e-4
    for run in ("cached_bf16", "cached_f32"):
        assert all(np.isfinite(v) for k, v in r[run].items()
                   if k.startswith(("gap", "free")))

