"""Port parity: beam search (``jsa_rag_tpu_torch.models.lm.beam_generate``)
against the JAX package's ``beam_generate`` on the same numpy weights and
prompts, against transformers' ``generate(num_beams=4)`` where that package
is installed, and through ``RAGModel.generate`` / ``method_generate`` and
``evaluate`` against the JAX package's.

Tolerances. Both packages run the same f32 arithmetic in another summation
order, so the beams' tokens are equal (selections take ``lax.top_k``'s
order of ties in both) and their captured log-probs agree to 1e-5. End to
end, the outputs compared are ids, decoded answers and averages of them,
so they are equal; the eval loss agrees to 1e-4 relative, as in
``tests/test_torch_eval.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu.models import lm as jlm
from jsa_rag_tpu_torch import convert
from jsa_rag_tpu_torch.models import lm as tlm

LOGP_TOL = 1e-5
EOS = 7
LLAMA = dict(vocab_size=97, hidden=32, layers=2, heads=4, kv_heads=2,
             intermediate=64)
GPT2 = dict(vocab_size=97, hidden=32, layers=2, heads=4, kv_heads=4,
            intermediate=64, arch="gpt2", max_positions=24)
# the JAX package's own beam cases (tests/test_lm.py: length_penalty,
# min_new_tokens)
BEAM_CASES = [(1.1, 0), (1.1, 3), (0.0, 0), (2.0, 2)]


def _pair(geom, seed=0):
    """(jax cfg, jax params, torch cfg, torch params) from one numpy tree,
    its head biased toward EOS so hypotheses finish at different steps."""
    jcfg = jlm.LMConfig(dtype=jnp.float32, **geom)
    tcfg = tlm.LMConfig(dtype=torch.float32, **geom)
    tree = jax.tree_util.tree_map(
        np.array, jlm.lm_init(jax.random.PRNGKey(seed), jcfg))
    if geom.get("arch") == "gpt2":
        tree["embed"][EOS] += 0.3 * np.sign(tree["embed"][EOS])
    else:
        tree["lm_head"][:, EOS] += 0.3 * np.sign(tree["lm_head"][:, EOS])
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg,
            convert.lm_params_from_numpy(tree))


def _prompts(b=3, plen=8, seed=11, vocab=97):
    """Left-padded prompts of ragged lengths."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((b, plen), np.int32)
    mask = np.zeros((b, plen), np.int32)
    for i, ln in enumerate([plen, 5, 3, 6, 2][:b]):
        ids[i, plen - ln:] = rng.integers(8, vocab, ln)
        mask[i, plen - ln:] = 1
    return ids, mask


def _both(geom, ids, mask, seed=0, **kw):
    jcfg, jp, tcfg, tp = _pair(geom, seed)
    jt, jl = jlm.beam_generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                               return_logprobs=True, **kw)
    tt, tl = tlm.beam_generate(tp, tcfg, torch.from_numpy(ids),
                               torch.from_numpy(mask), return_logprobs=True,
                               **kw)
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tl.numpy())


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
@pytest.mark.parametrize("length_penalty,min_new_tokens", BEAM_CASES)
def test_beam_generate_matches_jax(arch, length_penalty, min_new_tokens):
    ids, mask = _prompts()
    (jt, jl), (tt, tl) = _both(
        LLAMA if arch == "llama" else GPT2, ids, mask, max_new_tokens=10,
        eos_id=EOS, pad_id=0, num_beams=4, length_penalty=length_penalty,
        min_new_tokens=min_new_tokens)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOGP_TOL)
    assert (tt == EOS).any()  # some hypotheses ended on EOS
    if min_new_tokens:
        assert (tt[:, :min_new_tokens] != EOS).all()


@pytest.mark.parametrize("arch", ["llama", "gpt2"])
def test_beam_forced_prefix_matches_jax(arch):
    """A forced decoder prefix (tests/test_lm.py::test_beam_forced_prefix):
    the prefix appears verbatim, then free decoding; -inf runs of banned
    tokens tie in every selection."""
    ids, mask = _prompts(b=2, plen=5, seed=0)
    prefix = np.array([[20, 21, 22], [30, 31, 0]], np.int32)
    plen = np.array([3, 2], np.int32)
    kw = dict(max_new_tokens=6, eos_id=EOS, pad_id=0, num_beams=2,
              length_penalty=1.1)
    jcfg, jp, tcfg, tp = _pair(LLAMA if arch == "llama" else GPT2, seed=3)
    jt, jl = jlm.beam_generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                               forced_prefix=jnp.asarray(prefix),
                               forced_len=jnp.asarray(plen),
                               return_logprobs=True, **kw)
    tt, tl = tlm.beam_generate(tp, tcfg, torch.from_numpy(ids),
                               torch.from_numpy(mask),
                               forced_prefix=torch.from_numpy(prefix),
                               forced_len=torch.from_numpy(plen),
                               return_logprobs=True, **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGP_TOL)
    assert list(tt[0, :3]) == [20, 21, 22] and list(tt[1, :2]) == [30, 31]


def test_beam_early_exit_budget_invariance():
    """The early exit (every row's early-stop heuristic satisfied) does not
    change the hypotheses: a larger budget returns the smaller budget's
    best beams plus pad columns when every row finished within it
    (tests/test_lm.py::test_beam_early_exit_budget_invariance); the
    search's step count is the JAX loop's, below the budget."""
    ids, mask = _prompts(b=2, plen=5, seed=12)
    jcfg, jp, tcfg, tp = _pair(LLAMA, seed=1)
    kw = dict(eos_id=EOS, pad_id=0, num_beams=3, length_penalty=1.0)
    small = tlm.beam_generate(tp, tcfg, torch.from_numpy(ids),
                              torch.from_numpy(mask), max_new_tokens=10,
                              **kw).numpy()
    assert (small == EOS).any(axis=1).all()
    for budget in (24, 48):
        big = tlm.beam_generate(tp, tcfg, torch.from_numpy(ids),
                                torch.from_numpy(mask),
                                max_new_tokens=budget, **kw).numpy()
        np.testing.assert_array_equal(big[:, :10], small)
        assert (big[:, 10:] == 0).all()
        jbig = np.asarray(jlm.beam_generate(
            jp, jcfg, jnp.asarray(ids), jnp.asarray(mask),
            max_new_tokens=budget, **kw))
        np.testing.assert_array_equal(big, jbig)
    p = tlm._cast_params(tp, tcfg)
    out = tlm._beam_search(p, tcfg, torch.from_numpy(ids),
                           torch.from_numpy(mask), max_new_tokens=48,
                           num_beams=3, length_penalty=1.0,
                           min_new_tokens=0, forced_prefix=None,
                           forced_len=None, eos_id=EOS, pad_id=0)
    assert 0 < int(out.steps) < 48
    np.testing.assert_array_equal(out.ids.numpy()[:, :10], small)


@pytest.mark.parametrize("every", [1, 3, 8])
def test_beam_exit_check_interval_leaves_the_result(monkeypatch, every):
    """How often the host reads the early-exit flag changes no id, log-prob
    or score: the steps after the exit leave the finished sets frozen."""
    ids, mask = _prompts(b=2, plen=5, seed=12)
    _, _, tcfg, tp = _pair(LLAMA, seed=1)
    p = tlm._cast_params(tp, tcfg)
    kw = dict(max_new_tokens=40, num_beams=3, length_penalty=1.3,
              min_new_tokens=0, forced_prefix=None, forced_len=None,
              eos_id=EOS, pad_id=0)
    monkeypatch.setattr(tlm, "EXIT_CHECK_EVERY", 10 ** 6)
    want = tlm._beam_search(p, tcfg, torch.from_numpy(ids),
                            torch.from_numpy(mask), **kw)
    monkeypatch.setattr(tlm, "EXIT_CHECK_EVERY", every)
    got = tlm._beam_search(p, tcfg, torch.from_numpy(ids),
                           torch.from_numpy(mask), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_top_k_lax_orders_ties_like_jax():
    """Ties (the -1e9 mask plus a log-prob, -inf runs, equal scores across
    the k-th place, signed zeros) in ``lax.top_k``'s order."""
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    x[0, ::3] = -np.inf
    x[1] = -1e9 + rng.standard_normal(40).astype(np.float32)
    x[2, :] = 0.0
    x[2, ::2] = -0.0
    x[3, 5:] = np.inf
    for k in (1, 4, 13, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tlm.top_k_lax(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_beam_logprobs_match_a_cache_free_forward():
    """Each best hypothesis's captured log-probs equal a cache-free
    ``lm_logits`` over prompt + hypothesis up to its EOS (1e-5), and its
    kept score is their sum over (length) ** length_penalty."""
    ids, mask = _prompts()
    _, _, tcfg, tp = _pair(LLAMA)
    p = tlm._cast_params(tp, tcfg)
    out = tlm._beam_search(p, tcfg, torch.from_numpy(ids),
                           torch.from_numpy(mask), max_new_tokens=10,
                           num_beams=4, length_penalty=1.1, min_new_tokens=0,
                           forced_prefix=None, forced_len=None, eos_id=EOS,
                           pad_id=0)
    toks = out.ids
    full = torch.cat([torch.from_numpy(ids).long(), toks], 1)
    fmask = torch.cat([torch.from_numpy(mask).long(),
                       torch.ones_like(toks)], 1)
    logp = torch.log_softmax(tlm.lm_logits(tp, tcfg, full, fmask), -1)
    plen = ids.shape[1]
    for r in range(ids.shape[0]):
        n = toks.shape[1]
        if (toks[r] == EOS).any():
            n = int(torch.nonzero(toks[r] == EOS)[0]) + 1
        want = logp[r, plen - 1:plen - 1 + n].gather(
            1, toks[r, :n, None])[:, 0]
        np.testing.assert_allclose(out.logprobs[r, :n].numpy(),
                                   want.numpy(), rtol=0, atol=LOGP_TOL)
        assert (out.logprobs[r, n:] == 0).all()
        np.testing.assert_allclose(float(out.scores[r]),
                                   float(want.sum()) / n ** 1.1, rtol=1e-5)


# ---------------------------------------------------------- transformers
def test_beam_matches_transformers_mistral():
    """``MistralForCausalLM.generate(num_beams=4, length_penalty,
    min_new_tokens, early_stopping=False)``: the same tokens
    (tests/test_lm.py::test_beam_generate_matches_hf)."""
    pytest.importorskip("transformers")
    from transformers import MistralConfig, MistralForCausalLM

    from jsa_rag_tpu_torch.models.hf_import import (import_causal_lm,
                                                    lm_config_from_hf)

    hf_cfg = MistralConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, pad_token_id=0, eos_token_id=1,
        bos_token_id=2)
    torch.manual_seed(5)
    hf = MistralForCausalLM(hf_cfg).eval()
    cfg = lm_config_from_hf(hf_cfg.to_dict(), dtype=torch.float32)
    params = import_causal_lm(hf.state_dict(), cfg.layers)
    _hf_parity(hf, cfg, params, vocab=64, plen=8)


def test_beam_matches_transformers_gpt2():
    """``GPT2LMHeadModel.generate(num_beams=4, ...)``: the same tokens."""
    pytest.importorskip("transformers")
    from transformers import GPT2Config, GPT2LMHeadModel

    from jsa_rag_tpu_torch.models.hf_import import (gpt2_config_from_hf,
                                                    import_gpt2)

    hf_cfg = GPT2Config(vocab_size=64, n_embd=32, n_layer=2, n_head=4,
                        n_positions=64, eos_token_id=1, bos_token_id=2,
                        pad_token_id=0)
    torch.manual_seed(2)
    hf = GPT2LMHeadModel(hf_cfg).eval()
    cfg = gpt2_config_from_hf(hf_cfg.to_dict(), dtype=torch.float32)
    params = import_gpt2(hf.state_dict(), cfg.layers)
    _hf_parity(hf, cfg, params, vocab=64, plen=8)


def _hf_parity(hf, cfg, params, vocab, plen):
    rng = np.random.default_rng(11)
    b, new = 3, 8
    ids = np.zeros((b, plen), np.int64)
    mask = np.zeros((b, plen), np.int64)
    for i, ln in enumerate([8, 5, 3]):
        ids[i, plen - ln:] = rng.integers(3, vocab, ln)
        mask[i, plen - ln:] = 1
    params = convert.lm_params_from_numpy(params)
    for lp, minnew in BEAM_CASES:
        with torch.no_grad():
            want = hf.generate(
                input_ids=torch.tensor(ids),
                attention_mask=torch.tensor(mask), max_new_tokens=new,
                min_new_tokens=minnew or None, do_sample=False, num_beams=4,
                length_penalty=lp, early_stopping=False, pad_token_id=0,
                eos_token_id=1)[:, plen:].numpy()
        got = tlm.beam_generate(
            params, cfg, torch.from_numpy(ids), torch.from_numpy(mask),
            max_new_tokens=new, eos_id=1, pad_id=0, num_beams=4,
            length_penalty=lp, min_new_tokens=minnew).numpy()
        # equal up to each row's EOS; after it the port pads with pad_id
        # and transformers with pad_id or (some versions) eos_id
        for r in range(b):
            n = want.shape[1]
            if (want[r] == 1).any():
                n = int(np.argmax(want[r] == 1)) + 1
            np.testing.assert_array_equal(
                got[r, :n], want[r, :n],
                err_msg=f"length_penalty={lp} min_new_tokens={minnew}")
            assert (got[r, n:] == 0).all()
            assert np.isin(want[r, n:], (0, 1)).all()


# ------------------------------------------------------ RAGModel, evaluate
QUERIES = ["value of e3", "value of e17"]
PASSAGES = [[{"id": str(i), "title": f"e{i}", "text": f"e{i} has value v{i}"}
             for i in (3, 4, 5)],
            [{"id": str(i), "title": f"e{i}", "text": f"e{i} has value v{i}"}
             for i in (17, 1, 9)]]


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A tiny checkpoint the JAX trainer's ``save_checkpoint`` wrote (a
    non-zero LoRA adapter, grown tokenizer vocabs), its corpus and dev
    file, and the flags both packages evaluate it with."""
    from jsa_rag_tpu import config as jconfig
    from jsa_rag_tpu.data.passages import PassageStore as JStore
    from jsa_rag_tpu.model_io import load_or_initialize_model
    from jsa_rag_tpu.train.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("beam_ckpt")
    passages = [{"id": str(i), "title": f"e{i}",
                 "text": f"e{i} has value v{i}"} for i in range(24)]
    (d / "passages.jsonl").write_text(
        "".join(json.dumps(p) + "\n" for p in passages))
    (d / "dev.jsonl").write_text("".join(
        json.dumps({"question": f"value of e{i}", "answers": [f"v{i}"]})
        + "\n" for i in range(5)))
    argv = ["--model_size", "tiny", "--precision", "fp32", "--task", "qa",
            "--n_context", "3", "--text_maxlength", "96",
            "--target_maxlength", "8", "--generation_max_length", "6",
            "--per_gpu_batch_size", "3", "--max_vocab", "600",
            "--index_dtype", "float32", "--lora_rank", "4",
            "--passages", str(d / "passages.jsonl"),
            "--checkpoint_dir", str(d / "out"), "--write_results", "true"]
    jopt = jconfig.Options.from_args(argv + ["--name", "init"])
    model, params, _ = load_or_initialize_model(
        jopt, JStore(passages=passages))
    rng = np.random.default_rng(0)
    params["lora"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                              jnp.float32), params["lora"])
    for p in passages:
        model.retriever_tokenizer.tokenize(f"{p['title']} {p['text']}")
    save_checkpoint(str(d / "ckpt"), "run", 7, params, options=jopt,
                    tokenizer=model.generator_tokenizer,
                    retriever_tokenizer=model.retriever_tokenizer)
    argv += ["--model_path", str(d / "ckpt" / "run")]
    return d, argv, passages


BEAM_FLAGS = ["--generation_num_beams", "4", "--generation_length_penalty",
              "1.1"]


@pytest.mark.parametrize("extra", [
    [], ["--decoder_prompt_format", "answer: {query}",
         "--generation_min_length", "2", "--generation_max_length", "9"]])
def test_rag_generate_with_beams_matches_jax(jax_ckpt, extra):
    """``RAGModel.generate`` with ``generation_num_beams=4`` and
    ``method_generate`` (fast_deocde1) on the restored checkpoint: the JAX
    package's ids, the log-probs to 1e-5, the same best answer per query
    (with a forced decoder prefix and a minimum length in the second
    case)."""
    from jsa_rag_tpu import config as jconfig
    from jsa_rag_tpu import model_io as jmodel_io
    from jsa_rag_tpu.data.passages import PassageStore as JStore
    from jsa_rag_tpu_torch import config as tconfig
    from jsa_rag_tpu_torch import model_io as tmodel_io
    from jsa_rag_tpu_torch.data.passages import PassageStore as TStore

    _, argv, passages = jax_ckpt
    argv = argv + BEAM_FLAGS + extra
    jm, jp, _ = jmodel_io.load_or_initialize_model(
        jconfig.Options.from_args(argv), JStore(passages=passages))
    tm, tp, _ = tmodel_io.load_or_initialize_model(
        tconfig.Options.from_args(argv + ["--device", "cpu"]),
        TStore(passages=passages))
    jids, jlps = jm.generate(jp, QUERIES, PASSAGES, return_logprobs=True)
    tids, tlps = tm.generate(tp, QUERIES, PASSAGES, return_logprobs=True)
    assert tids.shape == (len(QUERIES) * 3, jm.opt.generation_max_length)
    np.testing.assert_array_equal(tids, np.asarray(jids))
    np.testing.assert_allclose(tlps, np.asarray(jlps), rtol=0, atol=LOGP_TOL)
    ret = np.array([[0.3, 0.1, -0.2], [0.0, 0.5, 0.4]], np.float32)
    jbest, jall = jm.method_generate(jp, QUERIES, PASSAGES, ret)
    tbest, tall = tm.method_generate(tp, QUERIES, PASSAGES, ret)
    np.testing.assert_array_equal(tbest, np.asarray(jbest))
    np.testing.assert_array_equal(tall, np.asarray(jall))


def test_evaluate_with_beams_matches_jax(jax_ckpt):
    """``python -m jsa_rag_tpu_torch.evaluate``'s ``main`` with
    ``--generation_num_beams 4 --generation_length_penalty 1.1`` on the
    JAX-written checkpoint against the JAX package's ``evaluate``
    (tests/test_evaluation.py::test_evaluate_with_beam_search): the same
    metrics, retrieved passages and answers."""
    from jsa_rag_tpu import config as jconfig
    from jsa_rag_tpu import model_io as jmodel_io
    from jsa_rag_tpu.data.passages import PassageStore as JStore
    from jsa_rag_tpu.evaluation import evaluate as jevaluate
    from jsa_rag_tpu.index.flat import ShardedFlatIndex as JaxIndex
    from jsa_rag_tpu.parallel.mesh import make_mesh
    from jsa_rag_tpu_torch.evaluate import main as tmain

    d, argv, passages = jax_ckpt
    argv = argv + BEAM_FLAGS + ["--eval_data", str(d / "dev.jsonl")]
    jopt = jconfig.Options.from_args(argv + ["--name", "jax-beam"])
    jm, jp, _ = jmodel_io.load_or_initialize_model(
        jopt, JStore(passages=passages))
    mesh = make_mesh(n_data=1, n_index=1, devices=jax.devices()[:1])
    index = JaxIndex(mesh, len(passages), jm.retriever.cfg.bert.hidden,
                     dtype=jnp.float32)
    jm.build_index(index, jp)
    jmet = jevaluate(jm, index, jp, jopt, str(d / "dev.jsonl"))
    tmet = tmain(argv + ["--name", "torch-beam", "--device",
                         "cpu"])["dev.jsonl"]
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-4, err_msg=k)
        if k != "eval_loss":
            assert tmet[k] == jmet[k], k

    def rows(name):
        with open(d / "out" / name / "dev.jsonl.jsonl") as f:
            return [(r["generation"], [p["id"] for p in r["passages"]])
                    for r in map(json.loads, f)]
    assert rows("torch-beam") == rows("jax-beam")
    assert len(rows("torch-beam")) == 5
