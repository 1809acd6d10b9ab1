"""Port parity: HF checkpoint directories read by
``jsa_rag_tpu_torch.models.hf_import`` (no ``transformers`` or
``safetensors`` at run time) against the JAX package's ``hf_import`` over
the live ``transformers`` model, and ``load_or_initialize_model`` from HF
directories in both packages; the gpt2 generator against the JAX package's;
the vocabulary guard.

Tiny ``BertModel``, ``MistralForCausalLM`` and ``GPT2LMHeadModel`` models
are built here with weights from a numpy seed and saved with
``save_pretrained``; nothing is downloaded.

Tolerances. Imported leaves and configs are equal (bit for bit, field for
field). Through the models, both packages compute in float32 in another
summation order: BERT embeddings to 1e-5, LM logits and losses to 1e-4 and
LoRA gradients to 1e-4 relative plus 1e-6 absolute (the existing
port-vs-JAX bounds); greedy token ids are equal and their log-probs agree
to 1e-4."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import chip_smoke  # noqa: E402
from jsa_rag_tpu import config as jconfig  # noqa: E402
from jsa_rag_tpu import model_io as jmodel_io  # noqa: E402
from jsa_rag_tpu.data.passages import PassageStore as JStore  # noqa: E402
from jsa_rag_tpu.models import hf_import as jhf  # noqa: E402
from jsa_rag_tpu.models import lm as jlm  # noqa: E402
from jsa_rag_tpu.models import lora as jlora  # noqa: E402
from jsa_rag_tpu_torch import config as tconfig  # noqa: E402
from jsa_rag_tpu_torch import convert  # noqa: E402
from jsa_rag_tpu_torch import model_io as tmodel_io  # noqa: E402
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore  # noqa
from jsa_rag_tpu_torch.models import hf_import as thf  # noqa: E402
from jsa_rag_tpu_torch.models import lm as tlm  # noqa: E402
from jsa_rag_tpu_torch.models import lora as tlora  # noqa: E402

ARCHS = ("bert", "mistral", "gpt2")
SAVES = ("safetensors", "bin", "sharded")


def hf_model(arch: str, seed: int = 0):
    """A tiny HF model whose every parameter comes from a numpy seed (norm
    scales around 1, the rest around 0)."""
    if arch == "bert":
        model = transformers.BertModel(transformers.BertConfig(
            vocab_size=120, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, type_vocab_size=2))
    elif arch == "mistral":
        model = transformers.MistralForCausalLM(transformers.MistralConfig(
            vocab_size=97, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0, rms_norm_eps=1e-5,
            tie_word_embeddings=False))
    else:
        model = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=97, n_embd=32, n_layer=2, n_head=4, n_positions=64))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = ("norm" in name.lower() or ".ln_" in name
                     or name.startswith(("ln_", "transformer.ln_")))
            base = 1.0 if scale and name.endswith("weight") else 0.0
            p.copy_(torch.from_numpy(
                (base + 0.05 * rng.standard_normal(p.shape))
                .astype(np.float32)))
    return model.eval()


def save(model, path, how: str) -> str:
    kw = {"safetensors": dict(safe_serialization=True),
          "bin": dict(safe_serialization=False),
          "sharded": dict(safe_serialization=True,
                          max_shard_size="20KB")}[how]
    model.save_pretrained(str(path), **kw)
    return str(path)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _import_both(arch, model, path):
    n = model.config.num_hidden_layers if arch != "gpt2" else \
        model.config.n_layer
    sd = thf.read_state_dict(path)
    if arch == "bert":
        return (jhf.import_bert(model.state_dict(), n),
                thf.import_bert(sd, n))
    if arch == "mistral":
        return (jhf.import_causal_lm(model.state_dict(), n),
                thf.import_causal_lm(sd, n))
    return jhf.import_gpt2(model.state_dict(), n), thf.import_gpt2(sd, n)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    dtype = d.pop("dtype")
    return d, str(jnp.dtype(dtype) if not isinstance(dtype, torch.dtype)
                  else dtype).removeprefix("torch.")


@pytest.mark.parametrize("how", SAVES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reader_and_import_match_jax(tmp_path, arch, how):
    """The port's reader + ``import_*`` over each save format give the JAX
    package's ``import_*`` of ``hf.state_dict()`` leaf for leaf, bit for
    bit, and field-equal configs."""
    model = hf_model(arch)
    path = save(model, tmp_path / arch, how)
    files = os.listdir(path)
    if how == "sharded":
        assert "model.safetensors.index.json" in files
    elif how == "bin":
        assert "pytorch_model.bin" in files
    jtree, ttree = _import_both(arch, model, path)
    assert jax.tree_util.tree_structure(jtree) == \
        jax.tree_util.tree_structure(ttree)
    for a, b in zip(_leaves(jtree), _leaves(ttree)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a))
    cfg = thf.read_config(path)
    if arch == "bert":
        pairs = (jhf.bert_config_from_hf(model.config, "cls_norm"),
                 thf.bert_config_from_hf(cfg, "cls_norm"))
    elif arch == "mistral":
        pairs = (jhf.lm_config_from_hf(model.config),
                 thf.lm_config_from_hf(cfg))
    else:
        pairs = (jhf.gpt2_config_from_hf(model.config),
                 thf.gpt2_config_from_hf(cfg))
    assert _fields(pairs[1]) == _fields(pairs[0])


def _ids(vocab, b=3, s=10, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(6, vocab, (b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[0, :3], mask[0, :3] = 0, 0
    return ids, mask


@pytest.mark.parametrize("gen,how", [("mistral", "sharded"),
                                     ("gpt2", "bin")])
def test_load_or_initialize_from_hf_dirs_matches_jax(tmp_path, gen, how):
    """Both packages' ``load_or_initialize_model`` from the same HF
    directories (the towers from one imported bge tower, cls_norm pooling
    from the path): equal configs, the port's leaves equal to JAX's, BERT
    embeddings to 1e-5 and LM logits at float32 to 1e-4."""
    bert = save(hf_model("bert"), tmp_path / "bge-tiny", "safetensors")
    genp = save(hf_model(gen, seed=1), tmp_path / f"{gen}-tiny", how)
    kw = dict(retriever_model_path=bert, generator_model_path=genp,
              generator_model_type=gen, model_size="tiny", precision="fp32",
              max_vocab=90, gold_score_mode="rag", use_lora=False, seed=0)
    jmodel, jparams, _ = jmodel_io.load_or_initialize_model(
        jconfig.Options(**kw), JStore.synthetic(16, seed=0))
    tmodel, tparams, _ = tmodel_io.load_or_initialize_model(
        tconfig.Options(device="cpu", **kw), TStore.synthetic(16, seed=0))
    assert tmodel.retriever.cfg.bert.pooling == "cls_norm"
    assert _fields(tmodel.gen_cfg) == _fields(jmodel.gen_cfg)
    assert _fields(tmodel.retriever.cfg.bert) == \
        _fields(jmodel.retriever.cfg.bert)
    want = jax.tree_util.tree_map(np.asarray, jparams)
    got = convert.params_to_numpy(tparams)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(_leaves(want), _leaves(got)):
        np.testing.assert_array_equal(b, a)
    ids, mask = _ids(90)
    for tower in ("query", "passage"):
        je = jmodel.retriever.embed(jparams["retriever"], jnp.asarray(ids),
                                    jnp.asarray(mask),
                                    is_passages=tower == "passage")
        te = tparams["retriever"].embed(torch.from_numpy(ids),
                                        torch.from_numpy(mask),
                                        is_passages=tower == "passage")
        np.testing.assert_allclose(te.detach().numpy(), np.asarray(je),
                                   rtol=1e-5, atol=1e-5)
    jcfg = dataclasses.replace(jmodel.gen_cfg, dtype=jnp.float32)
    tcfg = dataclasses.replace(tmodel.gen_cfg, dtype=torch.float32)
    jl = jlm.lm_logits(jparams["generator"], jcfg, jnp.asarray(ids),
                       jnp.asarray(mask))
    with torch.no_grad():
        tl = tlm.lm_logits(tparams["generator"], tcfg,
                           torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def _gpt2_pair(remat=False):
    model = hf_model("gpt2", seed=2)
    tree = jhf.import_gpt2(model.state_dict(), 2)
    kw = dict(arch="gpt2", vocab_size=97, hidden=32, layers=2, heads=4,
              kv_heads=4, intermediate=128, max_positions=64,
              tie_embeddings=True, remat=remat)
    return (jlm.LMConfig(dtype=jnp.float32, **kw),
            jax.tree_util.tree_map(jnp.asarray, tree),
            tlm.LMConfig(dtype=torch.float32, **kw),
            convert.lm_params_from_numpy(tree), model)


def test_gpt2_greedy_matches_jax():
    """gpt2 greedy decode over its full-MHA KV cache: the JAX package's
    token ids, log-probs to 1e-4; the cache-free logits equal HF's own
    forward to 1e-4 (the architecture, not only the port, is right)."""
    jcfg, jp, tcfg, tp, model = _gpt2_pair()
    ids, mask = _ids(97, b=4, s=9, seed=3)
    kw = dict(max_new_tokens=7, eos_id=11, pad_id=0, return_logprobs=True)
    jt, jlp = jlm.greedy_generate(jp, jcfg, jnp.asarray(ids),
                                  jnp.asarray(mask), **kw)
    tt, tlp = tlm.greedy_generate(tp, tcfg, torch.from_numpy(ids),
                                  torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-4)
    full = np.ones((2, 9), np.int32)
    with torch.no_grad():
        hf = model(input_ids=torch.from_numpy(ids[1:3]).long()).logits
        mine = tlm.lm_logits(tp, tcfg, torch.from_numpy(ids[1:3]),
                             torch.from_numpy(full))
    np.testing.assert_allclose(mine.numpy(), hf.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_gpt2_loss_and_lora_grads_match_jax(remat):
    """Training a gpt2 generator through LoRA: the loss to 1e-4 and each
    adapter gradient to 1e-4 relative + 1e-6 absolute, with and without
    per-layer recomputation."""
    jcfg, jp, tcfg, tp, _ = _gpt2_pair(remat)
    lcfg = dict(rank=4, alpha=8.0)
    rng = np.random.default_rng(4)
    ltree = {"layers": [{n: {"A": rng.standard_normal(
        (np.asarray(layer[n]).shape[0], 4)).astype(np.float32) * 0.1,
        "B": rng.standard_normal(
        (4, np.asarray(layer[n]).shape[1])).astype(np.float32) * 0.1}
        for n in ("qkv_w", "o_w", "fc_w", "proj_w")}
        for layer in jp["layers"]]}
    ids, mask = _ids(97, b=3, s=10, seed=5)
    labels = np.where(mask == 1, ids, -100)
    labels[:, :4] = -100

    def jloss(lora):
        merged = jlora.lora_apply(jp, lora, jlora.LoRAConfig(**lcfg))
        per, _ = jlm.lm_loss(merged, jcfg, jnp.asarray(ids),
                             jnp.asarray(mask), jnp.asarray(labels))
        return per.mean()

    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, ltree))
    tl_tree = convert.lora_params_from_numpy(ltree)
    leaves = [t.requires_grad_() for t in _leaves(tl_tree)]
    merged = tlora.lora_apply(tp, tl_tree, tlora.LoRAConfig(**lcfg))
    per, _ = tlm.lm_loss(merged, tcfg, torch.from_numpy(ids),
                         torch.from_numpy(mask), torch.from_numpy(labels))
    loss = per.mean()
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-4)
    for g, want in zip(grads, _leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)


def _opt(tmp_path, **over):
    kw = dict(model_size="tiny", precision="fp32", max_vocab=90,
              gold_score_mode="rag", use_lora=False, device="cpu",
              retriever_model_path="none", generator_model_path="none")
    kw.update(over)
    return tconfig.Options(**kw)


def _truncate(path):
    f = os.path.join(path, "model.safetensors")
    with open(f, "rb+") as fh:
        fh.truncate(os.path.getsize(f) - 100)


def _drop_shard_key(path):
    index = os.path.join(path, "model.safetensors.index.json")
    with open(index) as f:
        data = json.load(f)
    key = next(iter(data["weight_map"]))
    other = [v for v in set(data["weight_map"].values())
             if v != data["weight_map"][key]]
    data["weight_map"][key] = other[0]
    with open(index, "w") as f:
        json.dump(data, f)


@pytest.mark.parametrize("fault", ["no_weights", "truncated", "bad_index",
                                   "bad_config"])
def test_corrupt_or_missing_file_raises(tmp_path, fault):
    """A corrupt or missing HF file raises with the directory's path: no
    fallback to random init (the JAX package's loader carries on)."""
    how = "sharded" if fault == "bad_index" else "safetensors"
    path = save(hf_model("mistral"), tmp_path / "gen", how)
    if fault == "no_weights":
        os.remove(os.path.join(path, "model.safetensors"))
    elif fault == "truncated":
        _truncate(path)
    elif fault == "bad_index":
        _drop_shard_key(path)
    else:
        with open(os.path.join(path, "config.json"), "w") as f:
            f.write("{not json")
    with pytest.raises(RuntimeError, match="gen"):
        tmodel_io.load_or_initialize_model(
            _opt(tmp_path, generator_model_path=path),
            TStore.synthetic(8, seed=0))


def test_smoke_safetensors_writer_round_trips(tmp_path):
    """``chip_smoke.write_safetensors`` (the card has no safetensors
    package) writes files that ``safetensors.safe_open`` and the port's
    reader read back bit for bit, F32, F16 and BF16."""
    safetensors = pytest.importorskip("safetensors")
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn((5, 3), generator=g),
               "b": torch.randn((7,), generator=g).to(torch.float16),
               "c.bf": torch.randn((2, 3, 4), generator=g).to(torch.bfloat16),
               "scalar": torch.tensor(2.5)}
    path = str(tmp_path / "model.safetensors")
    chip_smoke.write_safetensors(path, tensors, metadata={"format": "pt"})
    with safetensors.safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(tensors)
        assert f.metadata() == {"format": "pt"}
        for k, v in tensors.items():
            assert torch.equal(f.get_tensor(k), v)
    sd = thf.read_state_dict(str(tmp_path))
    for k, v in tensors.items():
        got = sd[k]
        assert got.dtype == v.dtype and torch.equal(got, v)


def test_vocab_guard_raises_where_jax_gives_nan(tmp_path):
    """A SimpleTokenizer of --max_vocab ids over an HF generator with fewer
    rows raises at load time in the port, naming both sizes; the same ids
    give NaN logits in the JAX package's LM (the witness of the difference,
    ``jnp.take``'s fill mode). A restored checkpoint is guarded alike."""
    path = save(hf_model("mistral"), tmp_path / "mistral-tiny",
                "safetensors")
    with pytest.raises(ValueError, match=r"200 ids.*97 rows.*--max_vocab"):
        tmodel_io.load_or_initialize_model(
            _opt(tmp_path, generator_model_path=path, max_vocab=200),
            TStore.synthetic(8, seed=0))
    jcfg = dataclasses.replace(
        jhf.lm_config_from_hf(transformers.AutoConfig.from_pretrained(path)),
        dtype=jnp.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, jhf.import_causal_lm(
        thf.read_state_dict(path), 2))
    ids = jnp.asarray([[5, 150, 7]])
    logits = np.asarray(jlm.lm_logits(jp, jcfg, ids, jnp.ones_like(ids)))
    assert np.isnan(logits).all()
    # a checkpoint whose saved tokenizer outgrew the embedding
    opt = _opt(tmp_path, generator_model_path=path, max_vocab=90,
               checkpoint_dir=str(tmp_path / "ck"), name="run")
    _, params, _ = tmodel_io.load_or_initialize_model(
        opt, TStore.synthetic(8, seed=0))
    from jsa_rag_tpu_torch.data.tokenizer import SimpleTokenizer
    from jsa_rag_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(str(tmp_path / "ck"), "run", 1, params,
                    tokenizer=SimpleTokenizer(max_vocab=150))
    with pytest.raises(ValueError, match=r"150 ids.*97 rows"):
        tmodel_io.load_or_initialize_model(
            _opt(tmp_path, model_path=str(tmp_path / "ck" / "run")),
            TStore.synthetic(8, seed=0))


def test_tokenizer_loader_needs_tokenizer_files(tmp_path, monkeypatch):
    """A model directory holding weights and ``config.json`` only takes the
    SimpleTokenizer and never reaches ``AutoTokenizer`` (some transformers
    versions build a vocabulary-less tokenizer there, mapping every word
    to one unknown id); a directory with tokenizer files, or a cache name,
    still loads through ``AutoTokenizer``."""
    import sys
    import types

    from jsa_rag_tpu_torch.data import tokenizer as tk

    calls = []

    class Stub:
        pad_token, eos_token, unk_token = "[PAD]", None, "[UNK]"
        pad_token_id, bos_token_id, eos_token_id, sep_token_id = 0, 1, 2, 3

    def from_pretrained(name, **kw):
        calls.append(name)
        return Stub()

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        AutoTokenizer=types.SimpleNamespace(from_pretrained=from_pretrained)))
    bare = tmp_path / "bge-large-en"
    bare.mkdir()
    (bare / "config.json").write_text("{}")
    tok = tk.load_tokenizer(str(bare), max_vocab=77)
    assert isinstance(tok, tk.SimpleTokenizer) and tok.max_vocab == 77
    assert calls == []
    full = tmp_path / "with-tokenizer"
    full.mkdir()
    (full / "tokenizer.json").write_text("{}")
    assert isinstance(tk.load_tokenizer(str(full)), tk.HFTokenizerWrapper)
    assert isinstance(tk.load_tokenizer("BAAI/bge-large-en"),
                      tk.HFTokenizerWrapper)
    assert calls == [str(full), "BAAI/bge-large-en"]
