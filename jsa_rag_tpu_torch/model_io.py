"""Model construction / loading (counterpart of ``jsa_rag_tpu/model_io.py``,
:35-214; reference: src/model_io.py:304-379).

Builds the retriever and the generator, the posterior retriever of the
vrag/jsa modes and the LoRA overlay, and restores a checkpoint either
package's trainer wrote. The params dict is ``{"retriever":
DualEncoderRetriever, "post_retriever": ..., "generator": {...}, "lora":
{...}}``: the towers are ``nn.Module``s holding their weights, the generator
and its adapter dicts under the JAX key names.

Weights come from a checkpoint (``--model_path``), else from HF directories
(``--retriever_model_path`` / ``--generator_model_path``, read by
``models/hf_import.py`` without ``transformers``; the towers start from one
imported tower, ``from_towers(tower, tower)``, and an HF generator computes
in bf16 as ``lm_config_from_hf`` sets it), else from the geometry presets
with a seeded ``torch.Generator`` on ``--device`` (the JAX package's
threefry and torch's Philox give different numbers from one seed; a
``--generator_model_type gpt*`` preset is the gpt2 architecture, a
``deepseek*`` one deepseek_v2's, from ``DEEPSEEK_PRESETS``). Under a
checkpoint the HF directories give only their configs. The tokenizers come
from the model directories where they hold one (else a ``SimpleTokenizer``
of ``--max_vocab`` ids, or the grown one a checkpoint saved).

``--dropout`` and the remat flags (``--use_gradient_checkpoint_*``) go into
the configs, of imported towers and generators too (the JAX package drops
the remat flags there: remat changes memory, not numbers).
``--param_dtype bfloat16`` stores every floating leaf in bf16 after init or
restore, and ``float32`` casts a restored bf16 tree back up.

Where the JAX package carries on with random weights after a failed HF
load, the port raises with the path and the cause. A generator tokenizer
with more ids than the generator's embedding has rows raises
``ValueError`` at load time: the JAX package's ``jnp.take`` reads NaN rows
for such ids (NaN losses), the port's indexing would fault on the card.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import torch
from torch import nn

from .config import Options
from .convert import (lm_params_from_numpy, lora_params_from_numpy,
                      retriever_from_numpy)
from .data.passages import PassageStore
from .data.tokenizer import SimpleTokenizer, load_tokenizer
from .device import resolve_device
from .models.bert import BERT_PRESETS, BertConfig
from .models.hf_import import (bert_config_from_hf, hf_generator_config,
                               load_hf_generator, load_hf_retriever,
                               pooling_for_model_name, read_config)
from .models.lm import DeepseekV2Config, LMConfig, lm_init
from .models.lora import LoRAConfig, lora_init
from .models.retriever import (DualEncoderRetriever, RetrieverConfig,
                               make_posterior)
from .train.checkpoint import load_checkpoint, load_tokenizers_from_checkpoint
from .train.rag_model import RAGModel

logger = logging.getLogger(__name__)

# copied from jsa_rag_tpu/model_io.py:44-55
LM_PRESETS = {
    "tiny": dict(hidden=64, layers=2, heads=4, kv_heads=2, intermediate=128),
    "small": dict(hidden=256, layers=4, heads=8, kv_heads=4,
                  intermediate=512),
    "base": dict(hidden=1024, layers=8, heads=16, kv_heads=8,
                 intermediate=2816),
    # ~1B llama/mistral-geometry GQA generator
    "large": dict(hidden=2048, layers=16, heads=16, kv_heads=8,
                  intermediate=5632),
}
# deepseek_v2 geometries (``--generator_model_type deepseek*``): latent
# attention and routed experts, DeepSeek-V2-Lite's YaRN (the config's
# default); "large" is DeepSeek-V2-Lite's published widths and depth,
# "tiny" a test size; no other ``--model_size`` names one
DEEPSEEK_PRESETS = {
    "tiny": dict(hidden=64, layers=3, heads=4, intermediate=128,
                 kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                 v_head_dim=16, n_experts=8, experts_per_token=2,
                 expert_intermediate=32, n_shared_experts=1),
    "large": dict(hidden=2048, layers=27, heads=16, intermediate=10944,
                  kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128, n_experts=64, experts_per_token=6,
                  expert_intermediate=1408, n_shared_experts=2),
}
PRECISIONS = {"bf16": torch.bfloat16, "fp16": torch.float16,
              "fp32": torch.float32}
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _hf_dir(path: str) -> str | None:
    return path if path and os.path.isdir(path) else None


def _from_hf(load, path: str, *args):
    """``load(path, *args)``, re-raised with the path: no random-init
    fallback."""
    try:
        return load(path, *args)
    except Exception as err:
        raise RuntimeError(f"cannot import the HF checkpoint at {path}: "
                           f"{type(err).__name__}: {err}") from err


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Every floating leaf of ``params`` in ``dtype``: the towers in place
    (``nn.Module.to``), the generator and LoRA dicts leaf by leaf."""
    def leaf(t):
        return t.to(dtype) if t.is_floating_point() else t

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return leaf(node)

    out = {}
    for key, sub in params.items():
        out[key] = sub.to(dtype) if isinstance(sub, nn.Module) else walk(sub)
    return out


def check_generator_vocab(tokenizer, rows: int, opt: Options) -> None:
    """Refuse a generator tokenizer that can emit ids past the embedding's
    rows."""
    if tokenizer.vocab_size > rows:
        raise ValueError(
            f"the generator tokenizer has {tokenizer.vocab_size} ids, the "
            f"generator's embedding {rows} rows: ids past the table would "
            f"read no row (--max_vocab {opt.max_vocab} sets a "
            "SimpleTokenizer's size; lower it, or give the generator "
            "directory its own tokenizer)")


def load_or_initialize_model(opt: Options, store: PassageStore,
                              with_opt_state: bool = False):
    """-> (RAGModel, params dict, step), and the checkpoint's
    ``opt_state`` (the port's optimizer state, or None) as a fourth item
    with ``with_opt_state``. Restores from ``opt.model_path`` when it points
    at a checkpoint run/step dir."""
    device = resolve_device(opt.device)
    dtype = PARAM_DTYPES[opt.param_dtype]
    ret_dir = _hf_dir(opt.retriever_model_path)
    gen_dir = _hf_dir(opt.generator_model_path)
    retriever_tok = load_tokenizer(ret_dir, max_vocab=opt.max_vocab)
    generator_tok = load_tokenizer(gen_dir, max_vocab=opt.max_vocab)
    restore = bool(opt.model_path and opt.model_path != "none")
    if restore:
        # grown SimpleTokenizer vocabs, so token ids match the embeddings
        # (an HF tokenizer is already stable)
        gen_saved, ret_saved = load_tokenizers_from_checkpoint(opt.model_path)
        if gen_saved is not None and isinstance(generator_tok,
                                                SimpleTokenizer):
            generator_tok = gen_saved
        if ret_saved is not None and isinstance(retriever_tok,
                                                SimpleTokenizer):
            retriever_tok = ret_saved

    pooling = opt.retriever_pooling or pooling_for_model_name(
        opt.retriever_model_path)
    g = torch.Generator(device=device).manual_seed(opt.seed)
    hf_tower = hf_gen = None
    if ret_dir is None:
        bert_cfg = BertConfig(vocab_size=retriever_tok.vocab_size,
                              pooling=pooling, **BERT_PRESETS[opt.model_size])
    elif restore:  # the weights come from the checkpoint
        bert_cfg = _from_hf(lambda p: bert_config_from_hf(read_config(p),
                                                          pooling), ret_dir)
    else:
        bert_cfg, hf_tower = _from_hf(load_hf_retriever, ret_dir, pooling)
        logger.info("Loaded retriever weights from %s", ret_dir)
    bert_cfg = dataclasses.replace(
        bert_cfg, remat=opt.use_gradient_checkpoint_retriever,
        dropout=opt.dropout)
    ret_cfg = RetrieverConfig(
        bert=bert_cfg, tied=False,
        query_side_only=opt.query_side_retriever_training)
    if gen_dir is None:
        kind = opt.generator_model_type.lower()
        make = LMConfig
        if "deepseek" in kind:
            if opt.model_size not in DEEPSEEK_PRESETS:
                raise ValueError(
                    f"--model_size {opt.model_size!r} names no deepseek_v2 "
                    f"geometry: one of {sorted(DEEPSEEK_PRESETS)}")
            make = DeepseekV2Config
            preset = dict(DEEPSEEK_PRESETS[opt.model_size], rms_eps=1e-6)
            preset["kv_heads"] = preset["heads"]
        else:
            preset = dict(LM_PRESETS[opt.model_size])
            if "gpt" in kind:
                preset.update(kv_heads=preset["heads"], arch="gpt2")
        gen_cfg = make(vocab_size=generator_tok.vocab_size,
                       dtype=PRECISIONS[opt.precision], **preset)
    elif restore:
        gen_cfg = _from_hf(hf_generator_config, gen_dir)
    else:
        gen_cfg, hf_gen = _from_hf(load_hf_generator, gen_dir)
        logger.info("Loaded generator weights from %s", gen_dir)
    gen_cfg = dataclasses.replace(
        gen_cfg, remat=opt.use_gradient_checkpoint_generator,
        dropout=opt.dropout)
    lora_cfg = (LoRAConfig(rank=opt.lora_rank, alpha=opt.lora_alpha)
                if opt.use_lora else None)
    needs_posterior = (opt.gold_score_mode in ("vrag", "jsa")
                       and not opt.simplify_JSA)

    step = 0
    opt_state = None
    if restore:
        state = load_checkpoint(opt.model_path)
        opt_state = state.pop("opt_state", None)
        restored = state["params"]
        retriever = retriever_from_numpy(restored["retriever"], ret_cfg,
                                         device)
        # the generator straight in ``dtype``: no f32 copy of a 7B tree on
        # the card (cast_params below covers the other leaves)
        params = {"retriever": retriever,
                  "generator": lm_params_from_numpy(restored["generator"],
                                                    device, dtype)}
        if "post_retriever" in restored:
            params["post_retriever"] = retriever_from_numpy(
                restored["post_retriever"], ret_cfg, device)
        elif needs_posterior:
            # backfill from the RESTORED prior (model_io.py:195-201): the
            # pre-restore init would hand the chain an untrained proposal
            params["post_retriever"] = make_posterior(
                retriever, decouple=opt.decouple_encoder)
        if "lora" in restored:
            params["lora"] = lora_params_from_numpy(restored["lora"], device)
        step = int(state["step"])
        del state, restored
        logger.info("Restored checkpoint at step %d from %s", step,
                    opt.model_path)
    else:
        if hf_tower is not None:
            retriever = retriever_from_numpy(
                {"query": hf_tower, "passage": hf_tower}, ret_cfg, device)
            del hf_tower
        else:
            retriever = DualEncoderRetriever(ret_cfg, device=device,
                                             generator=g)
        if hf_gen is not None:
            gen_params = lm_params_from_numpy(hf_gen, device, dtype)
            del hf_gen
        else:
            gen_params = lm_init(gen_cfg, device=device, generator=g)
        params = {"retriever": retriever, "generator": gen_params}
        if needs_posterior:
            params["post_retriever"] = make_posterior(
                retriever, decouple=opt.decouple_encoder)
        if lora_cfg is not None:
            params["lora"] = lora_init(gen_params, lora_cfg, generator=g,
                                       device=device)
    check_generator_vocab(generator_tok,
                          params["generator"]["embed"].shape[0], opt)
    # bf16 parameter storage (Options.param_dtype), or f32 for a restored
    # bf16 tree: every floating leaf, after init or restore
    params = cast_params(params, dtype)
    model = RAGModel(opt, params["retriever"], gen_cfg, retriever_tok,
                     generator_tok, store, lora_cfg=lora_cfg)
    if with_opt_state:
        return model, params, step, opt_state
    return model, params, step
