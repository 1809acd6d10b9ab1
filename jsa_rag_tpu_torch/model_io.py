"""Model construction / loading (counterpart of ``jsa_rag_tpu/model_io.py``,
:35-214; reference: src/model_io.py:304-379).

Builds the retriever and the generator from the geometry presets with a
seeded ``torch.Generator`` on ``--device`` (random init; the JAX package's
threefry and torch's Philox give different numbers from one seed), the
posterior retriever of the vrag/jsa modes, the LoRA overlay, and restores a
checkpoint either package's trainer wrote. The params dict is
``{"retriever": DualEncoderRetriever, "post_retriever": ..., "generator":
{...}, "lora": {...}}``: the towers are ``nn.Module``s holding their
weights, the generator and its adapter dicts under the JAX key names.
``--dropout`` and the remat flags (``--use_gradient_checkpoint_*``) go into
the configs.

Not here yet: the HF import of ``--retriever_model_path`` /
``--generator_model_path`` directories (ROADMAP queue A item 9), the gpt2
generator (item 12) and ``--param_dtype bfloat16``.
"""

from __future__ import annotations

import logging
import os

import torch

from .config import Options
from .convert import (lm_params_from_numpy, lora_params_from_numpy,
                      retriever_from_numpy)
from .data.passages import PassageStore
from .data.tokenizer import load_tokenizer
from .device import resolve_device
from .models.bert import BERT_PRESETS, BertConfig
from .models.lm import LMConfig, lm_init
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
PRECISIONS = {"bf16": torch.bfloat16, "fp16": torch.float16,
              "fp32": torch.float32}

# jsa_rag_tpu/models/hf_import.py:187-201
POOLING_BY_MODEL = (
    ("bge", "cls_norm"),
    ("dpr", "cls"),
    ("contriever", "mean"),
    ("nomic", "mean_norm"),
    ("gte", "mean_norm"),
)


def pooling_for_model_name(name: str) -> str:
    low = name.lower()
    for key, pooling in POOLING_BY_MODEL:
        if key in low:
            return pooling
    return "mean"


def load_or_initialize_model(opt: Options, store: PassageStore,
                              with_opt_state: bool = False):
    """-> (RAGModel, params dict, step), and the checkpoint's
    ``opt_state`` (the port's optimizer state, or None) as a fourth item
    with ``with_opt_state``. Restores from ``opt.model_path`` when it points
    at a checkpoint run/step dir."""
    if opt.param_dtype != "float32":
        raise NotImplementedError(
            f"param_dtype {opt.param_dtype!r}: the port keeps float32 "
            "parameters (bf16 storage is a training-slice option)")
    for path in (opt.retriever_model_path, opt.generator_model_path):
        if os.path.isdir(path):
            raise NotImplementedError(
                f"HF weight import from {path} is not ported yet: ROADMAP "
                "queue A item 9")
    if "gpt" in opt.generator_model_type.lower():
        raise NotImplementedError("the gpt2 generator is not ported yet: "
                                  "ROADMAP queue A item 12")
    device = resolve_device(opt.device)
    retriever_tok = load_tokenizer(None, max_vocab=opt.max_vocab)
    generator_tok = load_tokenizer(None, max_vocab=opt.max_vocab)
    restore = bool(opt.model_path and opt.model_path != "none")
    if restore:
        # grown SimpleTokenizer vocabs, so token ids match the embeddings
        gen_saved, ret_saved = load_tokenizers_from_checkpoint(opt.model_path)
        generator_tok = gen_saved or generator_tok
        retriever_tok = ret_saved or retriever_tok

    pooling = opt.retriever_pooling or pooling_for_model_name(
        opt.retriever_model_path)
    g = torch.Generator(device=device).manual_seed(opt.seed)
    bert_cfg = BertConfig(vocab_size=retriever_tok.vocab_size,
                          pooling=pooling,
                          remat=opt.use_gradient_checkpoint_retriever,
                          dropout=opt.dropout, **BERT_PRESETS[opt.model_size])
    ret_cfg = RetrieverConfig(
        bert=bert_cfg, tied=False,
        query_side_only=opt.query_side_retriever_training)
    gen_cfg = LMConfig(vocab_size=generator_tok.vocab_size,
                       dtype=PRECISIONS[opt.precision],
                       remat=opt.use_gradient_checkpoint_generator,
                       dropout=opt.dropout, **LM_PRESETS[opt.model_size])
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
        params = {"retriever": retriever,
                  "generator": lm_params_from_numpy(restored["generator"],
                                                    device)}
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
        logger.info("Restored checkpoint at step %d from %s", step,
                    opt.model_path)
    else:
        retriever = DualEncoderRetriever(ret_cfg, device=device, generator=g)
        gen_params = lm_init(gen_cfg, device=device, generator=g)
        params = {"retriever": retriever, "generator": gen_params}
        if needs_posterior:
            params["post_retriever"] = make_posterior(
                retriever, decouple=opt.decouple_encoder)
        if lora_cfg is not None:
            params["lora"] = lora_init(gen_params, lora_cfg, generator=g,
                                       device=device)
    model = RAGModel(opt, retriever, gen_cfg, retriever_tok, generator_tok,
                     store, lora_cfg=lora_cfg)
    if with_opt_state:
        return model, params, step, opt_state
    return model, params, step
