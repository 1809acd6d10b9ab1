"""Framework configuration (the port's own copy of ``jsa_rag_tpu/config.py``;
framework-neutral, copied so the port imports nothing of the JAX package).

A dataclass mirror of the reference's argparse Options (src/options.py:15-643)
— semantic field names kept flag-compatible so the reference's experiment
scripts translate 1:1. Grouped like the reference: base / optim / modeling /
JSA / index / eval. ``to_argparse``/``from_args`` give CLI parity for
train.py / evaluate.py. The port adds one flag, ``--device`` (default
``cuda``): the device every entry point runs on; ``cuda`` raises where there
is none (``device.resolve_device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class Options:
    # ----- basic (src/options.py:20-120)
    name: str = "experiment"
    checkpoint_dir: str = "./checkpoint"
    model_path: str = "none"
    train_data: list[str] = dataclasses.field(default_factory=list)
    eval_data: list[str] = dataclasses.field(default_factory=list)
    per_gpu_batch_size: int = 1
    per_gpu_embedder_batch_size: int = 128
    # training-data shuffle: examples buffered by the streaming reservoir
    # shuffle (O(buffer) memory); 0 materializes the whole dataset per
    # epoch for a full shuffle (the reference behavior, right for
    # topic-/length-sorted files that fit in host memory)
    shuffle_buffer_size: int = 65536
    log_freq: int = 100
    log_detail_num: int = 0  # dump training_info_step{N}.json for first N
    eval_freq: int = 500
    save_freq: int = 5000
    # retriever-encoder export cadence for external rebuild services
    # (reference: train.py:335-372, default 500); 0 disables the extra
    # cadence (exports still happen on save_freq)
    save_build_retriever_step: int = 500
    seed: int = 0
    target_maxlength: int = 256
    text_maxlength: int = 512

    # ----- optim (src/options.py:121-205) — defaults mirror the
    # reference argparse defaults; experiment scripts override like the
    # flagship (egs/)
    warmup_steps: int = 1000
    total_steps: int = 1000
    scheduler_steps: int | None = None
    accumulation_steps: int = 1
    dropout: float = 0.1
    lr: float = 1e-4
    lr_retriever: float = 1e-5
    clip: float = 1.0
    scheduler: str = "cosine"  # linear | cosine | fixed
    weight_decay: float = 0.1
    save_optimizer: bool = False
    epsilon: float = 1e-6
    beta2: float = 0.999
    separate_learning_rates: bool = True
    shard_optim: bool = False  # FSDP-style optimizer-state sharding
    precision: str = "bf16"  # fp32 | fp16 | bf16
    # Parameter STORAGE dtype (distinct from `precision`, the compute/
    # activation policy). "float32" keeps full master weights — the
    # reference's bf16-autocast-over-f32-masters semantics
    # (src/util.py:173-238 + torch autocast). "bfloat16" stores the whole
    # tree in bf16: at flagship geometry (bge-large towers + ~1B GQA
    # generator) f32 masters + Adam state + a 1.3M-row index shard exceed
    # one 16 GB v5e chip, so single-chip flagship runs need bf16 storage
    # (multi-chip runs can keep f32 masters and shard them with
    # --shard_optim instead). Adam's first moment stays f32 either way
    # (train/optim.py mu_dtype).
    param_dtype: str = "float32"  # float32 | bfloat16

    # ----- modeling (src/options.py:206-451)
    generator_model_type: str = "mistral"
    generator_model_path: str = "none"  # HF dir for weight import
    retriever_model_path: str = "bge"
    model_size: str = "tiny"  # tiny|small|base random-init geometry
    max_vocab: int = 50000  # SimpleTokenizer vocab when no HF tokenizer
    retriever_pooling: str | None = None  # derived from model path if None
    train_retriever: bool = True
    use_lora: bool = True
    lora_rank: int = 8
    lora_alpha: float = 16.0
    query_side_retriever_training: bool = False
    decoder_only: bool = True
    concat_doc: bool = False
    dialog: bool = False
    n_context: int = 10
    retriever_n_context: int = 100
    retriever_format: str = "{title} {text}"
    # rag | vrag | jsa (the reference's extra score modes — ppmean etc. —
    # are dead code there, src/rag.py:695-1285; the live four are matched)
    gold_score_mode: str = "jsa"
    gen_method: str = "fast_deocde1"  # concat | fast_deocde1 | fast_deocde2
    temperature_score: float = 0.01
    temperature_gold: float = 0.01
    use_gradient_checkpoint_retriever: bool = False
    use_gradient_checkpoint_generator: bool = False
    retrieve_with_rerank: bool = False
    n_to_rerank_with_retrieve_with_rerank: int = 128
    use_file_passages: bool = False
    closed_book: bool = False
    freeze_retriever_steps: int = -1
    refresh_index: str = "-1"
    # >0: double-buffered refresh spread over steps (batches per step)
    # instead of the blocking rebuild (SURVEY.md §7 "hard parts")
    incremental_refresh_batches: int = 0
    # prefetch the next batch's retrieval before dispatching the current
    # step so host tokenization overlaps device compute; candidate
    # SELECTION runs one optimizer step stale (same approximation class as
    # the between-refresh stale index; the loss still scores candidates
    # with live params). Off = exact reference step order.
    pipeline_retrieval: bool = False
    qa_prompt_format: str = "question: {question} answer: <extra_id_0>"

    # ----- JSA (src/options.py:452-552)
    mis_step: int = 1
    mis_topk: int = 0
    use_all_mis: bool = True
    temperature_jsa: float = 1.0
    temperature_lm: float = 1.0
    unil_postandprior: bool = True
    decouple_encoder: bool = False
    simplify_JSA: bool = False
    reduce_norm: bool = False
    contrastive_learning: bool = False
    training_sample_num: int = 1
    standard_mc: bool = False
    union_kl: bool = True
    kl_beta: float = 1.0

    # ----- index (src/options.py:553-588)
    index_mode: str = "flat"  # flat | ivf | faiss (reference alias)
    # "int8r" (residual-int8) is the production default since round 4: two
    # per-row int8 planes (value + residual-of-value) at EXACTLY fp16's
    # 2 bytes/element (reference-parity memory, src/index.py:52). The
    # coarse scan reads only plane 1 (1 B/elem at int8 MXU rate) and the
    # top-(r*k) rescore reconstructs ~14-bit precision (> fp16's 11) —
    # measured 0.9995/0.9998 recall@20/@100 (round-4 frontier) at
    # 21.0k qps/chip THROUGH ShardedFlatIndex.search (round-5 gap probe,
    # same session: raw kernel 21.2k, fp16_t refine 14-15k; the round-4
    # "5.5k production-path gap" was a harness artifact — per-iteration
    # host query uploads — see docs/BENCHMARKS.md round-5 section).
    # int8r dominates fp16 on both axes at equal HBM, so the default
    # flipped per VERDICT r3 item 3.
    # float16 keeps the reference's exact storage; bfloat16 is the
    # max-throughput 2-byte scan (0.9929/0.9946); int8 the half-memory
    # option; "hybrid" stores fp16 rows + a derived transposed int8
    # coarse copy (fp16 recall at int8-scan speed, 1.5x fp16 HBM)
    index_dtype: str = "int8r"
    # fp16 refine-rescore candidate gather: "cols" gathers strided columns
    # of the (d, N) store (no extra HBM); "rows" keeps a row-major copy for
    # contiguous gathers (2x index HBM) — A/B via
    # scripts/analysis/refine_bench.py before flipping the default
    refine_gather: str = "cols"
    # int8r rescore strategy: "rows" (default) = two-plane-quantized query
    # (the coarse kernel emits the exact plane-1 score; refine adds the
    # plane-2 term from contiguous rows — no strided gather); "rows1" =
    # single-plane query at coarse-scan speed (max throughput, recall
    # ~0.994); "cols" = legacy full reconstruction via column gather
    int8r_refine: str = "rows"
    # reference FAISS flags (src/options.py:553-588): with
    # --index_mode faiss, faiss_index_type selects flat / ivfflat / ivfsq /
    # ivfpq / pq; faiss_code_size is the PQ bytes-per-vector (flagship: 32,
    # run-jsa-nq-no-rebuild.sh:56-57)
    faiss_index_type: str = "ivfpq"
    faiss_code_size: int = 32
    ivf_n_lists: int = 0  # 0 -> auto: min(sqrt(N)/100-ish heuristic, 2048)
    ivf_n_probe: int = 0
    # exact fp16 reranking of the quantized-IVF candidate pool (the FAISS
    # IndexRefineFlat capability): sq8/pq probe speed, storage-quantization
    # ranking errors removed, +2 bytes/element HBM
    ivf_refine: bool = False
    # rescore-pool width multiplier for the coarse-refine searches (flat
    # hybrid storage and --ivf_refine): the coarse scan's top-(r*k)
    # candidates are rescored exactly; r=4 recovers ~all fp16 recall for
    # flat hybrid, raise for very tight score distributions
    refine_r: int = 4
    load_index_path: str | None = None
    save_index_path: str | None = None
    save_index_n_shards: int = 16
    passages: list[str] = dataclasses.field(default_factory=list)

    # ----- eval (src/options.py:589-615)
    # task-specific knobs (src/options.py modeling group)
    min_words_per_lm_instance: int | None = None
    min_lm_context_ratio: float = 0.5
    max_lm_context_ratio: float = 0.5
    mlm_noise_density: float = 0.15
    mlm_mean_noise_span_length: float = 3.0
    multiple_choice_num_options: int = 4
    multiple_choice_train_permutations: str = "single"
    multiple_choice_eval_permutations: str = "single"

    generation_max_length: int = 256
    # counts NEW tokens (HF min_new_tokens); the reference's min_length
    # counts prompt+generation, ill-defined under left padding
    generation_min_length: int | None = None
    generation_num_beams: int = 1
    generation_length_penalty: float = 1.1
    # forces each row to decode this formatted query prefix first
    # (reference prefix_allowed_tokens_fn, src/rag.py:2244-2274)
    decoder_prompt_format: str | None = None
    gen_doc_scores: float = 0.01
    task: str = "qa"
    write_results: bool = False
    # eval_loss is a separate full B*K generator CE program here (the
    # reference computes it inside its training forward); turn it off
    # when only generation metrics are wanted
    compute_eval_loss: bool = True

    # ----- mesh / TPU (new; replaces slurm/torchrun flags, src/slurm.py)
    mesh_data: int = 1
    mesh_index: int = 0  # 0 -> all remaining devices
    # Megatron-style generator sharding over the index axis (train/step.py);
    # params replicate (reference DDP, train.py:438-444) when off
    tensor_parallel: bool = False
    eps: float = 1e-30  # numerical floor, reference's self.eps
    # capture a jax.profiler trace for steps [start, stop) into the run dir
    # (replaces the reference's wall-clock-only timers, SURVEY.md §5.1)
    profile_steps: str = ""  # e.g. "10-12"

    # ----- the port's device (cuda | cpu); no silent fallback to the CPU
    device: str = "cuda"

    def __post_init__(self):
        # post-parse normalization mirroring src/options.py:616-633
        if self.closed_book:
            self.n_context = 1
            self.retriever_n_context = 1
        if self.scheduler_steps is None:
            self.scheduler_steps = self.total_steps
        if self.param_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"param_dtype must be float32|bfloat16, got "
                f"{self.param_dtype!r}")

    # ------------------------------------------------------------- argparse
    @classmethod
    def to_argparse(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            description="jsa_rag_tpu options (flag-compatible with the "
                        "reference's src/options.py)")
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            default = (
                f.default if f.default is not dataclasses.MISSING
                else f.default_factory()
            )
            if f.type in ("bool", bool):
                p.add_argument(name, type=_str2bool, nargs="?", const=True,
                               default=default)
            elif f.type in ("list[str]", list):
                p.add_argument(name, nargs="*", default=default)
            elif default is None:
                p.add_argument(name, default=None)
            else:
                p.add_argument(name, type=type(default), default=default)
        return p

    @classmethod
    def from_args(cls, argv=None) -> "Options":
        ns = cls.to_argparse().parse_args(argv)
        kwargs = {}
        for f in dataclasses.fields(cls):
            v = getattr(ns, f.name)
            if f.name in ("scheduler_steps", "generation_min_length",
                          "min_words_per_lm_instance",
                          "load_index_path", "save_index_path",
                          "retriever_pooling", "decoder_prompt_format") \
                    and v in ("none", "None", ""):
                v = None
            if f.name in ("scheduler_steps", "generation_min_length",
                          "min_words_per_lm_instance") and \
                    isinstance(v, str):
                v = int(v)
            kwargs[f.name] = v
        return cls(**kwargs)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    @classmethod
    def load(cls, path: str) -> "Options":
        with open(path) as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _str2bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("1", "true", "yes", "y")
