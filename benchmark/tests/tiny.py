"""Tiny versions of the cells' configurations and mixes, for runs of the
whole harness on the CPU (the kernels' plain versions run there).

The tiny towers and generator compute in float32, where the cells' run in
bf16 and their limits are of bf16. Where those limits do not fit these
sizes, ``limits`` sets the tiny cell's own, from the same two readings at
this size (CPU runs, seeds 2**31 + 99 and 11-13): the rebuild's
``emb_err`` reads 4.2e-06-6.1e-06 sound and 7.7e-04-8.4e-04 under the fp8
control (8e-3 holds the full size); ``log_lm_gap`` reads ~1e-06 sound and
0.032-0.21 under the faults that alter or leave out rows (0.5 holds the
full size's bf16 generator).
"""

from __future__ import annotations

WORDS = 500
INDEX = {"rows": 4096, "dim": 64, "dtype": "int8r"}
RETRIEVER = {"vocab_size": 520, "hidden_size": 64, "num_hidden_layers": 2,
             "num_attention_heads": 4, "intermediate_size": 128,
             "max_position_embeddings": 512, "type_vocab_size": 2,
             "layer_norm_eps": 1e-12, "pooling": "cls_norm"}
GENERATOR = {"vocab_size": 600, "hidden_size": 64, "intermediate_size": 128,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "num_key_value_heads": 2, "head_dim": 16, "rms_norm_eps": 1e-5,
             "rope_theta": 10000.0, "tie_word_embeddings": False,
             "torch_dtype": "float32"}
LAW = {"mean": 30, "sd": 5, "min": 20, "max": 40}

OVERRIDES = {
    "train-jsa-flagship": {
        "config": {"index": INDEX, "retriever": RETRIEVER,
                   "retriever_compute_dtype": "float32",
                   "generator": GENERATOR},
        "traffic": {"words": WORDS, "passage_words": LAW,
                    "options": {"per_gpu_batch_size": 1, "n_context": 3,
                                "retriever_n_context": 100, "mis_step": 8,
                                "use_all_mis": True,
                                "unil_postandprior": True,
                                "temperature_jsa": 0.1,
                                "text_maxlength": 64,
                                "target_maxlength": 16},
                    "trace_after_s": 0.0, "trace_steps": 1},
        "limits": {"log_lm_gap": {"op": "<=", "limit": 0.01}}},
    "search-int8r-b512": {
        "config": {"index": INDEX},
        "traffic": {"batch": 16, "k": 10, "pool_batches": 2,
                    "warmup_batches": 1, "sample_batches": 2,
                    "trace_after_s": 0.0, "trace_batches": 2}},
    "rebuild-bge-large-wiki": {
        "config": {"index": INDEX, "retriever": RETRIEVER,
                   "retriever_compute_dtype": "float32"},
        "traffic": {"words": WORDS, "passage_words": LAW, "batch": 8,
                    "max_length": 64, "sort_window": 2,
                    "warmup_rows": 32, "span_rows": 1024,
                    "sample_rows": 64,
                    "trace_after_s": 0.0, "trace_writes": 1},
        "limits": {"emb_err": {"op": "<=", "limit": 1e-4}}},
}
