"""PyTorch/CUDA port of ``jsa_rag_tpu`` for one NVIDIA H100 (Hopper, sm_90a).

The JAX package beside this one is the reference; every module here names its
counterpart there and keeps its semantics, parameter key names and on-disk
formats, so a numpy pytree or a saved index moves between the two. This
package imports ``torch`` and numpy only — never ``jax`` and nothing of
``jsa_rag_tpu``.

Ported so far: serving (``python -m jsa_rag_tpu_torch.serve``), evaluation
(``python -m jsa_rag_tpu_torch.evaluate``), training in the jsa, rag, vrag
and concat modes (``python -m jsa_rag_tpu_torch.train``), every flat index
storage, the MIPS benches, HF checkpoint directories read without
``transformers`` (``models/hf_import.py``), the llama/GQA and gpt2
generators, bf16 parameter storage, the rerank and a profiler trace of
chosen steps, the IVF indexes (the reference's FAISS ivfflat/ivfsq/ivfpq
modes) with k-means, the approximate search, the Atlas index interop
(``index/atlas_io.py``), several processes under ``torchrun`` (the (data,
index) grid, DDP and the rank-sharded flat index, ``parallel/``), the
hard-copy demo trained from scratch (``demo/``) and the end-to-end benches
(``analysis/``); and the hand-written CUDA kernels behind the scans
(``csrc/``). Every entry point takes an explicit device and
defaults to ``cuda``; asking for ``cuda`` where there is none raises
(``device.resolve_device``), nothing falls back to the CPU on its own.
"""
