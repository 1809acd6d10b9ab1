"""PyTorch/CUDA port of ``jsa_rag_tpu`` for one NVIDIA H100 (Hopper, sm_90a).

The JAX package beside this one is the reference; every module here names its
counterpart there and keeps its semantics, parameter key names and on-disk
formats, so a numpy pytree or a saved index moves between the two. This
package imports ``torch`` and numpy only — never ``jax`` and nothing of
``jsa_rag_tpu``.

Ported so far: the index-serving path (``python -m jsa_rag_tpu_torch.serve``)
over an int8r flat index, the BERT dual-encoder towers that fill it
(``index.build``), and the hand-written CUDA kernel behind its coarse scan
(``csrc/topt_int8r2.cu``). Every entry point takes an explicit device and
defaults to ``cuda``; asking for ``cuda`` where there is none raises
(``device.resolve_device``), nothing falls back to the CPU on its own.
"""
