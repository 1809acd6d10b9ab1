"""The plain reference: float32 PyTorch (TF32 off) with no kernel, cache or
batching trick of the port, written from the published architectures and
the reference recipe's semantics. It imports nothing of ``jsa_rag_tpu``,
``jsa_rag_tpu_torch`` or JAX, and takes no weight, table or tensor the
program made: the inputs come from ``benchmark/inputs.py`` and the seed.

``precision.Matmul`` carries every product, so the same code computed one
step below the configuration's precision (TF32 for float32, fp8 for bf16)
is the control that the comparisons must refuse.
"""
