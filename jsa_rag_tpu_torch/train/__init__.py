"""The JAX package's ``train/``: the jsa training step and loop, the
optimizer, checkpoints and the RAG model's retrieval and generation; the
entry point is ``python -m jsa_rag_tpu_torch.train``."""
