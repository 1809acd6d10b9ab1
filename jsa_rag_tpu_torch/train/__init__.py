"""Inference half of the JAX package's ``train/``: checkpoint loading and the
RAG model's retrieval and generation. Training itself is ROADMAP queue A
items 7-9."""
