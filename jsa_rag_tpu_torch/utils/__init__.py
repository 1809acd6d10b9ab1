"""Metrics and statistics (the port's copies of ``jsa_rag_tpu/utils``)."""
