"""Measurement scripts of the port (counterparts of ``scripts/analysis/``)."""
