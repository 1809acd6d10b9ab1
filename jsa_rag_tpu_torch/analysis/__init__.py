"""Measurement scripts of the port (counterparts of ``scripts/analysis/``):
the end-to-end benches, the probes of the scans and their wrappers
(``refine_bench``, ``int8r_gap_probe``, ``mips_tune``) and the tools."""
