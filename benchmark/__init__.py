"""The benchmark of the PyTorch/CUDA port (``jsa_rag_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that belongs
to one configuration, traffic mix or per-layer metric sits in a file of its
own (``configs/``, ``traffic/``, ``metrics/``, ``limits/``), found by the
name the manifest gives. The yardstick (input generation, the plain
reference, the FLOP and byte counters, the table of peaks, the trace
reduction and the comparisons that decide ``correct``) lives here, so a
change to the program cannot move it.
"""
