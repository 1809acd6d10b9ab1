"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the
test marked ``cuda`` runs a cell on the card and skips elsewhere."""
