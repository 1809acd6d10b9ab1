"""Processes, the (data, index) grid and the collectives (counterpart of
``jsa_rag_tpu/parallel/``): ``mesh.py`` here; FSDP and tensor parallelism
(``parallel/sharding.py``) are ROADMAP queue A item 13b."""

from .mesh import (Grid, init_processes, make_grid, process_count,  # noqa
                   process_index)
