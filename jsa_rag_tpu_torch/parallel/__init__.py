"""Processes, the (data, index) grid and the collectives (counterpart of
``jsa_rag_tpu/parallel/``): ``mesh.py``; FSDP and tensor parallelism in
``sharding.py``."""

from .mesh import (Grid, init_processes, make_grid, process_count,  # noqa
                   process_index)
