"""Training entry point of the port (counterpart of ``train.py``; same
flags, plus ``--device``):

    python -m jsa_rag_tpu_torch.train --name run --task qa \\
        --gold_score_mode jsa --train_data data/train.jsonl \\
        --passages data/passages.jsonl --index_dtype hybrid \\
        --total_steps 50 --model_size tiny [--device cuda]

Flow: load or initialise the model (``--model_path`` may be a checkpoint
either package wrote); load the index from ``--load_index_path`` or make an
empty one that the loop builds with the live passage tower; build the
optimizer, restoring its state from a checkpoint the port saved with
``--save_optimizer`` (else its update count from the restored step); run
``train``, which resumes the data where the restored step left it (eval on
``--eval_data`` every ``--eval_freq`` steps); save the index to
``--save_index_path``. ``--device cuda`` (the
default) raises where there is no CUDA; ``--device cpu`` runs every kernel's
plain version.

Several processes, one a device (``parallel/mesh.py``)::

    torchrun --nproc_per_node 8 -m jsa_rag_tpu_torch.train ... \
        [--mesh_data 8] [--mesh_index 1]

joins the process group from ``torchrun``'s environment (NCCL; ``--device
cuda`` means ``cuda:{LOCAL_RANK}``), builds the (data, index) grid
(``--mesh_data 1`` becomes the process count, as ``train.py`` does; a grid
that does not match raises ``make_mesh``'s error), shards the index over
every rank and the data over the data axis, and averages the gradients
(DDP). Logging is INFO on rank 0 and WARNING elsewhere.
"""

from __future__ import annotations

import logging
import os
import sys

from ..config import Options
from ..data.passages import PassageStore
from ..evaluation import evaluate
from ..index import build_index_for, load_index
from ..model_io import load_or_initialize_model
from ..parallel import mesh
from .loop import train
from .optim import set_optim
from .step import param_placement

logger = logging.getLogger("train")


def init_logger(opt: Options) -> None:
    os.makedirs(os.path.join(opt.checkpoint_dir, opt.name), exist_ok=True)
    logging.basicConfig(
        level=logging.INFO if mesh.process_index() == 0 else logging.WARNING,
        format="%(asctime)s | %(name)s | %(message)s",
        handlers=[logging.StreamHandler(sys.stdout),
                  logging.FileHandler(os.path.join(
                      opt.checkpoint_dir, opt.name, "run.log"))])


def main(argv=None) -> int:
    """Run the training; returns the final step."""
    opt = Options.from_args(argv)
    opt.device = str(mesh.init_processes(opt.device))
    grid = mesh.training_grid(opt)
    param_placement(opt, grid)
    init_logger(opt)
    if grid.rank == 0:
        opt.dump(os.path.join(opt.checkpoint_dir, opt.name, "options.json"))
    logger.info("grid: data %d x index %d (%d process(es)), device %s",
                grid.n_data, grid.n_index, grid.world, opt.device)
    store = PassageStore.from_jsonl(opt.passages) if opt.passages else \
        PassageStore.synthetic(1024, seed=opt.seed)
    model, params, step, opt_state = load_or_initialize_model(
        opt, store, with_opt_state=True)
    hidden = model.retriever.cfg.bert.hidden
    if opt.closed_book or opt.use_file_passages:
        index = None  # no retrieval at all: never embed the corpus
    elif opt.load_index_path:
        index = load_index(opt.load_index_path, device=opt.device,
                           expected_dim=hidden, refine_r=opt.refine_r,
                           int8r_refine=opt.int8r_refine,
                           refine_gather=opt.refine_gather, grid=grid)
    else:
        index = build_index_for(opt, len(store), hidden, device=opt.device,
                                grid=grid)
    tx = set_optim(opt, params, opt_state, step)
    del opt_state
    step = train(model, index, params, tx, opt, step=step,
                 evaluate_fn=evaluate, grid=grid)
    if opt.save_index_path and index is not None:
        index.save(opt.save_index_path, n_files=opt.save_index_n_shards)
    logger.info("done at step %d", step)
    return step


if __name__ == "__main__":
    main()
