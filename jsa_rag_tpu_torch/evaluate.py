"""Evaluation entry point of the port (counterpart of ``evaluate.py``; same
flags, plus ``--device``):

    python -m jsa_rag_tpu_torch.evaluate --name eval-run --task qa \\
        --eval_data data/dev.jsonl --passages data/passages.jsonl \\
        --model_path checkpoint/run --gen_method fast_deocde1 \\
        [--load_index_path ckpt/index] [--device cuda]

Flow: load or initialise the model (``--model_path`` may be a checkpoint the
JAX trainer wrote); load the index from ``--load_index_path`` or build it
with the live passage tower (and save it to ``--save_index_path``); then,
for each ``--eval_data`` file, ``evaluate`` (or ``run_retrieval_only`` under
``--task retrieval``) and log the metrics. ``--device cuda`` (the default)
raises where there is no CUDA; ``--device cpu`` runs every kernel's plain
version.

Under ``torchrun`` (one process a device) it joins the process group
(``--device cuda`` means ``cuda:{LOCAL_RANK}``), builds the (data, index)
grid from ``--mesh_data``/``--mesh_index`` as ``evaluate.py`` does (a
grid that does not match raises ``make_mesh``'s error), shards the index
over every rank and the questions over the ranks; rank 0 writes the merged
predictions file.
"""

from __future__ import annotations

import logging
import os
import sys

from .config import Options
from .data.passages import PassageStore
from .evaluation import evaluate, run_retrieval_only
from .index import build_index_for, load_index
from .model_io import load_or_initialize_model
from .parallel import mesh

logger = logging.getLogger("evaluate")


def main(argv=None) -> dict:
    """Run the evaluation; returns ``{data file name: metrics}``."""
    opt = Options.from_args(argv)
    opt.device = str(mesh.init_processes(opt.device))
    grid = mesh.evaluation_grid(opt)
    os.makedirs(os.path.join(opt.checkpoint_dir, opt.name), exist_ok=True)
    logging.basicConfig(
        level=logging.INFO if grid.rank == 0 else logging.WARNING,
        format="%(asctime)s | %(message)s", stream=sys.stdout)
    store = PassageStore.from_jsonl(opt.passages) if opt.passages else \
        PassageStore.synthetic(1024, seed=opt.seed)
    model, params, step = load_or_initialize_model(opt, store)

    if opt.closed_book or opt.use_file_passages:
        index = None  # no retrieval at all: never embed the corpus
    elif opt.load_index_path:
        index = load_index(opt.load_index_path, device=opt.device,
                           expected_dim=model.retriever.cfg.bert.hidden,
                           refine_r=opt.refine_r,
                           int8r_refine=opt.int8r_refine,
                           refine_gather=opt.refine_gather, grid=grid)
    else:
        index = build_index_for(opt, len(store),
                                model.retriever.cfg.bert.hidden,
                                device=opt.device, grid=grid)
        model.build_index(index, params)
        if opt.save_index_path:
            index.save(opt.save_index_path, n_files=opt.save_index_n_shards)

    results = {}
    for data_path in opt.eval_data:
        name = os.path.basename(data_path)
        if opt.task == "retrieval" and not opt.closed_book:
            metrics = run_retrieval_only(model, index, params, opt,
                                         data_path, step)
        else:
            metrics = evaluate(model, index, params, opt, data_path, step)
        logger.info("Dataset: %s | %s", name, " | ".join(
            f"{v:.4f} {k}" for k, v in sorted(metrics.items())))
        results[name] = metrics
    return results


if __name__ == "__main__":
    main()
