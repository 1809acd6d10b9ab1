"""Standalone index-server process on one device.

Counterpart of ``python -m jsa_rag_tpu.serve`` (same flags, plus
``--device``): loads a saved int8r flat index (``ShardedFlatIndex.save`` of
either package) and the passages, and serves ``POST /retrieve``,
``GET /health`` and ``POST /rebuild`` (400 here: the standalone server has
no live encoder to rebuild from):

    python -m jsa_rag_tpu_torch.serve --index_path ckpt/index \\
        --passages data/passages.jsonl [--mmap_store store.bin] \\
        [--host 0.0.0.0] [--port 29501] [--device cuda]

``--device cuda`` (the default) on a machine without CUDA raises; pass
``--device cpu`` to serve from the CPU with the kernel's plain version.
"""

from __future__ import annotations

import argparse
import logging
import time


def main(argv=None, block: bool = True):
    ap = argparse.ArgumentParser(
        description="serve a saved jsa_rag_tpu index over HTTP (PyTorch)")
    ap.add_argument("--index_path", required=True,
                    help="dir written by --save_index_path / index.save()")
    ap.add_argument("--passages", nargs="*", default=[],
                    help="passages jsonl file(s), global corpus order")
    ap.add_argument("--mmap_store", default=None,
                    help="native mmap passage store (scripts/"
                         "build_passage_store.py) instead of jsonl")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=29501)
    ap.add_argument("--coalesce_window_ms", type=float, default=3.0,
                    help="collection window for batching concurrent "
                         "/retrieve requests into one bucketed device "
                         "dispatch; 0 disables coalescing")
    ap.add_argument("--refine_r", type=int, default=4,
                    help="rescore-pool widening for coarse-refine search "
                         "(same meaning as the train/evaluate flag)")
    ap.add_argument("--refine_gather", default="cols",
                    help="fp16 refine candidate gather, 'cols' or 'rows' "
                         "(checked as the JAX package checks it; no other "
                         "effect: the port's store is row-major)")
    ap.add_argument("--int8r_refine", default="rows",
                    choices=("rows", "rows1", "cols"),
                    help="int8r rescore strategy (same meaning as the "
                         "train/evaluate flag; this port has 'rows')")
    ap.add_argument("--device", default="cuda",
                    help="device the index lives and searches on; 'cuda' "
                         "raises where there is no CUDA")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)

    from ..data.passages import PassageStore, load_passages_jsonl
    from ..index import load_index
    from .server import IndexServer

    if args.mmap_store:
        store = PassageStore(mmap_path=args.mmap_store)
    elif args.passages:
        store = PassageStore(passages=load_passages_jsonl(args.passages))
    else:
        ap.error("one of --passages / --mmap_store is required")

    index = load_index(args.index_path, device=args.device,
                       refine_r=args.refine_r,
                       int8r_refine=args.int8r_refine,
                       refine_gather=args.refine_gather)
    if len(store) != index.n_passages:
        raise SystemExit(
            f"passage store has {len(store)} rows but the index holds "
            f"{index.n_passages} — wrong corpus for this index")

    server = IndexServer(index, store, index.dim,
                         host=args.host, port=args.port,
                         coalesce_window_s=args.coalesce_window_ms / 1e3)
    port = server.start()
    print(f"serving {index.n_passages} passages on {args.host}:{port} "
          f"({index.device})", flush=True)
    if not block:  # callers drive the running server themselves
        return server
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
