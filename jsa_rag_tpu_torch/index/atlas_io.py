"""Interop with Atlas's published sharded index (counterpart of
``jsa_rag_tpu/index/atlas_io.py``, :1-266).

The reference consumes, and Meta Atlas publishes, an index as
``total_saved_shards`` file pairs in one directory (reference:
src/index.py:62-112, get_data/preprocessing/download_index.py:7-13):

- ``embeddings.{i}.pt`` — a torch-saved fp16 tensor of shape ``(dim, n_i)``
  (the reference keeps the index transposed);
- ``passages.{i}.pt`` — a plain-pickle ``list[dict]`` of passage records
  ({"id", "title", "text", ...}) in the order of the columns.

This module reads and writes that layout:

- :func:`iter_atlas_shards` streams (rows, passages) a shard at a time;
- :func:`convert_atlas_index` writes the JAX package's float16 flat-index
  directory (int16 bits, as ``ShardedFlatIndex.save``) and a
  ``passages.jsonl``; ``index.load_index`` reads it as float16 storage;
- :func:`load_atlas_into_index` feeds a live index's ``set_embeddings``
  (and trains an IVF index's coarse quantiser);
- :func:`save_index_atlas_format` exports a flat index to the layout;
- :func:`import_atlas_retriever_towers` takes the BERT towers out of an
  Atlas ``model.pth.tar`` checkpoint (src/model_io.py:199-221).

Shards load with ``weights_only=True``; the checkpoint, a dict of more than
tensors, with ``weights_only=False`` (only open checkpoints you trust).

    python -m jsa_rag_tpu_torch.index.atlas_io convert <atlas_dir> <out_dir>
    python -m jsa_rag_tpu_torch.index.atlas_io export <index_dir> \\
        <passages.jsonl> <atlas_out_dir> [--shards 128] [--device cuda]
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Iterator

import numpy as np
import torch

PASSAGE_FNAME = "passages.{shard}.pt"
EMBEDDING_FNAME = "embeddings.{shard}.pt"
ATLAS_N_SHARDS = 128  # the published layout (download_index.py:10)


def detect_n_shards(path: str) -> int:
    n = len(glob.glob(os.path.join(path, "embeddings.*.pt")))
    if n == 0:
        raise FileNotFoundError(f"no embeddings.*.pt shards under {path}")
    return n


def read_embedding_shard(path: str, shard: int) -> np.ndarray:
    """-> (n_i, dim) fp16 rows (the reference stores (dim, n_i) columns)."""
    fn = os.path.join(path, EMBEDDING_FNAME.format(shard=shard))
    t = torch.load(fn, map_location="cpu", weights_only=True)
    return np.ascontiguousarray(t.numpy().T)


def read_passage_shard(path: str, shard: int) -> list[dict]:
    fn = os.path.join(path, PASSAGE_FNAME.format(shard=shard))
    with open(fn, "rb") as f:
        return pickle.load(f)


def iter_atlas_shards(path: str, n_shards: int | None = None
                      ) -> Iterator[tuple[np.ndarray, list[dict]]]:
    """Stream (rows (n_i, d) fp16, passages) per saved shard."""
    n_shards = n_shards or detect_n_shards(path)
    for i in range(n_shards):
        yield read_embedding_shard(path, i), read_passage_shard(path, i)


def convert_atlas_index(src: str, dst: str, *, n_shards: int | None = None,
                        write_passages: bool = True) -> dict:
    """Convert an Atlas-format directory into the flat index's saved layout
    (row-major fp16 as int16 bits, one npy file per shard, meta.json) plus
    ``passages.jsonl``, one shard in memory at a time. -> the meta dict."""
    n_shards = n_shards or detect_n_shards(src)
    os.makedirs(dst, exist_ok=True)
    total, dim = 0, None
    pf = (open(os.path.join(dst, "passages.jsonl"), "w")
          if write_passages else None)
    try:
        for i, (rows, passages) in enumerate(iter_atlas_shards(src,
                                                               n_shards)):
            if rows.shape[0] != len(passages):
                raise ValueError(f"shard {i}: {rows.shape[0]} embeddings vs "
                                 f"{len(passages)} passages")
            np.save(os.path.join(dst, f"embeddings.{i}.npy"),
                    rows.astype(np.float16).view(np.int16))
            if pf is not None:
                pf.writelines(json.dumps(p) + "\n" for p in passages)
            total += rows.shape[0]
            dim = rows.shape[1]
    finally:
        if pf is not None:
            pf.close()
    meta = {"n_passages": total, "dim": dim, "dtype": "int16",
            "store_int8": False, "store_f16_bits": True,
            "n_files": n_shards, "kind": "flat",
            "converted_from": "atlas"}
    with open(os.path.join(dst, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def load_atlas_into_index(index, path: str,
                          n_shards: int | None = None) -> int:
    """Write an Atlas-format directory into a live index through
    ``set_embeddings`` (row blocks in corpus order), then ``finalize`` an
    index that stages rows (IVF). -> rows written."""
    start = 0
    for rows, _ in iter_atlas_shards(path, n_shards):
        index.set_embeddings(start, rows.astype(np.float32))
        start += rows.shape[0]
    if start != index.n_passages:
        raise ValueError(f"index sized for {index.n_passages} passages but "
                         f"the atlas shards at {path} hold {start}")
    if getattr(index, "_staging", None) is not None:
        index.finalize()
    return start


def save_index_atlas_format(index, passages: list[dict], path: str, *,
                            total_saved_shards: int = ATLAS_N_SHARDS
                            ) -> None:
    """Export a flat index to the reference's layout (src/index.py:62-88):
    exactly ``total_saved_shards`` pairs of fp16 (dim, n_i) tensors and
    pickled passage lists, split by ``linspace`` (ragged or empty tails
    allowed: consumers iterate the fixed count)."""
    emb = index.embeddings_as_float().to(torch.float16).cpu()
    n = emb.shape[0]
    if len(passages) != n:
        raise ValueError(f"{len(passages)} passages vs {n} embeddings")
    os.makedirs(path, exist_ok=True)
    bounds = np.linspace(0, n, total_saved_shards + 1).astype(int)
    for shard in range(total_saved_shards):
        s, e = int(bounds[shard]), int(bounds[shard + 1])
        # a fresh tensor: a view would save the whole corpus's storage
        torch.save(emb[s:e].T.clone(memory_format=torch.contiguous_format),
                   os.path.join(path, EMBEDDING_FNAME.format(shard=shard)))
        with open(os.path.join(path, PASSAGE_FNAME.format(shard=shard)),
                  "wb") as f:
            pickle.dump(passages[s:e], f, protocol=pickle.HIGHEST_PROTOCOL)


def import_atlas_retriever_towers(checkpoint_path: str, n_layers: int
                                  ) -> tuple[dict, dict] | None:
    """(query tower, passage tower) BERT trees from an Atlas / reference
    ``model.pth.tar`` ({"model": state_dict, ...}, src/model_io.py:345-379;
    the retriever under ``retriever.*`` in contriever/bge naming), through
    ``models.hf_import.import_bert``. None when it holds no retriever."""
    from ..models.hf_import import _strip, import_bert

    ckpt = torch.load(checkpoint_path, map_location="cpu",
                      weights_only=False)
    sd = ckpt.get("model", ckpt)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}

    def tower(prefixes: list[str]):
        for pre in prefixes:
            if any(k.startswith(pre) for k in sd):
                return import_bert(_strip(sd, pre), n_layers)
        return None

    # the untied reference naming (src/retrievers.py:190-224), then tied
    q = tower(["retriever.query_contriever.",
               "retriever.query_retriever.model.",
               "retriever.contriever."])
    p = tower(["retriever.passage_contriever.",
               "retriever.passage_retriever.model.",
               "retriever.contriever."])
    if q is None and p is None:
        return None
    return q or p, p or q


def main(argv=None):
    """``convert`` turns an Atlas-format index into a ``load_index``
    directory; ``export`` writes a saved flat index back to the layout."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert")
    c.add_argument("src")
    c.add_argument("dst")
    c.add_argument("--n_shards", type=int, default=None)
    e = sub.add_parser("export")
    e.add_argument("index_dir")
    e.add_argument("passages")
    e.add_argument("dst")
    e.add_argument("--shards", type=int, default=ATLAS_N_SHARDS)
    e.add_argument("--device", default="cuda",
                   help="device the index is loaded on; 'cuda' raises "
                        "where there is no CUDA")
    args = ap.parse_args(argv)

    if args.cmd == "convert":
        meta = convert_atlas_index(args.src, args.dst,
                                   n_shards=args.n_shards)
        print(json.dumps(meta))
        return meta
    from ..data.passages import load_passages_jsonl
    from . import load_index

    index = load_index(args.index_dir, device=args.device)
    passages = load_passages_jsonl([args.passages])
    save_index_atlas_format(index, passages, args.dst,
                            total_saved_shards=args.shards)
    out = {"exported": index.n_passages, "shards": args.shards,
           "dst": args.dst}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
