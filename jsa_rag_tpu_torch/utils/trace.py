"""Named host ranges on the profiler's clock: the port's one span mechanism.

``span(name)`` is a ``torch.profiler.record_function`` while a profiler
records on this thread, and one shared no-op context otherwise. The program
keeps no spans, clock or exporter of its own: the profiler that is
recording holds the ranges and writes them beside the device's kernels, so
each idle stretch of the device lines up with the host range open during
it. Two profilers record them: ``--profile_steps`` (``train/loop.py``) and
any caller's ``torch.profiler.profile``.

The guard is the point: a bare ``record_function`` costs ~16 us even with
no profiler running, the guarded no-op ~1 us, and the train step opens
some 500 spans (every dropout site's mask).

Spans, by where the work happens:

- ``rag.build_batch``, ``rag.embed_queries``, ``rag.fetch_ids`` (the ids'
  copy to the host and their passages), ``rag.union``, ``rag.tokenize``
  (``train/rag_model.py``);
- ``step.loss``, ``step.grad`` (the backward with any remat recompute),
  ``step.reduce`` (several processes), ``step.update`` (clip and AdamW);
  inside the jsa loss ``jsa.towers``, ``jsa.generator``, ``jsa.mis``;
  ``dropout.mask`` at every dropout draw (``models/bert.py``);
- in the deepseek_v2 generator (``models/lm.py``), a layer at a time:
  ``mla.attention`` (the projections, the latent norm, the rotary, the
  attention and ``o_proj``), ``moe.route`` (the router, the top-k, the
  counts and the sort by expert), ``moe.experts`` (the gather, the grouped
  products with their adapters, the weighted scatter back), ``moe.shared``
  (the shared experts);
- ``index.search``, ``index.shard_search`` (``index/flat.py``);
  ``mips.quantize``, ``mips.scan``, ``mips.merge``, ``mips.refine``
  (``ops/mips_topt.py::mips_topk_int8r_t``);
- ``build.wait_tokens``, ``build.h2d``, ``build.encode``, ``build.write``
  (``index/build.py``).

A thread the profiler was not started on (``build_index``'s tokenising
worker) records nothing.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the host's work inside it in a running profiler's
    trace; a shared no-op where none records."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
