"""Times the scan kernels on one card at the flagship geometry.

    python -m jsa_rag_tpu_torch.analysis.kernel_timing
    # another checkout's kernels (say a parent commit's, unpacked in old/):
    PYTHONPATH=old python jsa_rag_tpu_torch/analysis/kernel_timing.py
    # the int8 kernels alone over one card's 5.25M-row shard at B = 512
    python -m jsa_rag_tpu_torch.analysis.kernel_timing --n 5250000 \
        --batches 512 --int8_only

1,300,000 seeded unit rows of d = 1024 (bf16, the same as fp16, and their
per-row int8 codes and scales, ``quantize_int8``, which is plane 1 of
``quantize_int8_residual``), and for B = 2, 8, 64 and 512 seeded unit
queries: the mean device time (CUDA events over 10 calls after 2 warm-up
calls), each scan at the emit tile 256 and the T of k = 100 (k = 40 at
B = 2, the train step's), of
- the 16-bit kernels: B3 on an f32 query (``scan_topt_dense``, the hi/lo
  split), B6's instance on a bf16 query, B4 (``scan_topt_f16h``) and B5
  (``scan_topt_f16``) on the f32 query, B9 (``mips_topk_stream``, the whole
  wrapper) on the bf16 query at k = 100, and one bare ``torch.matmul`` of
  the bf16 query against the rows;
- the int8 kernels: B1 (``scan_topt_int8r2`` on the query's
  ``quantize_int8_residual`` planes), B2 (``scan_topt_int8`` on its
  ``quantize_int8`` plane), B8 (``mips_topk_int8``, the whole row-major
  wrapper, k = 100), and ``torch._int_mm`` of the int8 query (B2's product)
  and of both planes stacked (B1's) against the codes; ``_int_mm`` takes
  more than 16 rows, so a smaller operand runs padded to 32 rows.
Prints one JSON line per B, with the int8 core's geometry
(``int8_scan_geometry``) where the package has it. ``--n`` and
``--batches`` change the rows and the batch sizes; ``--int8_only`` keeps
only the int8 codes on the card (made 65,536 rows at a time) and times B1,
B2 and B8 alone. To compare two versions
on one card, time them in turns (parent, change, change, parent); a
package whose B3 wrapper has no one-plane rule gets the bf16 query widened
to f32 for B6.
"""

from __future__ import annotations

import argparse
import json

import torch

# absolute imports: run as a file, it times whichever package is first on
# the path
from jsa_rag_tpu_torch.ops import mips_stream as ms
from jsa_rag_tpu_torch.ops import mips_topt as mt

N, D, K = 1_300_000, 1024, 100


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def int8_codes(rows: torch.Tensor):
    """Per-row int8 codes and (N, 1) scales of ``rows``, 65,536 at a time."""
    codes = torch.empty(rows.shape, dtype=torch.int8, device=rows.device)
    scales = torch.empty((rows.shape[0], 1), device=rows.device)
    for lo in range(0, rows.shape[0], 65_536):
        codes[lo:lo + 65_536], scales[lo:lo + 65_536] = mt.quantize_int8(
            rows[lo:lo + 65_536].float())
    return codes, scales


def padded(q: torch.Tensor, rows: int = 32) -> torch.Tensor:
    """``q`` with zero rows up to ``rows`` (``torch._int_mm`` takes more
    than 16)."""
    if q.shape[0] > 16:
        return q
    return torch.cat([q, q.new_zeros((rows - q.shape[0], q.shape[1]))])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--batches", default="2,8,64,512")
    ap.add_argument("--int8_only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_timing needs a CUDA card")
    n = args.n
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    if args.int8_only:
        rows = half = None
        codes = torch.empty((n, D), dtype=torch.int8, device=dev)
        scales = torch.empty((n, 1), device=dev)
        for lo in range(0, n, 65_536):
            x = torch.randn((min(65_536, n - lo), D), generator=g, device=dev)
            codes[lo:lo + x.shape[0]], scales[lo:lo + x.shape[0]] = (
                mt.quantize_int8(x / x.norm(dim=1, keepdim=True)))
    else:
        rows = torch.empty((n, D), dtype=torch.bfloat16, device=dev)
        for lo in range(0, n, 65_536):
            x = torch.randn((min(65_536, n - lo), D), generator=g, device=dev)
            rows[lo:lo + x.shape[0]] = x / x.norm(dim=1, keepdim=True)
        half = rows.half()
        codes, scales = int8_codes(rows)
    es = scales.reshape(1, -1)
    codes_t = codes.t()
    one_plane = hasattr(mt, "bf16_query_planes")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for b in (int(x) for x in args.batches.split(",")):
        _, t = mt.scan_geometry(n, 40 if b == 2 else K)
        q = torch.randn((b, D), generator=g, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
        qv1, qs1, qv2, qs2 = mt.quantize_int8_residual(q)
        out[b] = {
            "T": t,
            "B1": cuda_ms(lambda: mt.scan_topt_int8r2(
                qv1, qs1, qv2, qs2, codes, es, n, 256, t)),
            "B2": cuda_ms(lambda: mt.scan_topt_int8(qv1, qs1, codes, es, n,
                                                    256, t)),
            "B8": cuda_ms(lambda: mt.mips_topk_int8(q, codes, scales, K)),
        }
        if not args.int8_only:
            qb = q.to(torch.bfloat16)
            qb_in = qb if one_plane else qb.float()
            both = padded(torch.cat([qv1, qv2]))
            qv1_pad = padded(qv1)
            out[b].update({
                "B3_f32q": cuda_ms(
                    lambda: mt.scan_topt_dense(q, rows, n, 256, t)),
                "B6_bf16q": cuda_ms(
                    lambda: mt.scan_topt_dense(qb_in, rows, n, 256, t)),
                "B4": cuda_ms(lambda: mt.scan_topt_f16h(q, half, n, 256, t)),
                "B5": cuda_ms(lambda: mt.scan_topt_f16(q, half, n, 256, t)),
                "B9": cuda_ms(lambda: ms.mips_topk_stream(qb, rows, K)),
                "matmul": cuda_ms(lambda: torch.matmul(qb, rows.t())),
                "int_mm": cuda_ms(lambda: torch._int_mm(qv1_pad, codes_t)),
                "int_mm_2planes": cuda_ms(
                    lambda: torch._int_mm(both, codes_t)),
            })
        if hasattr(mt, "int8_scan_geometry"):
            out[b]["geometry"] = {
                name: mt.int8_scan_geometry(b, planes, n, sms)
                for name, planes in (("B1", 2), ("B2", 1))}
        print(json.dumps({"B": b, "N": n,
                          "device": torch.cuda.get_device_name(0),
                          **out[b]}), flush=True)
    return out


if __name__ == "__main__":
    main()
