"""Times the 16-bit scan kernels on one card at the flagship geometry.

    python -m jsa_rag_tpu_torch.analysis.kernel_timing
    # another checkout's kernels (say a parent commit's, unpacked in old/):
    PYTHONPATH=old python jsa_rag_tpu_torch/analysis/kernel_timing.py

1,300,000 seeded unit rows of d = 1024 (bf16, and the same as fp16), and
for B = 8, 64 and 512 seeded unit queries: the mean device time (CUDA
events over 10 calls after 2 warm-up calls) of kernel B3 on an f32 query
(``scan_topt_dense``, the hi/lo split), B6's instance on a bf16 query,
B4 (``scan_topt_f16h``) and B5 (``scan_topt_f16``) on the f32 query, each
at the emit tile 256 and the T of k = 100, B9 (``mips_topk_stream``, the
whole wrapper) on the bf16 query at k = 100, and one bare ``torch.matmul``
of the bf16 query against the rows. Prints one JSON line per B. To compare
two versions on one card, time them in turns (parent, change, change,
parent); a package whose B3 wrapper has no one-plane rule gets the bf16
query widened to f32 for B6.
"""

from __future__ import annotations

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


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_timing needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    for lo in range(0, N, 65_536):
        x = torch.randn((min(65_536, N - lo), D), generator=g, device=dev)
        rows[lo:lo + x.shape[0]] = x / x.norm(dim=1, keepdim=True)
    half = rows.half()
    one_plane = hasattr(mt, "bf16_query_planes")
    _, t = mt.scan_geometry(N, K)
    out = {}
    for b in (8, 64, 512):
        q = torch.randn((b, D), generator=g, device=dev)
        q = q / q.norm(dim=1, keepdim=True)
        qb = q.to(torch.bfloat16)
        qb_in = qb if one_plane else qb.float()
        out[b] = {
            "B3_f32q": cuda_ms(lambda: mt.scan_topt_dense(q, rows, N, 256, t)),
            "B6_bf16q": cuda_ms(
                lambda: mt.scan_topt_dense(qb_in, rows, N, 256, t)),
            "B4": cuda_ms(lambda: mt.scan_topt_f16h(q, half, N, 256, t)),
            "B5": cuda_ms(lambda: mt.scan_topt_f16(q, half, N, 256, t)),
            "B9": cuda_ms(lambda: ms.mips_topk_stream(qb, rows, K)),
            "matmul": cuda_ms(lambda: torch.matmul(qb, rows.t())),
        }
        print(json.dumps({"B": b, "device": torch.cuda.get_device_name(0),
                          **out[b]}), flush=True)
    return out


if __name__ == "__main__":
    main()
