"""The routed experts' grouped products (``models/lm.py::_grouped``:
``torch._grouped_mm`` over the stacked experts and their unmerged adapters,
in the forward, the remat recompute and the backward): their bound over
their device time in the profiled steps (%). The bound
(``yardstick/flops_mla_moe.py::expert_work``, summed over the profiled
steps by the driver) is the larger of their operations at the bf16 peak
and their bytes at 3.35 TB/s (each layer's expert stacks read once a pass,
the routed rows in and out); the time is every device kernel whose name
holds one of ``KERNELS``: the CUTLASS grouped GEMM that
``torch._grouped_mm`` launches on the card (a ``GemmUniversal`` over a
``GroupProblemShape``) and the kernel that lays out its groups' problem
sizes and pointers (``prepare_grouped_gemm_data``). None where the window counted no grouped expert work or the trace
holds no such kernel."""

from benchmark.yardstick import peaks

KERNELS = ("GroupProblemShape", "prepare_grouped_gemm_data")


def read(rec):
    w = rec.window
    if w.trace is None or not w.counters.get("expert_ops"):
        return None
    secs = 0.0
    seen = set()
    for s, e, name in w.trace.device:
        if any(k in name for k in KERNELS):
            secs += (e - s) * 1e-6
            seen.add(name)
    if not seen or secs <= 0:
        return None
    bound, _ = peaks.bound_s({peaks.BF16_FLOPS: w.counters["expert_ops"]},
                             w.counters["expert_bytes"])
    return 100.0 * bound / secs
