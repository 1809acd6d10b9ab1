"""Kernel B1 (``csrc/topt_int8r2.cu``, ``topt_int8_kernel<1, ...>``): its
bound from the launch's shapes (``yardstick/flops.py::b1_scan_work``: the
larger of its int8 products at 1,979 TOPS and its bytes at 3.35 TB/s) over
its mean device time a launch in the profiled batches (%)."""

from benchmark.yardstick import peaks

KERNEL = "topt_int8_kernel<1,"


def read(rec):
    w = rec.window
    if w.trace is None or "b1_ops_per_launch" not in w.counters:
        return None
    secs, launches = w.trace.kernel_s(KERNEL)
    if not launches or secs <= 0:
        return None
    bound, _ = peaks.bound_s({peaks.INT8_OPS: w.counters["b1_ops_per_launch"]},
                             w.counters["b1_bytes_per_launch"])
    return 100.0 * bound / (secs / launches)
