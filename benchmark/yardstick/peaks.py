"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit), the numbers every share
in this benchmark is taken against."""

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def bound_s(ops_by_peak: dict, n_bytes: float) -> tuple[float, str]:
    """The least time the chip could take: the larger of the operations at
    their peaks (``{peak: ops}``, summed) and the bytes at HBM bandwidth.
    -> (seconds, "ops" or "bytes", whichever bounds it)."""
    t_ops = sum(ops / peak for peak, ops in ops_by_peak.items())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
