"""The whole step's share of the card's peak in the MoE training cell: the
operations the window's steps ask for (``yardstick/flops_mla_moe.py``: the
DeepSeek-V2 generator's forward and its backward to the activations, the
LoRA adapters, the routed experts at the experts each real token takes;
``yardstick/flops.py``: the query towers' forward and backward, the passage
tower's forwards, the searches), each at the peak of its precision (bf16
for the models, int8 for the scan), over the window's seconds (%); none
where the window counted no grouped expert work."""

from benchmark.yardstick import peaks


def read(rec):
    w = rec.window
    if not w.work.get("bf16") or "expert_ops" not in w.counters:
        return None
    need = (w.work["bf16"] / peaks.BF16_FLOPS
            + w.work.get("int8", 0.0) / peaks.INT8_OPS
            + w.work.get("f32", 0.0) / peaks.F32_FLOPS)
    return 100.0 * need / w.window_s
