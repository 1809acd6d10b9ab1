"""The training step of ``train/step.py`` (the jsa loss over the towers and
the generator, the backward, AdamW): CUDA events around the call, the
window's total over its steps divided by its steps (ms a step)."""


def read(rec):
    xs = rec.window.spans.get("train.step_ms")
    return sum(xs) / len(xs) if xs else None
