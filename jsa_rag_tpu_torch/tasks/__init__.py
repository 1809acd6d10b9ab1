"""Task registry (counterpart of ``jsa_rag_tpu/tasks/__init__.py``; reference:
src/tasks/__init__.py:12-16). This slice ports ``qa``, the task of the
evaluate path; the other tasks are ROADMAP queue A item 12."""

from . import qa

AVAILABLE_TASKS = {"qa": qa}
NOT_PORTED = ("base", "mlm", "lm", "multiple_choice", "kilt", "section",
              "fever", "vanilla_qa")


def get_task(opt, tokenizer):
    if opt.task in NOT_PORTED:
        raise NotImplementedError(
            f"task {opt.task!r} is not ported yet: ROADMAP queue A item 12")
    if opt.task not in AVAILABLE_TASKS:
        raise ValueError(f"{opt.task} not recognised")
    return AVAILABLE_TASKS[opt.task].Task(opt, tokenizer)
