"""Task registry (counterpart of ``jsa_rag_tpu/tasks/__init__.py``; reference:
src/tasks/__init__.py:12-16): the same nine tasks."""

from . import base, fever, kilt, lm, mlm, multiple_choice, qa, section, \
    vanilla_qa  # noqa: F401

AVAILABLE_TASKS = {
    m.__name__.split(".")[-1]: m
    for m in [base, mlm, lm, multiple_choice, kilt, section, fever, qa,
              vanilla_qa]
}


def get_task(opt, tokenizer):
    if opt.task not in AVAILABLE_TASKS:
        raise ValueError(f"{opt.task} not recognised")
    return AVAILABLE_TASKS[opt.task].Task(opt, tokenizer)
