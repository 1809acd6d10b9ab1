"""The single-device training step (counterpart of
``jsa_rag_tpu/train/step.py``): loss, backward, clip, AdamW update. Several
devices (DDP, FSDP, tensor parallelism) are ROADMAP queue A item 13.
"""

from __future__ import annotations

from ..config import Options
from .modes import MODE_LOSSES
from .optim import AdamW


def host_batch_rows(opt: Options) -> int:
    """Examples the data iterator draws per step: one device, so
    ``per_gpu_batch_size``."""
    return opt.per_gpu_batch_size


def make_train_step(model, mode: str, tx: AdamW):
    """-> train_step(params, batch, rng) -> (loss, aux): the mode loss, its
    gradients for every leaf that takes one (``torch.autograd.grad``; the
    gradients of frozen leaves are computed too, since they count in the
    clip norm) and the optimizer update, which changes ``params`` in place.
    The loss and the aux stay on the device."""
    if mode not in MODE_LOSSES:
        raise ValueError(
            f"unknown training mode {mode!r}; expected one of "
            f"{sorted(MODE_LOSSES)} (gold_score_mode / gen_method)")
    value_and_grad = model.loss_and_grad_fn(mode)
    where = [i for i, t in enumerate(tx.leaves) if t.requires_grad]
    train_leaves = [tx.leaves[i] for i in where]

    def train_step(params, batch, rng):
        (loss, aux), grads = value_and_grad(params, batch, rng, train_leaves)
        full = [None] * len(tx.leaves)
        for i, g in zip(where, grads):
            full[i] = g
        del grads
        tx.step(full)
        return loss, aux

    return train_step
