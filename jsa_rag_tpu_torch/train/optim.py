"""The optimizer: AdamW with two LR groups, a frozen group, global-norm
clipping and gradient accumulation (counterpart of
``jsa_rag_tpu/train/optim.py``).

``AdamW`` reproduces what the JAX package builds with optax —
``chain(clip_by_global_norm(clip), multi_transform({"lm": adamw(lr),
"retr": adamw(lr_retriever), "frozen": set_to_zero()}, labels))``, wrapped
in ``MultiSteps`` when ``accumulation_steps > 1`` — rather than using
``torch.optim.AdamW``, which differs from it in three ways that change the
trained weights:

- optax decays every leaf labelled lm/retr, whether its gradient is zero or
  not (under jsa the prior's passage tower gets no gradient and shrinks by
  lr*wd each step; so does LoRA's A while B is zero); torch skips a
  parameter whose ``.grad`` is None;
- optax's clip counts every gradient in the global norm, the frozen leaves'
  too (the posterior's passage tower gets gradients through the union
  embedding but is never updated), and scales by clip/norm only when
  norm >= clip; ``clip_grad_norm_`` adds 1e-6 to the norm;
- the step size is read at the update count before the update
  (``schedule(0)`` first), and under accumulation the count advances once
  per ``accumulation_steps`` micro-steps, the clip acting on their mean.

Optimizer state is float32 (``param_dtype=bfloat16`` is not ported).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..config import Options
from ..utils.schedulers import make_lr_schedule


def named_leaves(params: dict) -> dict[tuple, torch.Tensor]:
    """Every parameter tensor by its path in the JAX package's tree:
    ("retriever", "query", "layers", "0", "q_w"), ("lora", "layers", "0",
    "q_w", "A"), ... — modules by their parameter names, dicts and lists by
    key and index."""
    out: dict[tuple, torch.Tensor] = {}

    def walk(prefix, node):
        if isinstance(node, nn.Module):
            for name, p in node.named_parameters():
                out[prefix + tuple(name.split("."))] = p
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + (str(k),), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + (str(i),), v)
        else:
            out[prefix] = node

    for key, sub in params.items():
        walk((key,), sub)
    return out


def leaf_label(path: tuple, opt: Options, lora_active: bool) -> str:
    """'lm', 'retr' or 'frozen' for one leaf, as ``optim.py::_label_tree``
    (:26-79) assigns it (src/util.py:192-219's param groups)."""
    key = path[0]
    if key == "generator":
        # the base under LoRA gets no gradient; frozen so decay cannot
        # shrink it
        return "frozen" if lora_active else "lm"
    if key == "lora":
        return "lm"
    if key in ("retriever", "post_retriever"):
        tower = path[1]
        if not opt.train_retriever:
            return "frozen"
        if opt.query_side_retriever_training and tower == "passage":
            return "frozen"
        if not opt.separate_learning_rates:
            return "lm"
        if opt.query_side_retriever_training:
            return "retr"
        if tower in ("query", "shared"):
            return "lm"
        if key == "retriever":
            return "retr"  # prior passage tower at lr_retriever
        # the posterior passage tower: untrained, decoupled or not
        return "frozen"
    return "lm"


class AdamW:
    """The JAX package's optax transform over ``named_leaves(params)``,
    updating the tensors in place. ``step(grads)`` takes one gradient per
    leaf in ``self.paths`` order (None where the loss does not reach it,
    read as zero) and applies the update when an accumulation window
    closes; it returns whether it did."""

    def __init__(self, opt: Options, params: dict):
        leaves = named_leaves(params)
        lora_active = opt.use_lora and "lora" in params
        self.paths = list(leaves)
        self.leaves = [leaves[p] for p in self.paths]
        self.labels = [leaf_label(p, opt, lora_active) for p in self.paths]
        self.b1, self.b2 = 0.9, opt.beta2
        self.eps, self.wd, self.clip = opt.epsilon, opt.weight_decay, opt.clip
        total = opt.scheduler_steps or opt.total_steps
        self.schedules = {
            "lm": make_lr_schedule(opt.scheduler, opt.lr, opt.warmup_steps,
                                   total),
            "retr": make_lr_schedule(opt.scheduler, opt.lr_retriever,
                                     opt.warmup_steps, total)}
        self.count = 0  # updates taken (optax's count, shared by groups)
        self.k = max(1, opt.accumulation_steps)
        self.mini_step = 0
        self.mu = [torch.zeros_like(t) if lab != "frozen" else None
                   for t, lab in zip(self.leaves, self.labels)]
        self.nu = [torch.zeros_like(t) if lab != "frozen" else None
                   for t, lab in zip(self.leaves, self.labels)]
        self.acc = ([None] * len(self.leaves)) if self.k > 1 else None

    def lr(self, label: str, count: int | None = None) -> float:
        """The step size a group's update at ``count`` uses (default: the
        next update's)."""
        return float(self.schedules[label](
            self.count if count is None else count))

    @torch.no_grad()
    def step(self, grads) -> bool:
        grads = list(grads)
        if self.k > 1:
            # MultiSteps: running mean acc + (g - acc) / (n + 1)
            n = self.mini_step
            for i, g in enumerate(grads):
                if g is None and self.acc[i] is None:
                    continue
                acc = (self.acc[i] if self.acc[i] is not None
                       else torch.zeros_like(self.leaves[i]))
                g = torch.zeros_like(acc) if g is None else g
                self.acc[i] = acc + (g - acc) / (n + 1)
            if self.mini_step < self.k - 1:
                self.mini_step += 1
                return False
            grads, self.acc = self.acc, [None] * len(self.leaves)
            self.mini_step = 0
        self._update(grads)
        return True

    def _update(self, grads) -> None:
        live = [g for g in grads if g is not None]
        dev = self.leaves[0].device
        # global norm over every gradient, frozen leaves included
        norm = torch.sqrt(sum((g.to(torch.float32) * g).sum() for g in live)
                          if live else torch.zeros((), device=dev))
        trigger = norm < self.clip
        denom = torch.where(trigger, torch.ones_like(norm), norm)
        factor = torch.where(trigger, torch.ones_like(norm),
                             torch.full_like(norm, self.clip))
        count_inc = self.count + 1
        # float32 bias corrections on the host, as python scalars: a host
        # tensor copied to the card would wait for the step's backward
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(count_inc))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(count_inc))
        steps = {lab: -self.lr(lab) for lab in ("lm", "retr")}
        for p, g, mu, nu, lab in zip(self.leaves, grads, self.mu, self.nu,
                                     self.labels):
            if lab == "frozen":
                continue  # set_to_zero
            if g is None:
                mu.mul_(self.b1)
                nu.mul_(self.b2)
            else:
                g = (g / denom) * factor  # optax: (t / g_norm) * max_norm
                mu.copy_((1 - self.b1) * g + self.b1 * mu)
                nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.wd * p
            p.add_(steps[lab] * u)
        self.count = count_inc


def set_optim(opt: Options, params: dict) -> AdamW:
    """The optimizer over every leaf of ``params``; leaves that take no
    gradient (the LoRA-frozen generator base) stop requiring one."""
    tx = AdamW(opt, params)
    for t, path, lab in zip(tx.leaves, tx.paths, tx.labels):
        if path[0] == "generator" and lab == "frozen":
            t.requires_grad_(False)
        else:
            t.requires_grad_(True)
    return tx
