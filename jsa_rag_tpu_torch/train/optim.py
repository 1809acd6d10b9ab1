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

Optimizer state is float32 whatever the parameters' dtype. Under
``--param_dtype bfloat16`` the gradient is read in f32, mu and nu stay f32
and the update is computed in f32 from the bf16 weight and rounded to bf16
on store, as ``optax.apply_updates`` does. The JAX package pins mu to f32
but keeps nu in the parameters' bf16, where ``0.999 nu + 0.001 g^2`` rounds
back to nu (``ADVICE.md:3``); the port's f32 nu is a deliberate difference.

Resume (a deliberate difference from the JAX package, which builds a fresh
state on every start and so reruns the warmup from count 0 with zero
moments): ``state_dict`` is the update count, the accumulation window's
position, and mu, nu and the pending accumulator per leaf, as numpy arrays
keyed by the leaf's tree path ("retriever/query/layers/0/q_w"); a
checkpoint written with ``--save_optimizer`` carries it as ``opt_state``
and ``set_optim`` restores it. Without it (an older checkpoint, or one the
JAX package wrote, whose optax state the port does not read) the count
starts at the restored step's updates and the moments at zero.

Sharded placement (``parallel/sharding.Placement``, ``--shard_optim`` /
``--tensor_parallel``): the optimizer is built on the narrowed leaves, so
mu and nu live on the shards; ``state_dict`` gathers them (collective: every
rank calls it) into the full arrays, the format of a one-process run, and
``load_state_dict`` narrows full arrays to the shards. The clip norm is then
global: each rank sums the squares of its shards, a replicated leaf's (or a
shard's that several ranks hold) counted on one rank of its group only, and
one all-reduce adds them.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..config import Options
from ..parallel import mesh, sharding
from ..utils.schedulers import make_lr_schedule

logger = logging.getLogger(__name__)

OPT_STATE_FORMAT = "jsa_rag_tpu_torch.AdamW/1"
# elements of the leaves one foreach chain updates at most: each operation
# holds f32 temporaries of that size (here 64 MiB)
FOREACH_ELEMENTS = 1 << 24


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

    def __init__(self, opt: Options, params: dict, placement=None):
        leaves = named_leaves(params)
        self.placement = placement
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
        self.norm = None
        self.k = max(1, opt.accumulation_steps)
        self.mini_step = 0
        self.mu = [_f32_zeros(t) if lab != "frozen" else None
                   for t, lab in zip(self.leaves, self.labels)]
        self.nu = [_f32_zeros(t) if lab != "frozen" else None
                   for t, lab in zip(self.leaves, self.labels)]
        self.acc = ([None] * len(self.leaves)) if self.k > 1 else None

    def state_dict(self) -> dict:
        """The state as plain Python and numpy: ``count``, ``mini_step``,
        and ``mu``/``nu`` for every trained leaf and ``acc`` for every leaf
        with a pending accumulation, each ``{tree path: array}``."""
        def host(ts):  # copies: the moments change in place
            ts = self._gathered(ts)
            return {"/".join(p): t.detach().to("cpu", copy=True).numpy()
                    for p, t in zip(self.paths, ts) if t is not None}

        return {"format": OPT_STATE_FORMAT, "count": int(self.count),
                "mini_step": int(self.mini_step),
                "accumulation_steps": int(self.k),
                "mu": host(self.mu), "nu": host(self.nu),
                "acc": host(self.acc) if self.acc is not None else {}}

    def _gathered(self, ts: list) -> list:
        """``ts`` (one tensor or None per leaf, the leaves' shapes) with
        every split leaf's entry gathered to its full value (collective
        under a split placement; the ranks agree on which entries exist)."""
        pl = self.placement
        if pl is None or not pl.split:
            return ts
        out = list(ts)
        for axis in (sharding.DATA, sharding.INDEX):
            idx = [i for i in pl.on(axis) if ts[i] is not None]
            if idx:
                for i, f in zip(idx, pl.gather_values([ts[i] for i in idx],
                                                      idx)):
                    out[i] = f
        return out

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict``'s output onto this optimizer's leaves
        (copied onto their device). A trained leaf the state lacks keeps
        zero moments, with a log line; a moment of another shape, or a
        state of another accumulation window, raises ``ValueError``."""
        if state.get("format") != OPT_STATE_FORMAT:
            raise ValueError(f"not a {OPT_STATE_FORMAT} state")
        if int(state["accumulation_steps"]) != self.k:
            raise ValueError(
                f"optimizer state accumulates {state['accumulation_steps']} "
                f"micro-steps, this run {self.k}")
        missing = []
        for i, (path, lab) in enumerate(zip(self.paths, self.labels)):
            key = "/".join(path)
            for name in ("mu", "nu", "acc"):
                ts = getattr(self, name)
                if ts is None or (name != "acc" and lab == "frozen"):
                    continue
                arr = state[name].get(key)
                if arr is None:
                    if name != "acc":
                        missing.append(key)
                    continue
                full = (self.placement.full_shapes[i] if self.placement
                        else tuple(self.leaves[i].shape))
                if tuple(arr.shape) != tuple(full):
                    raise ValueError(
                        f"optimizer state {name}[{key}] has shape "
                        f"{tuple(arr.shape)}, the leaf {tuple(full)}")
                t = torch.from_numpy(np.array(arr))
                if self.placement is not None:
                    t = self.placement.shard_of(i, t)
                ts[i] = t.to(self.leaves[i].device, torch.float32,
                             copy=True)
        if missing:
            logger.info("optimizer state has no moments for %d trained "
                        "leaves (%s, ...): they start at zero",
                        len(set(missing)), missing[0])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])

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
                       else _f32_zeros(self.leaves[i]))
                g = torch.zeros_like(acc) if g is None else g.float()
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
        pl = self.placement
        if pl is not None and pl.split:
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for i, g in enumerate(grads):
                if g is not None and self._counts(i):
                    sq = sq + (g.to(torch.float32) * g).sum()
            norm = torch.sqrt(mesh.all_reduce_(sq))
        else:
            norm = torch.sqrt(sum((g.to(torch.float32) * g).sum()
                                  for g in live)
                              if live else torch.zeros((), device=dev))
        self.norm = norm  # the last update's gradient norm, on the device
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
        for idx in self._update_groups(grads):
            i0 = idx[0]
            self._update_group(idx, grads, denom, factor, bc1, bc2,
                               steps[self.labels[i0]],
                               self.leaves[i0].dtype == torch.float32)
        self.count = count_inc

    def _update_groups(self, grads) -> list[list[int]]:
        """The trained leaves in groups that one chain of ``torch._foreach_*``
        calls updates: one label, f32 or not, with or without a gradient,
        each group at most ``FOREACH_ELEMENTS`` elements (a bound on the
        temporaries), in leaf order."""
        groups: dict[tuple, list[list[int]]] = {}
        sizes: dict[tuple, int] = {}
        for i, lab in enumerate(self.labels):
            if lab == "frozen":
                continue  # set_to_zero
            key = (lab, self.leaves[i].dtype == torch.float32,
                   grads[i] is not None)
            n = self.leaves[i].numel()
            chunks = groups.setdefault(key, [[]])
            if chunks[-1] and sizes[key] + n > FOREACH_ELEMENTS:
                chunks.append([])
                sizes[key] = 0
            chunks[-1].append(i)
            sizes[key] = sizes.get(key, 0) + n
        return [c for chunks in groups.values() for c in chunks]

    def _update_group(self, idx: list[int], grads, denom, factor,
                      bc1: float, bc2: float, step: float,
                      f32: bool) -> None:
        """AdamW on the leaves ``idx``: each operation one
        ``torch._foreach_*`` call over them all, in the order and precision
        of the update of one leaf, so the results are those of a loop over
        the leaves bit for bit (``tests/test_torch_optim.py``). A loop
        launches ~20 kernels a leaf: ~40,000 a step for the ~2,000 leaves
        of the full-width model."""
        b1, b2 = self.b1, self.b2
        mus = [self.mu[i] for i in idx]
        nus = [self.nu[i] for i in idx]
        if grads[idx[0]] is None:
            torch._foreach_mul_(mus, b1)
            torch._foreach_mul_(nus, b2)
        else:
            # optax: (t / g_norm) * max_norm; a bf16 gradient read in f32
            gs = torch._foreach_div([grads[i].float() for i in idx], denom)
            torch._foreach_mul_(gs, factor)
            torch._foreach_copy_(mus, torch._foreach_add(
                torch._foreach_mul(gs, 1 - b1), torch._foreach_mul(mus, b1)))
            torch._foreach_copy_(nus, torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                torch._foreach_mul(nus, b2)))
            del gs
        ps = [self.leaves[i] for i in idx]
        p32 = ps if f32 else [p.float() for p in ps]
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mus, bc1), den)
        del den
        u = torch._foreach_add(u, torch._foreach_mul(p32, self.wd))
        torch._foreach_mul_(u, step)
        if f32:
            torch._foreach_add_(ps, u)
        else:  # the f32 update rounded to the stored dtype
            torch._foreach_copy_(ps, torch._foreach_add(p32, u))

    def _counts(self, i: int) -> bool:
        """Whether this rank adds leaf ``i``'s squares to the global norm:
        one rank of the ranks that hold the same values."""
        s, g = self.placement.specs[i], self.placement.grid
        if s is None:
            return g.rank == 0
        return (g.index_rank if s.axis == sharding.DATA
                else g.data_rank) == 0


def _f32_zeros(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t, dtype=torch.float32)


def set_optim(opt: Options, params: dict, opt_state=None,
              step: int = 0, placement=None) -> AdamW:
    """The optimizer over every leaf of ``params``; leaves that take no
    gradient (the LoRA-frozen generator base) stop requiring one. On a
    resume at ``step``: ``opt_state`` in the port's form (``state_dict``)
    is restored; otherwise the update count starts at ``step //
    accumulation_steps`` (the loop takes one micro-step a step and
    ``AdamW.step`` closes a window every ``accumulation_steps``), so the LR
    schedule goes on where the run stopped, with zero moments. Under a
    sharded ``placement`` (``train/step.py::place_params``, built before
    this) the moments live on the shards and ``opt_state`` is narrowed."""
    tx = AdamW(opt, params, placement)
    if isinstance(opt_state, dict) and \
            opt_state.get("format") == OPT_STATE_FORMAT:
        tx.load_state_dict(opt_state)
        logger.info("restored the optimizer state at update %d", tx.count)
    elif step > 0:
        tx.count = step // tx.k
        logger.info("no optimizer state in the checkpoint: update count %d "
                    "from step %d, Adam moments start at zero", tx.count,
                    step)
    for t, path, lab in zip(tx.leaves, tx.paths, tx.labels):
        if path[0] == "generator" and lab == "frozen":
            t.requires_grad_(False)
        else:
            t.requires_grad_(True)
    return tx
