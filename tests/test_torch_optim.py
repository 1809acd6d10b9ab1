"""The port's AdamW update (``train/optim.py``), one ``torch._foreach_*``
chain a group of leaves, against the update of one leaf at a time that it
replaces: the same params, moments and count bit for bit over several
steps, f32 and bf16 leaves, leaves with no gradient, frozen leaves, the
clip on and off, and groups split at ``FOREACH_ELEMENTS``."""

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.config import Options
from jsa_rag_tpu_torch.train import optim


def loop_update(tx, grads) -> None:
    """The update as it was written for one leaf at a time (the reference
    the foreach chains must equal)."""
    live = [g for g in grads if g is not None]
    norm = torch.sqrt(sum((g.to(torch.float32) * g).sum() for g in live))
    trigger = norm < tx.clip
    denom = torch.where(trigger, torch.ones_like(norm), norm)
    factor = torch.where(trigger, torch.ones_like(norm),
                         torch.full_like(norm, tx.clip))
    count_inc = tx.count + 1
    bc1 = float(np.float32(1) - np.float32(tx.b1) ** np.int32(count_inc))
    bc2 = float(np.float32(1) - np.float32(tx.b2) ** np.int32(count_inc))
    steps = {lab: -tx.lr(lab) for lab in ("lm", "retr")}
    for p, g, mu, nu, lab in zip(tx.leaves, grads, tx.mu, tx.nu, tx.labels):
        if lab == "frozen":
            continue
        if g is None:
            mu.mul_(tx.b1)
            nu.mul_(tx.b2)
        else:
            g = (g.float() / denom) * factor
            mu.copy_((1 - tx.b1) * g + tx.b1 * mu)
            nu.copy_((1 - tx.b2) * (g * g) + tx.b2 * nu)
        p32 = p.float()
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + tx.eps)
        u = u + tx.wd * p32
        if p.dtype == torch.float32:
            p.add_(steps[lab] * u)
        else:
            p.copy_(p32 + steps[lab] * u)
    tx.count = count_inc


def _params(dtype, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)

    def leaf(*shape):
        return (0.02 * torch.randn(shape, generator=g)).to(dtype)

    return {"generator": {"embed": leaf(50, 16), "final_norm": leaf(16),
                          "layers": [{"q_w": leaf(16, 16), "o_w": leaf(16, 16),
                                      "norm": leaf(16)} for _ in range(3)]},
            "retriever": {"x": leaf(7, 5), "y": leaf(3)},
            "post_retriever": {"passage": {"z": leaf(4, 4)}}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [1.0, 1e-3])
@pytest.mark.parametrize("elements", [1 << 24, 300])
def test_foreach_update_equals_the_loop(monkeypatch, dtype, clip, elements):
    """Five updates from the same params and gradients (two leaves with
    none; the posterior's passage tower frozen): every param, mu and nu
    bit for bit, at a clip that never triggers and one that always does,
    in one group a label and in groups of at most 300 elements."""
    monkeypatch.setattr(optim, "FOREACH_ELEMENTS", elements)
    opt = Options(lr=1e-2, lr_retriever=3e-3, weight_decay=0.1, clip=clip,
                  scheduler="linear", warmup_steps=2, total_steps=10,
                  use_lora=False)
    a, b = _params(dtype, 0), _params(dtype, 0)
    ta, tb = optim.AdamW(opt, a), optim.AdamW(opt, b)
    assert set(ta.labels) == {"lm", "retr", "frozen"}
    g = torch.Generator().manual_seed(1)
    for _ in range(5):
        grads = [None if i in (2, 5) else torch.randn(
            t.shape, generator=g).to(dtype) for i, t in enumerate(ta.leaves)]
        ta._update(grads)
        loop_update(tb, grads)
        assert ta.count == tb.count
        for name in ("leaves", "mu", "nu"):
            for x, y in zip(getattr(ta, name), getattr(tb, name)):
                assert (x is None) == (y is None)
                if x is not None:
                    assert x.dtype == y.dtype
                    assert torch.equal(x, y), name


def test_update_groups_split_by_label_dtype_gradient_and_size(monkeypatch):
    monkeypatch.setattr(optim, "FOREACH_ELEMENTS", 300)
    tx = optim.AdamW(Options(use_lora=False), _params(torch.float32, 0))
    grads = [None if i == 1 else torch.zeros(()) for i in
             range(len(tx.leaves))]
    groups = tx._update_groups(grads)
    flat = sorted(i for grp in groups for i in grp)
    assert flat == [i for i, lab in enumerate(tx.labels) if lab != "frozen"]
    for grp in groups:
        assert len({(tx.labels[i], grads[i] is None) for i in grp}) == 1
        assert (len(grp) == 1
                or sum(tx.leaves[i].numel() for i in grp) <= 300)
