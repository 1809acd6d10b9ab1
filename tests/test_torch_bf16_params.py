"""Port parity: ``--param_dtype bfloat16`` — bf16 parameter storage, the
optimizer's float32 moments beside it, and checkpoints across the two
packages and the two dtypes.

Tolerances. The cast is compared bit for bit (bf16 leaves as uint16). One
AdamW update is held to a numpy reference that keeps mu and nu in float32
and rounds the f32 update onto the stored dtype: within one bf16 ulp of the
reference at bfloat16 (the f32 arithmetic may round the other way at a
bf16 tie), within 1e-6 relative at float32; the moments to 1e-6 relative.
Checkpoint values are equal."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jsa_rag_tpu import config as jconfig
from jsa_rag_tpu import model_io as jmodel_io
from jsa_rag_tpu.data.passages import PassageStore as JStore
from jsa_rag_tpu.train import checkpoint as jckpt
from jsa_rag_tpu_torch import config as tconfig
from jsa_rag_tpu_torch import model_io as tmodel_io
from jsa_rag_tpu_torch.data.passages import PassageStore as TStore
from jsa_rag_tpu_torch.train import checkpoint as tckpt
from jsa_rag_tpu_torch.train import optim as toptim
from jsa_rag_tpu_torch.train.__main__ import main as tmain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(model_size="tiny", max_vocab=300, gold_score_mode="jsa",
          use_lora=True, lora_rank=4)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items()
                for p, v in _flat(x, prefix + (str(k),)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, prefix + (str(i),)).items()}
    return {prefix: tree}


def _bits(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.bfloat16
    return t.detach().view(torch.int16).numpy().view(np.uint16)


def _jax_checkpoint(tmp_path, bf16: bool) -> dict:
    """The JAX package's f32 init saved by its ``save_checkpoint`` (cast to
    bf16 ml_dtypes leaves first with ``bf16``); -> the saved f32 tree."""
    _, jparams, _ = jmodel_io.load_or_initialize_model(
        jconfig.Options(**KW), JStore.synthetic(8))
    tree = jax.tree_util.tree_map(np.array, jparams)
    if bf16:
        jparams = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x).astype(jnp.bfloat16), jparams)
    jckpt.save_checkpoint(str(tmp_path), "jax", 5, jparams)
    return tree


def test_bf16_cast_matches_jax_bits(tmp_path):
    """The same f32 checkpoint restored under ``--param_dtype bfloat16`` in
    both packages: every floating leaf (both towers of the prior and the
    posterior, the generator, LoRA) equal as uint16; a random init under
    bfloat16 stores every leaf in bf16 too."""
    _jax_checkpoint(tmp_path, bf16=False)
    path = str(tmp_path / "jax")
    _, jparams, _ = jmodel_io.load_or_initialize_model(
        jconfig.Options(model_path=path, param_dtype="bfloat16", **KW),
        JStore.synthetic(8))
    _, tparams, step = tmodel_io.load_or_initialize_model(
        tconfig.Options(device="cpu", model_path=path,
                        param_dtype="bfloat16", **KW), TStore.synthetic(8))
    assert step == 5
    want = _flat(jparams)
    got = toptim.named_leaves(tparams)
    assert set(got) == set(want) and {"lora", "post_retriever"} <= {
        p[0] for p in got}
    for p, t in got.items():
        np.testing.assert_array_equal(
            _bits(t), np.asarray(want[p]).view(np.uint16), err_msg=str(p))
    _, fresh, _ = tmodel_io.load_or_initialize_model(
        tconfig.Options(device="cpu", param_dtype="bfloat16", **KW),
        TStore.synthetic(8))
    assert {t.dtype for t in toptim.named_leaves(fresh).values()} == {
        torch.bfloat16}


def _reference(p32, grads, lrs, wd, clip, b1, b2, eps, dtype):
    """optax's AdamW with f32 mu and nu in numpy at the step sizes ``lrs``,
    the weight rounded to ``dtype`` after each update (bf16 by way of
    torch's RNE cast)."""
    mu = [np.zeros_like(p) for p in p32]
    nu = [np.zeros_like(p) for p in p32]
    p = [x.copy() for x in p32]
    for c, lr in enumerate(lrs, start=1):
        g = grads[c - 1]
        norm = np.float32(np.sqrt(sum(np.sum(x * x) for x in g)))
        if norm >= clip:
            g = [(x / norm) * np.float32(clip) for x in g]
        bc1 = np.float32(1) - np.float32(b1) ** np.int32(c)
        bc2 = np.float32(1) - np.float32(b2) ** np.int32(c)
        for i in range(len(p)):
            mu[i] = np.float32(1 - b1) * g[i] + np.float32(b1) * mu[i]
            nu[i] = np.float32(1 - b2) * (g[i] * g[i]) + np.float32(b2) * nu[i]
            u = (mu[i] / bc1) / (np.sqrt(nu[i] / bc2) + np.float32(eps))
            new = p[i] - np.float32(lr) * (u + np.float32(wd) * p[i])
            p[i] = torch.from_numpy(new).to(dtype).float().numpy()
    return p, mu, nu


@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_adamw_steps_match_numpy_reference(dtype, clip):
    """Three updates on bf16 (or f32) leaves: mu and nu stay float32 (a
    bf16 nu would freeze at b2 = 0.999 under a constant gradient), the
    stored weights within one bf16 ulp of the f32 reference (1e-6 relative
    at float32), the moments to 1e-6 relative; clipping on and off."""
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    shapes = [(6, 5), (7,)]
    p32 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           .to(tdt).float().numpy() for s in shapes]
    g0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(tdt) for s in shapes]
    grads = [[g.float().numpy() for g in g0]] * 3  # a constant gradient
    params = {"generator": {"embed": torch.tensor(p32[0]).to(tdt),
                            "final_norm": torch.tensor(p32[1]).to(tdt)}}
    opt = tconfig.Options(device="cpu", lr=1e-2, weight_decay=0.1,
                          clip=clip, warmup_steps=0, total_steps=10,
                          scheduler="fixed", use_lora=False, beta2=0.999)
    tx = toptim.AdamW(opt, params)
    for _ in range(3):
        assert tx.step(list(g0))
    assert all(m.dtype == torch.float32 for m in tx.mu + tx.nu)
    lrs = [tx.lr("lm", c) for c in range(3)]  # the schedule's, from 0
    want, mu, nu = _reference(p32, grads, lrs, 0.1, clip, 0.9, 0.999,
                              opt.epsilon, tdt)
    for leaf, w, m, n, tm, tn in zip(tx.leaves, want, mu, nu, tx.mu, tx.nu):
        assert leaf.dtype == tdt
        got = leaf.float().numpy()
        if dtype == "bfloat16":
            ulp = np.exp2(np.floor(np.log2(np.abs(w))) - 7)
            assert np.all(np.abs(got - w) <= ulp)
        else:
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tm.numpy(), m, rtol=1e-6)
        np.testing.assert_allclose(tn.numpy(), n, rtol=1e-6)
    # nu grew each step as (1 - b2^t) g^2 (clipped); it did not freeze
    assert np.all(tx.nu[1].numpy() > 2.9e-3 * np.square(
        grads[0][1] * min(1.0, clip / np.sqrt(sum(np.sum(x * x)
                                                  for x in grads[0])))))


def _train_argv(tmp_path, name, steps, **extra):
    data = tmp_path / "data"
    if not data.exists():
        subprocess.run([sys.executable, os.path.join(
            ROOT, "scripts", "make_synthetic_data.py"), "--out", str(data),
            "--n_passages", "48", "--n_train", "8", "--n_dev", "2"],
            check=True, capture_output=True)
    kw = dict(name=name, checkpoint_dir=str(tmp_path / "ck"), task="qa",
              qa_prompt_format="{question}", gold_score_mode="jsa",
              train_data=str(data / "train.jsonl"),
              passages=str(data / "passages.jsonl"), model_size="tiny",
              precision="fp32", dropout=0.0, n_context=3, mis_step=8,
              lr=1e-3, lr_retriever=1e-3, warmup_steps=1,
              total_steps=steps, text_maxlength=32, target_maxlength=16,
              index_dtype="hybrid", log_freq=1, save_freq=steps,
              eval_freq=1000, max_vocab=600, seed=0, device="cpu",
              save_optimizer="true", use_lora="true", lora_rank=4)
    kw.update(extra)
    return [x for k, v in kw.items() for x in (f"--{k}", str(v))]


def test_bf16_run_resumes_under_float32_and_loads_in_jax(tmp_path):
    """Two jsa steps in bf16 storage, saved with the optimizer: every
    saved leaf is the float32 array of bf16 values (lossless), the Adam
    moments float32; the JAX package's ``load_checkpoint`` reads it and its
    bf16 cast gives the saved bits back; resumed under float32 every leaf
    is upcast to those values; resumed under bfloat16 it trains on."""
    assert tmain(_train_argv(tmp_path, "bf16", 2,
                             param_dtype="bfloat16")) == 2
    run = str(tmp_path / "ck" / "bf16")
    saved = tckpt.load_checkpoint(run)
    leaves = _flat(saved["params"])
    for p, v in leaves.items():
        assert v.dtype == np.float32, p
        np.testing.assert_array_equal(
            torch.from_numpy(v).to(torch.bfloat16).float().numpy(), v,
            err_msg=str(p))
    for name in ("mu", "nu"):
        assert saved["opt_state"][name] and all(
            a.dtype == np.float32 for a in saved["opt_state"][name].values())
    jstate = jckpt.load_checkpoint(run)
    for p, v in _flat(jstate["params"]).items():
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(v).astype(jnp.bfloat16)).astype(
                np.float32), leaves[p])
    opt = tconfig.Options.from_args(_train_argv(
        tmp_path, "resume", 3, param_dtype="float32", model_path=run))
    _, params, step, opt_state = tmodel_io.load_or_initialize_model(
        opt, TStore.from_jsonl(opt.passages), with_opt_state=True)
    assert step == 2
    got = toptim.named_leaves(params)
    assert {t.dtype for t in got.values()} == {torch.float32}
    for p, t in got.items():
        np.testing.assert_array_equal(t.detach().numpy(), leaves[p])
    tx = toptim.set_optim(opt, params, opt_state, step)
    assert tx.count == 2
    assert tmain(_train_argv(tmp_path, "resume16", 3, param_dtype="bfloat16",
                             model_path=run)) == 3


def test_jax_bf16_checkpoint_loads_in_the_port(tmp_path):
    """A checkpoint the JAX package saved with ml_dtypes bf16 leaves loads
    where ml_dtypes is installed: float32 values equal to the bf16 ones
    under ``float32``, the same bits under ``bfloat16``."""
    tree = _flat(_jax_checkpoint(tmp_path, bf16=True))
    path = str(tmp_path / "jax")
    for dtype in ("float32", "bfloat16"):
        _, params, step = tmodel_io.load_or_initialize_model(
            tconfig.Options(device="cpu", model_path=path, param_dtype=dtype,
                            **KW), TStore.synthetic(8))
        assert step == 5
        for p, t in toptim.named_leaves(params).items():
            want = torch.from_numpy(tree[p]).to(torch.bfloat16)
            assert t.dtype == getattr(torch, dtype)
            assert torch.equal(t.detach(), want.to(t.dtype)), p


def test_jax_bf16_checkpoint_raises_clearly_without_ml_dtypes(tmp_path):
    """Where ml_dtypes cannot be imported (as on the card) the same
    checkpoint raises the loader's clear TypeError naming the module."""
    _jax_checkpoint(tmp_path, bf16=True)
    code = ("import sys\n"
            "for m in ('ml_dtypes', 'jax', 'jaxlib', 'jsa_rag_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from jsa_rag_tpu_torch.train.checkpoint import load_checkpoint\n"
            "try:\n"
            f"    load_checkpoint({str(tmp_path / 'jax')!r})\n"
            "except TypeError as e:\n"
            "    print('TypeError:', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "TypeError:" in out.stdout and "ml_dtypes" in out.stdout
