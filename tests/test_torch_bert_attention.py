"""The BERT tower's attention dispatch on the CPU: the composed code as its
own function, the paths that never launch the fused kernel, and what the
kernel's wrapper refuses. The kernel itself is held to the composed code on
the card (``tests/test_torch_cuda_attention.py``)."""

import math

import pytest
import torch

from jsa_rag_tpu_torch.models import bert
from jsa_rag_tpu_torch.ops import bert_attention as ba


def _composed(q, k, v, bias, rate, seed):
    """The layer's attention as it was written inline before the kernel."""
    b, s, nh, hd = q.shape
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    probs = torch.softmax(logits + bias, dim=-1).to(q.dtype)
    probs = bert.dropout(probs, rate, seed)
    return torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, nh * hd)


def _qkv(b=3, s=20, nh=4, hd=16, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, s, nh * hd), generator=g).to(dtype)
               .reshape(b, s, nh, hd) for _ in range(3))
    mask = torch.arange(s)[None, :] < torch.tensor([s, s // 2, 0])[:b, None]
    bias = torch.where(mask[:, None, None, :], 0.0, -1e9).to(torch.float32)
    return q, k, v, bias


@pytest.mark.parametrize("seed", [None, 1234])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_attention_plain_is_the_composed_code(dtype, seed):
    q, k, v, bias = _qkv(dtype=dtype)
    got = ba._attention_plain(q, k, v, bias,
                              lambda p: bert.dropout(p, 0.1, seed))
    assert torch.equal(got, _composed(q, k, v, bias, 0.1, seed))


def test_wrapper_on_the_cpu_is_the_plain_version():
    q, k, v, bias = _qkv(dtype=torch.bfloat16)
    before = ba.bert_attention.launches
    got = ba.bert_attention(q, k, v, bias)
    assert torch.equal(got, ba._attention_plain(q, k, v, bias))
    assert ba.bert_attention.launches == before


def _encoder(dtype, dropout=0.0):
    cfg = bert.BertConfig(vocab_size=100, hidden=64, layers=2, heads=4,
                          intermediate=128, pooling="cls_norm", dtype=dtype,
                          dropout=dropout)
    return bert.BertEncoder(cfg, generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["no_grad", "grad", "dropout", "f32"])
def test_layer_takes_the_composed_path_on_the_cpu(case, monkeypatch):
    """On the CPU, without grad, under grad, with a dropout rng and in f32
    activations, every layer runs ``_attention_plain`` and the kernel's
    launch count does not move."""
    calls = []
    plain = bert._attention_plain

    def counted(*args, **kwargs):
        calls.append(args[0].dtype)
        return plain(*args, **kwargs)

    monkeypatch.setattr(bert, "_attention_plain", counted)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    enc = _encoder(dtype, 0.1 if case == "dropout" else 0.0)
    ids = torch.randint(0, 100, (3, 12), generator=torch.Generator()
                        .manual_seed(1))
    mask = torch.ones((3, 12), dtype=torch.int32)
    before = ba.bert_attention.launches
    if case == "grad":
        enc(ids, mask).float().sum().backward()
        assert enc.layers[0].q_w.grad is not None
    else:
        with torch.no_grad():
            rng = torch.Generator().manual_seed(2) if case == "dropout" \
                else None
            out = enc(ids, mask, rng=rng)
        assert torch.isfinite(out.float()).all()
    assert calls == [dtype] * 2
    assert ba.bert_attention.launches == before


def _bad_cases():
    q, k, v, bias = _qkv(b=2, s=20, nh=4, hd=16, dtype=torch.bfloat16)
    q24 = torch.zeros((2, 20, 2, 24), dtype=torch.bfloat16)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    return {
        "f32": (q.float(), k.float(), v.float(), bias),
        "mixed_dtypes": (q, k, v.to(torch.float16), bias),
        "head_size_24": (q24, q24, q24, bias),
        "head_size_144": (*(torch.zeros((2, 20, 1, 144),
                                        dtype=torch.bfloat16),) * 3, bias),
        "shapes_differ": (q, k[:, :10], v, bias),
        "not_contiguous": (strided, k, v, bias),
        "bias_shape": (q, k, v, bias.reshape(2, 1, 20, 1)),
        "bias_dtype": (q, k, v, bias.to(torch.bfloat16)),
        "empty_batch": (q[:0], k[:0], v[:0], bias[:0]),
    }


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_wrapper_checks_refuse(case):
    with pytest.raises(ValueError):
        ba._check(*_bad_cases()[case])


def test_wrapper_checks_take_the_layer_inputs():
    for hd in (16, 32, 64, 128):
        q, k, v, bias = _qkv(b=2, s=20, nh=2, hd=hd, dtype=torch.bfloat16)
        ba._check(q, k, v, bias)
