"""The BERT tower's fused attention kernel against its composed version, on
the card.

These tests need a CUDA device and skip without one. They import torch only:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda_attention.py

Tolerance. Both paths take the same f32 logits (exact products of the 16-bit
inputs, f32 sums in another order: ~1e-6 relative) and the same f32 softmax
arithmetic; they round the probabilities to the 16-bit type at different
points (the kernel before normalising, the composed path after), each
within the type's unit roundoff u of every weight (2^-9 for bf16, 2^-11 for
fp16), so each context lies within u * max|v| of the exact one, and the
stored context within u of its own value. The two agree to
2 u max|v| + 2 u |ctx| <= 4 u max|v|: 2^-7 max|v| in bf16, 2^-9 in fp16.
"""

import math

import numpy as np
import pytest
import torch

from jsa_rag_tpu_torch.models import bert
from jsa_rag_tpu_torch.ops import bert_attention as ba

UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -9, torch.float16: 2.0 ** -11}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _case(dev, b, s, nh, hd, dtype, seed, masked_rows=(), lengths=None):
    """q, k, v as (B, S, nh, hd) views of (B, S, H) rows, and the encoder's
    (B, 1, 1, S) mask bias: ragged lengths in [1, S] (S for sequence 0),
    every key masked for the sequences in ``masked_rows``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, nh * hd), generator=g, device=dev)
               .to(dtype).reshape(b, s, nh, hd) for _ in range(3))
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(1, s + 1, size=b)
        lengths[0] = s
    mask = torch.arange(s)[None, :] < torch.as_tensor(lengths)[:, None]
    mask[list(masked_rows)] = False
    bias = torch.where(mask[:, None, None, :].to(dev), 0.0, -1e9).to(
        torch.float32)
    return q, k, v, bias


def _check_close(q, k, v, bias):
    before = ba.bert_attention.launches
    got = ba.bert_attention(q, k, v, bias)
    want = ba._attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert ba.bert_attention.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    atol = 4 * UNIT_ROUNDOFF[q.dtype] * float(v.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= atol, (err, atol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s", [16, 40, 192, 256, 512])
@pytest.mark.parametrize("b", [1, 7, 256])
def test_kernel_matches_plain_bge_large_heads(cuda, b, s):
    """bge-large's heads (nh 16, hd 64) with ragged masks; for B > 1 the
    last sequence has every key masked (a padding passage)."""
    masked = (b - 1,) if b > 1 else ()
    q, k, v, bias = _case(cuda, b, s, 16, 64, torch.bfloat16, b * 1000 + s,
                          masked)
    got = _check_close(q, k, v, bias)
    if masked:  # uniform weights: the mean of the sequence's values
        want = v[-1].float().mean(dim=0).reshape(-1)
        atol = 4 * UNIT_ROUNDOFF[q.dtype] * float(v.abs().max())
        assert float((got[-1].float() - want).abs().max()) <= atol


@pytest.mark.cuda
def test_kernel_fully_masked_single_sequence(cuda):
    q, k, v, bias = _case(cuda, 1, 40, 16, 64, torch.bfloat16, 7, (0,))
    _check_close(q, k, v, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,s", [(16, 100), (32, 192), (128, 192),
                                  (128, 512)])
def test_kernel_matches_plain_head_sizes(cuda, hd, s):
    """The presets' other head sizes (tiny 16, small 32) and hd 128 with K
    and V resident (S 192) and streamed (S 512)."""
    nh = 1024 // hd
    assert ba.kv_resident(s, hd) == (hd <= 64 or s <= 384)
    q, k, v, bias = _case(cuda, 5, s, nh, hd, torch.bfloat16, hd + s, (4,))
    _check_close(q, k, v, bias)


@pytest.mark.cuda
def test_kernel_matches_plain_fp16(cuda):
    q, k, v, bias = _case(cuda, 7, 192, 16, 64, torch.float16, 16, (6,))
    _check_close(q, k, v, bias)


@pytest.mark.cuda
def test_kernel_takes_sharp_logits(cuda):
    """Logits of tens per key (q scaled by 8): the online softmax rescales
    across chunks without overflow."""
    q, k, v, bias = _case(cuda, 7, 256, 16, 64, torch.bfloat16, 3, (6,))
    _check_close((q.float() * 8).to(q.dtype), k, v, bias)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, bias = _case(cuda, 2, 40, 16, 64, torch.bfloat16, 1)
    before = ba.bert_attention.launches
    bad = [
        (q.float(), k.float(), v.float(), bias),      # f32 activations
        (q, k, v.to(torch.float16), bias),             # mixed dtypes
        (q.reshape(2, 40, 32, 32)[..., :24].contiguous(),) * 3 + (bias,),
        (q.transpose(1, 2).contiguous().transpose(1, 2), k, v, bias),
        (q, k, v, bias.reshape(2, 1, 40, 1)),          # another bias shape
        (q, k, v, bias.to(torch.bfloat16)),
        (q, k, v, bias.cpu()),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ba.bert_attention(*args)
    assert ba.bert_attention.launches == before


def _tower(dev, dtype):
    cfg = bert.BertConfig(vocab_size=30522, hidden=1024, layers=24,
                          heads=16, intermediate=4096, pooling="cls_norm",
                          dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    return bert.BertEncoder(cfg, device=dev, generator=g)


def _passages(dev, b, s, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(6, 30522, (b, s), generator=g, device=dev)
    lengths = torch.randint(s // 2, s + 1, (b,), generator=g, device=dev)
    lengths[0] = s
    mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None]).to(
        torch.int32)
    return ids, mask


@pytest.mark.cuda
def test_bge_large_tower_fused_matches_composed(cuda, monkeypatch):
    """The bge-large passage tower's cls_norm embeddings at bf16, fused
    against composed: 24 launches a call. Each bf16 tower lies within
    2.2e-3-2.8e-3 of an f32 tower's unit embeddings (the rebuild cell's
    sound readings), so the two lie within twice the larger: 5.6e-3."""
    enc = _tower(cuda, torch.bfloat16)
    ids, mask = _passages(cuda, 32, 192, 1)
    with torch.no_grad():
        before = ba.bert_attention.launches
        fused = enc(ids, mask)
        torch.cuda.synchronize()
        assert ba.bert_attention.launches == before + 24
        monkeypatch.setattr(
            bert, "bert_attention",
            lambda q, k, v, bias: ba._attention_plain(q, k, v, bias))
        composed = enc(ids, mask)
    err = float((fused.float() - composed.float()).abs().max())
    assert err <= 5.6e-3, err


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["grad", "dropout", "f32"])
def test_tower_takes_the_composed_path(cuda, case):
    """Under grad, with a dropout rng, or in f32 activations, the tower's
    attention is the composed code: no launch."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    cfg = bert.BertConfig(vocab_size=1000, hidden=256, layers=2, heads=4,
                          intermediate=512, pooling="cls_norm", dtype=dtype,
                          dropout=0.1 if case == "dropout" else 0.0)
    enc = bert.BertEncoder(cfg, device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    ids, mask = _passages(cuda, 4, 64, 2)
    ids = ids % 1000
    before = ba.bert_attention.launches
    if case == "grad":
        enc(ids, mask).float().sum().backward()
        assert math.isfinite(float(enc.layers[0].q_w.grad.norm()))
    else:
        with torch.no_grad():
            enc(ids, mask, rng=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    assert ba.bert_attention.launches == before
