"""The operation, byte, roofline and idle arithmetic against shapes worked
out by hand."""

from __future__ import annotations

import pytest

from benchmark.yardstick import flops, peaks
from benchmark.yardstick.trace import Trace

TINY_LM = {"hidden_size": 8, "head_dim": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "intermediate_size": 16,
           "num_hidden_layers": 3, "vocab_size": 10}
TINY_BERT = {"hidden_size": 4, "intermediate_size": 8,
             "num_hidden_layers": 2}


def test_lm_forward_by_hand():
    # q 8x8, k 8x4, v 8x4, o 8x8, gate/up 8x16, down 16x8
    assert flops.lm_layer_params(TINY_LM) == 64 + 32 + 32 + 64 + 3 * 128
    t, lab = 5, 2
    body = 2 * 576 * t
    attn = 2 * 4 * 2 * t * (t + 1)  # QK^T and PV over the causal triangle
    head = 2 * 8 * 10 * lab
    assert flops.lm_forward_flops(TINY_LM, t, lab) == 3 * (body + attn) + head


def test_lora_train_by_hand():
    t, lab, r = 5, 2, 3
    per_tok = 3 * 2 * r * ((8 + 8) + (8 + 4) + (8 + 4) + (8 + 8) + (8 + 16)
                           + (8 + 16) + (16 + 8))  # 3 layers
    lora = 3 * per_tok * t
    assert flops.lora_forward_flops(TINY_LM, r, t) == per_tok * t
    fwd = flops.lm_forward_flops(TINY_LM, t, lab)
    attn = 3 * 2 * 4 * 2 * t * (t + 1)
    assert flops.lm_lora_train_flops(TINY_LM, r, t, lab) == \
        fwd + (fwd + attn) + lora


def test_bert_by_hand():
    t = 3
    per_layer = 2 * (4 * 16 + 2 * 32) * t + 4 * 4 * t * t
    assert flops.bert_forward_flops(TINY_BERT, t) == 2 * per_layer
    assert flops.bert_train_flops(TINY_BERT, t) == 6 * per_layer


def test_search_and_b1_by_hand():
    ops = flops.int8r_search_ops(b=2, n=10, d=4, k=3, refine=4)
    assert ops == {"int8": 2 * 2 * 2 * 10 * 4, "f32": 2 * 2 * 12 * 4}
    assert flops.int8r_search_bytes(2, 10, 4, 3, 4) == \
        10 * 4 + 40 + 2 * 12 * 8 + 32 + 48
    b1_ops, b1_bytes = flops.b1_scan_work(b=2, n=10, d=4, tile_n=4,
                                          t_per_tile=2)
    assert b1_ops == 320
    assert b1_bytes == 40 + 40 + 16 + 16 + 8 * 3 * 2 * 2


def test_the_bound_takes_the_larger_term():
    t, which = peaks.bound_s({peaks.INT8_OPS: 1979e9}, 3.35e9 / 10)
    assert t == pytest.approx(1e-3) and which == "ops"
    t, which = peaks.bound_s({peaks.INT8_OPS: 1979e6}, 3.35e9)
    assert t == pytest.approx(1e-3) and which == "bytes"


def _ev(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}


def test_busy_is_the_union_and_idle_its_complement():
    ev = [_ev("kernel", 0, 100), _ev("kernel", 50, 100, "b"),
          _ev("gpu_memcpy", 300, 100), _ev("cpu_op", 0, 1000, "op"),
          _ev("user_annotation", 160, 100, "train.step")]
    tr = Trace(ev, window_s=1e-3)
    assert tr.busy_s() == pytest.approx(250e-6)
    assert tr.idle_share() == pytest.approx(0.75)
    assert tr.kernel_s("b") == (pytest.approx(100e-6), 1)
    assert tr.idle_gaps()[0] == ["train.step", pytest.approx(150e-6)]
    assert tr.device_ops()[0][0] == "k"


def test_no_device_activity_reads_nothing():
    assert Trace([_ev("cpu_op", 0, 10)], 1.0).idle_share() is None
