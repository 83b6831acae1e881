"""The benchmark's arithmetic against values worked out by hand."""

import math

import pytest
import torch

from benchmarks.harness import rooflines, trace, yardstick

GPT2 = {"n_embd": 768, "n_head": 12, "n_layer": 12, "vocab_size": 50257,
        "n_positions": 1024}
XL = {"n_embd": 1600, "n_head": 25, "n_layer": 48, "vocab_size": 50257,
      "n_positions": 1024}


def test_flops_per_token():
    # N = 12 L E^2 + V E
    assert yardstick.matmul_params(GPT2) == 84_934_656 + 38_597_376
    assert yardstick.train_flops_per_token(GPT2, 1024) == pytest.approx(
        6 * 123_532_032 + 12 * 12 * 768 * 1024)
    assert yardstick.train_flops_per_token(GPT2, 1024) / 1e6 == \
        pytest.approx(854.4, abs=0.05)
    assert yardstick.train_flops_per_token(XL, 1024) / 1e9 == \
        pytest.approx(10.27, abs=0.005)


def test_attention_bound():
    # B=16 H=12 S=1024 D=64 causal forward: 2 products of 2 B H S^2 D / 2
    # operations; q, k, v, o in bf16 and lse in f32 moved once
    t, kind = yardstick.attention_bound(16, 12, 1024, 64, True)
    flops = 2 * 2 * 16 * 12 * 1024 ** 2 * 64 / 2
    nbytes = 4 * 16 * 1024 * 12 * 64 * 2 + 16 * 12 * 1024 * 4
    assert kind == "bytes"
    assert t == pytest.approx(max(flops / 989e12, nbytes / 3.35e12))
    assert t * 1e3 == pytest.approx(0.0303, abs=5e-5)
    p, n, r = yardstick.BWD_WORK["pair"]
    t, kind = yardstick.attention_bound(16, 12, 1024, 64, True, p, n, r)
    assert kind == "operations" and t * 1e3 == pytest.approx(0.0651, abs=5e-5)


def _ev(name, dev, kind, a, b):
    return (name, dev, kind, int(a * 1e9), int(b * 1e9))


def test_idle_counts_the_gap_before_the_first_kernel():
    # window 0-10 s; kernels 2-4 and 3-6 (overlapping) and 8-9; host spans
    events = [_ev("bench.traced", "CPU", "user_annotation", 0, 10),
              _ev("bench.ingest", "CPU", "user_annotation", 0, 2),
              _ev("bench.step", "CPU", "user_annotation", 2, 7.5),
              _ev("bench.report", "CPU", "user_annotation", 7.5, 10),
              _ev("flash_fwd_kernel<64>", "CUDA", "kernel", 2, 4),
              _ev("gemm", "CUDA", "kernel", 3, 6),
              _ev("Memcpy HtoD", "CUDA", "gpu_memcpy", 8, 9),
              _ev("Optimizer.step", "CUDA", "gpu_user_annotation", 0, 10)]
    rec = trace.reduce_events(events)
    assert rec["window_s"] == pytest.approx(10)
    assert rec["busy_s"] == pytest.approx(5)  # 2-6 and 8-9
    assert rooflines.idle_share({"trace": rec}) == pytest.approx(50)
    idle = dict(rec["idle_by_host"])
    # each gap goes to the span open at its middle: 0-2 ingest, 6-8
    # (middle 7) step, 9-10 report
    assert idle == pytest.approx({"ingest": 2, "step": 2, "report": 1})
    assert trace.kernel_time(rec, "flash_fwd_kernel") == \
        pytest.approx((2, 1))
    b = trace.breakdown(rec)
    assert [x[0] for x in b["device_ops"]] == ["gemm", "flash_fwd_kernel<64>",
                                               "Memcpy HtoD"]


def test_device_annotations_are_not_busy_time():
    """torch 2.11's events carry no activity kind: a device event that
    bears a host range's name (the device-side mirror of an annotation)
    is not device work."""
    events = [_ev("bench.traced", "CPU", "user_annotation", 0, 10),
              _ev("Optimizer.step#AdamW.step", "CPU", "cpu_op", 1, 9),
              _ev("Optimizer.step#AdamW.step", "CUDA", "kernel", 1, 9),
              _ev("multi_tensor_apply_kernel", "CUDA", "kernel", 2, 3)]
    rec = trace.reduce_events(events)
    assert rec["busy_s"] == pytest.approx(1)
    assert [op[0] for op in rec["device_ops"]] == ["multi_tensor_apply_kernel"]


def test_roofline_readers():
    bound = yardstick.attention_bound(16, 12, 1024, 64, True)[0]
    rec = {"config": GPT2, "traffic": {"batch": 16, "seq_len": 1024},
           "trace": {"window_s": 1.0, "busy_s": 0.9, "idle_by_host": [],
                     "device_ops": [["void flash_fwd_kernel<64,128,3>", 0.5, 10],
                                    ["flash_bwd_dq_kernel<64>", 0.2, 4],
                                    ["flash_bwd_dkv_kernel<64>", 0.3, 4]]}}
    assert rooflines.flash_forward(rec) == pytest.approx(100 * bound * 10 / 0.5)
    p, n, r = yardstick.BWD_WORK["pair"]
    pair = yardstick.attention_bound(16, 12, 1024, 64, True, p, n, r)[0]
    assert rooflines.flash_backward(rec) == pytest.approx(100 * pair * 4 / 0.5)
    assert rooflines.idle_share(rec) == pytest.approx(10)
    assert rooflines.flash_forward({**rec, "trace": None}) is None
    rec["trace"]["device_ops"] = rec["trace"]["device_ops"][1:2]
    assert rooflines.flash_backward(rec) is None  # dk/dv missing: no reading
    assert rooflines.flash_forward(rec) is None


def test_correctness_numbers():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "d": 1e-9}
    got = {"a": 1.1, "b": 2.0, "c": 3.0, "d": 1e-3}
    worst, leaf = yardstick.worst_leaf_gap(got, ref)
    assert (worst, leaf) == (pytest.approx(0.25), "c")  # 1 / max(4, 1.5)
    assert yardstick.moved_leaves(ref) == ["a", "b", "c"]
    assert yardstick.worst_leaf_gap(got, ref, ["a", "b"]) == \
        (pytest.approx(0.1 / 1.5), "a")
    assert yardstick.worst_leaf_gap({}, ref)[0] == pytest.approx(1.0)
    assert yardstick.loss_gap([10.0, 11.0], [10.0, 10.0]) == \
        pytest.approx(0.1)
    assert yardstick.loss_gap([math.nan], [1.0]) == math.inf


def test_fused_bias_is_cut_into_thirds():
    from benchmarks.reference import gpt2 as ref

    bias = torch.arange(6, dtype=torch.float32)
    norms = ref.leaf_norms([("h0.attn.c_attn.b", bias),
                            ("h0.attn.c_proj.b", bias)])
    assert list(norms) == ["h0.attn.c_attn.b.q", "h0.attn.c_attn.b.k",
                           "h0.attn.c_attn.b.v", "h0.attn.c_proj.b"]
    assert norms["h0.attn.c_attn.b.k"] == pytest.approx(13 ** 0.5)
    assert norms["h0.attn.c_proj.b"] == pytest.approx(55 ** 0.5)
    # the key third's gradient is round-off: the rule leaves it out
    grad = {"h0.attn.c_attn.b.q": 1.0, "h0.attn.c_attn.b.k": 1e-9,
            "h0.attn.c_attn.b.v": 2.0, "h0.attn.c_proj.b": 3.0}
    assert "h0.attn.c_attn.b.k" not in yardstick.moved_leaves(grad)
