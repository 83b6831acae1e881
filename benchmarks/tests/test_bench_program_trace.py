"""``harness/program_trace.py``: the program's regions in a traced window,
on synthetic events whose every number is known, and on a CPU profile of
a tiny train step; and ``trace.reduce_events``, which the regions must
leave as it is."""

import json
from dataclasses import replace

import numpy as np
import pytest

from benchmarks.harness import program_trace as pt
from benchmarks.harness import trace

E = pt.Event
TRAIN, AUTOGRAD, OS_THREAD = 1, 2, 999  # profiler thread ids; a CUPTI tid


def _launch(corr, linked, at):
    return E("cudaLaunchKernel", "CPU", "cuda_runtime", at, at + 1,
             OS_THREAD, corr, linked)


def _kernel(name, corr, a, b):
    return E(name, "CUDA", "kernel", a, b, 7, corr)


def _host(name, a, b, thread=TRAIN, corr=0, seq=-1, fwd=0):
    return E(name, "CPU", "cpu_op", a, b, thread, corr, 0, seq, fwd)


def _region(name, a, b):
    return E(name, "CPU", "user_annotation", a, b, TRAIN)


#: one step in a window of 1000 ns: the head's forward product (seq 5)
#: and its backward on the autograd thread, the trunk's, a gradient
#: accumulation (no forward node), the optimizer's launch from an op the
#: trace lacks, and a kernel with no launch
EVENTS = [
    _region(trace.WINDOW, 0, 1000),
    _region("data.claim", 20, 60), _region("data.block_wait", 60, 90),
    _region("train_step", 100, 900), _region("train_step.loss", 110, 400),
    _region("gpt2.trunk", 120, 250), _region("gpt2.head", 260, 390),
    _region("train_step.backward", 410, 700),
    _region("train_step.optimizer", 710, 890),
    _region("Optimizer.step#AdamW.step", 712, 880),  # not the program's
    _host("aten::mm", 130, 140, corr=30, seq=3),
    _launch(1002, 30, 131), _kernel("trunk_gemm", 1002, 150, 240),
    _host("aten::mm", 270, 280, corr=50, seq=5),
    _launch(1001, 50, 271), _kernel("head_gemm", 1001, 300, 350),
    _host(f"{pt.BACKWARD}: MmBackward0", 420, 480, AUTOGRAD, 60, 5, TRAIN),
    _host("aten::mm", 425, 470, AUTOGRAD, 61),
    _launch(1003, 61, 430), _kernel("head_gemm_bwd", 1003, 440, 520),
    _host(f"{pt.BACKWARD}: torch::autograd::AccumulateGrad", 490, 500,
          AUTOGRAD, 62),
    _launch(1004, 62, 491), _kernel("accumulate", 1004, 530, 560),
    _launch(1005, 0, 720), _kernel("adamw", 1005, 725, 800),
    _kernel("orphan", 9999, 810, 820),
    # the device-side annotations of two regions: not device work
    E("gpt2.head", "CUDA", "gpu_user_annotation", 260, 400, 7, 0),
    E("train_step", "CUDA", "kernel", 100, 900, 7, 0),
]


def _rows(rows, n):
    return {r[0]: tuple(round(x * 1e9, 6) if isinstance(x, float) else x
                        for x in r[1:n]) for r in rows}


def test_synthetic_window():
    p = pt.reduce(EVENTS, allocator={"num_device_alloc": 3})
    assert _rows(p["idle_by_region"], 3) == {
        "data.block_wait": (150.0, "data.block_wait"),
        "gpt2.head": (60.0, "train_step"),
        "train_step.loss": (90.0, "train_step"),
        "train_step.backward": (175.0, "train_step"),
        "train_step.optimizer": (10.0, "train_step"),
        pt.OUTSIDE: (180.0, pt.OUTSIDE)}
    assert _rows(p["device_by_region"], 4) == {
        "gpt2.head": (130.0, 80.0, 2), "gpt2.trunk": (90.0, 0.0, 1),
        "train_step.backward": (30.0, 30.0, 1),
        "train_step.optimizer": (75.0, 0.0, 1), pt.UNLINKED: (10.0, 0.0, 1)}
    assert _rows(p["regions"], 4) == {
        "train_step": (800.0, 40.0, 1), "train_step.loss": (290.0, 30.0, 1),
        "gpt2.trunk": (130.0, 130.0, 1), "gpt2.head": (130.0, 130.0, 1),
        "train_step.backward": (290.0, 290.0, 1),
        "train_step.optimizer": (180.0, 180.0, 1),
        "data.claim": (40.0, 40.0, 1), "data.block_wait": (30.0, 30.0, 1)}
    assert p["launch_lead_us"] == pytest.approx(5e-3)
    assert p["early_ops"] == 0
    assert p["allocator"] == {"num_device_alloc": 3}

    base = trace.reduce_events([e[:5] for e in EVENTS])
    record = {"trace": dict(base, program=p)}
    assert base["busy_s"] == pytest.approx(335e-9)
    assert pt.step_idle(record) == pytest.approx(100 * 335 / 1000)
    assert pt.lm_head_share(record) == pytest.approx(100 * 130 / 335)
    assert pt.ingest_wait_ms(record) == pytest.approx(1e3 * 70e-9)


def test_regions_clip_to_the_window():
    events = [_region(trace.WINDOW, 100, 200), _region("train_step", 0, 150),
              _region("train_step.loss", 20, 120),
              _region("train.report", 150, 400)]
    p = pt.reduce(events)
    assert _rows(p["regions"], 4) == {
        "train_step": (50.0, 30.0, 1), "train_step.loss": (20.0, 20.0, 1),
        "train.report": (50.0, 50.0, 1)}
    # no device work: one gap, whose middle (150) is where the step ends
    # and the report begins
    assert _rows(p["idle_by_region"], 3) == {
        "train.report": (100.0, "train.report")}


def test_device_clock_ahead_of_the_host():
    """A kernel stamped before its own launch: the device's timestamps run
    ahead of the host's, which ``early_ops`` counts past ``EARLY_US``."""
    events = [_region(trace.WINDOW, 0, 10 ** 6),
              _region("train_step", 0, 10 ** 6),
              _launch(1, 0, 500_000), _kernel("ahead", 1, 400_000, 410_000),
              _launch(2, 0, 600_000), _kernel("near", 2, 560_000, 570_000),
              _launch(3, 0, 700_000), _kernel("after", 3, 700_005, 710_000)]
    p = pt.reduce(events)
    assert p["launch_lead_us"] == pytest.approx(-100.0)
    assert p["early_ops"] == 1


def test_recompute_follows_to_the_first_forward():
    """Under remat a block's forward runs again inside a backward node on
    the autograd thread; the backward of that recompute's ops goes to the
    region of the node that ran it: the first forward's."""
    events = [
        _region("train_step", 0, 1000), _region("gpt2.trunk", 10, 100),
        _region("train_step.backward", 200, 900),
        _host("aten::mm", 20, 30, corr=1, seq=3),
        _host(f"{pt.BACKWARD}: CheckpointBackward", 300, 500, AUTOGRAD, 2,
              3, TRAIN),
        _host("aten::mm", 310, 320, AUTOGRAD, 3, seq=40),
        _host(f"{pt.BACKWARD}: MmBackward0", 600, 700, AUTOGRAD, 4, 40,
              AUTOGRAD),
    ]
    link = pt.Linker(events)
    assert link.thread == TRAIN
    assert link.region_of(AUTOGRAD, 315) == ("gpt2.trunk", True)
    assert link.region_of(AUTOGRAD, 650) == ("gpt2.trunk", True)
    assert link.region_of(AUTOGRAD, 550) == ("train_step.backward", False)
    assert link.region_of(TRAIN, 25) == ("gpt2.trunk", False)
    assert link.region_at(950) == "train_step"
    assert link.region_at(1000) == pt.OUTSIDE


def test_reduce_events_ignores_the_regions():
    """The existing reduction reads the same with and without the program's
    regions among the events: the host regions are not ``bench.`` spans,
    and their device-side annotations (as kineto marks them, and as a
    kernel where it gives no kind) are not device work."""
    base = [e[:5] for e in EVENTS if e.name not in pt.REGIONS]
    with_regions = [e[:5] for e in EVENTS]
    assert len(with_regions) > len(base)
    got = [json.dumps(trace.reduce_events(x), sort_keys=True)
           for x in (base, with_regions)]
    assert got[0] == got[1]
    assert trace.breakdown(trace.reduce_events(with_regions)) == \
        trace.breakdown(trace.reduce_events(base))


def test_readings_are_none_without_regions():
    base = trace.reduce_events([e[:5] for e in EVENTS])
    for record in ({"trace": None}, {"trace": base},
                   {"trace": dict(base, program=pt.reduce(
                       [e for e in EVENTS
                        if e.name not in pt.REGIONS]))}):
        assert pt.step_idle(record) is None
        assert pt.lm_head_share(record) is None
        assert pt.ingest_wait_ms(record) is None


def test_allocator_delta():
    before = {k: i for i, k in enumerate(pt.ALLOCATOR)}
    after = {k: 10 * i for i, k in enumerate(pt.ALLOCATOR)}
    assert pt.allocator_delta(before, after) == {
        k: 9 * i for i, k in enumerate(pt.ALLOCATOR)}
    assert pt.allocator_delta(None, after) is None


def test_cpu_step_links_the_heads_backward():
    """A CPU profile of a tiny train step: every program region is found,
    and the backward products of the head's nodes link to ``gpt2.head``
    through their nodes' sequence numbers."""
    import torch
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import gpt2

    cfg = replace(gpt2.GPT2_TINY, compute_dtype=torch.float32)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    leaves = gpt2.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    step = gpt2.make_train_step(cfg, torch.optim.AdamW(leaves, lr=1e-3))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)))}
    step(params, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            step(params, batch)
    events = [pt.event(e) for e in prof.profiler.kineto_results.events()]
    p = pt.reduce(events)
    step_names = {n for n in pt.REGIONS if n.startswith(("train_step",
                                                         "gpt2."))}
    assert {r[0] for r in p["regions"]} == step_names
    assert p["device_by_region"] == [] and p["launch_lead_us"] is None

    link = pt.Linker(events)
    mm = [e for e in events if e.name == "aten::mm"]
    backward = [link.region_of(e.thread, e.start) for e in mm
                if link.backward.get(e.thread) is not None
                and link.backward[e.thread].inner(e.start) is not None]
    forward = [link.region_of(e.thread, e.start) for e in mm
               if (e.thread not in link.backward
                   or link.backward[e.thread].inner(e.start) is None)]
    # the head: x @ wte.T forward; its grad wrt x and wrt wte backward
    assert backward.count(("gpt2.head", True)) == 2
    assert forward.count(("gpt2.head", False)) == 1
    assert {r for r, _ in backward} == {"gpt2.head", "gpt2.trunk"}
