"""The port's program regions (``ray_tpu_torch.util.tracing.region``) on
the CPU: the train step's phases, GPT-2's trunk and head, Data's ingest and
Train's report each land in torch's profiler as named, nested as named; off,
a region is the shared no-op and the module never loads torch; under a
runtime trace context a region's exported span starts where the profiler's
event starts."""

import json
import os
import subprocess
import sys
import threading
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.util import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_PHASES = ("train_step.cast", "train_step.loss", "train_step.backward",
               "train_step.grad_sum", "train_step.optimizer",
               "train_step.zero_grad")


def _regions(prof, names):
    """(name, start ns, end ns) of the host events named in ``names``."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() in names
            and str(e.device_type()).endswith("CPU")]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _tiny_step():
    cfg = replace(gpt2.GPT2_TINY, compute_dtype=torch.float32)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    leaves = gpt2.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-3)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)))
    return cfg, params, gpt2.make_train_step(cfg, opt), {"tokens": tokens}


def test_train_step_regions_nest_as_named():
    cfg, params, step, batch = _tiny_step()
    step(params, batch)  # the optimizer's state exists before the profile
    names = {"train_step", "gpt2.trunk", "gpt2.head", *STEP_PHASES}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss = step(params, batch)["loss"]
    assert torch.isfinite(loss)
    found = _regions(prof, names)
    assert sorted(n for n, *_ in found) == sorted(names)
    at = {n: (n, a, b) for n, a, b in found}
    for phase in STEP_PHASES:
        assert _inside(at[phase], at["train_step"]), phase
    for part in ("gpt2.trunk", "gpt2.head"):
        assert _inside(at[part], at["train_step.loss"]), part
    order = sorted(STEP_PHASES, key=lambda n: at[n][1])
    assert tuple(order) == STEP_PHASES
    assert at["gpt2.trunk"][2] <= at["gpt2.head"][1]


@pytest.mark.parametrize("xent_chunks", [0, 4])
def test_loss_head_region_covers_both_heads(xent_chunks):
    """``gpt2.head`` holds the head and its cross-entropy terms, by the
    dense path and by ``_chunked_xent``; ``forward`` (serving) has the
    same two regions."""
    cfg, params, _, batch = _tiny_step()
    weights = gpt2._cast_weights(params, cfg.compute_dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            gpt2.loss_fn(weights, batch, cfg, xent_chunks=xent_chunks)
            gpt2.forward(weights, batch["tokens"][:, :-1], cfg)
    found = _regions(prof, {"gpt2.trunk", "gpt2.head"})
    assert sorted(n for n, *_ in found) == ["gpt2.head"] * 2 + \
        ["gpt2.trunk"] * 2
    mm = [(e.name(), e.start_ns()) for e in
          prof.profiler.kineto_results.events()
          if e.name() in ("aten::mm", "aten::matmul")]
    heads = [r for r in found if r[0] == "gpt2.head"]
    # the lm head's product runs inside each head region
    assert all(any(a <= t <= b for _, t in mm) for _, a, b in heads)


@pytest.fixture(scope="module")
def port_runtime():
    """One port runtime for the module, under a session root of its own."""
    import shutil

    from test_torch_runtime_parity import assert_port_left_nothing

    import ray_tpu_torch
    from ray_tpu_torch.session_root import new_session_root

    config = ray_tpu_torch.config
    default, config.temp_dir = config.temp_dir, new_session_root()
    try:
        ray_tpu_torch.init(num_cpus=2)
        yield ray_tpu_torch
        ray_tpu_torch.shutdown()
        assert_port_left_nothing([os.getpid()])
    finally:
        shutil.rmtree(config.temp_dir, ignore_errors=True)
        config.temp_dir = default


def test_ingest_regions(port_runtime):
    """A streaming-split shard read through ``iter_torch_batches`` on the
    CPU: each block's claim and wait, and each batch's staging."""
    from ray_tpu_torch import data

    shard = data.range(64, parallelism=4).streaming_split(1)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batches = list(shard.iter_torch_batches(batch_size=16,
                                                device="cpu"))
    assert [b["id"].tolist() for b in batches] == [
        list(range(i, i + 16)) for i in range(0, 64, 16)]
    found = _regions(prof, {"data.claim", "data.block_wait", "data.stage"})
    count = {n: sum(1 for f in found if f[0] == n) for n, *_ in found}
    # two claims before the first block (prefetch depth 2), then one a
    # block: the last two find the epoch drained
    assert count == {"data.claim": 6, "data.block_wait": 4,
                     "data.stage": 4}


def test_report_regions():
    """``session.report`` is ``train.report``, its lockstep wait for the
    trainer's ``get_next`` ``train.report_wait`` inside it."""
    from ray_tpu_torch.train import session

    s = session._TrainSession(lambda: None, None, session.TrainContext(),
                              None)
    got = []
    trainer = threading.Thread(target=lambda: got.append(s.get_next()))
    session._init_session(s)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            trainer.start()
            session.report({"loss": 1.5})
        trainer.join(timeout=30)
    finally:
        session._shutdown_session()
    assert not trainer.is_alive()
    assert got == [(session.REPORT, ({"loss": 1.5}, None))]
    found = _regions(prof, {"train.report", "train.report_wait"})
    assert sorted(n for n, *_ in found) == ["train.report",
                                            "train.report_wait"]
    at = {n: (n, a, b) for n, a, b in found}
    assert _inside(at["train.report_wait"], at["train.report"])


def test_region_off_is_the_null_span():
    assert not tracing.tracing_enabled()
    assert tracing.region("train_step") is tracing._NULL_SPAN
    assert tracing.region("data.claim", block=3) is tracing._NULL_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.region("train_step") is not tracing._NULL_SPAN
    assert tracing.region("train_step") is tracing._NULL_SPAN


def _python(code, env=None):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, **(env or {})))
    assert p.returncode == 0, p.stderr[-4000:]
    return p.stdout


def test_tracing_module_loads_no_torch():
    """The raylet and the GCS import the module and never load torch."""
    out = _python("import sys, ray_tpu_torch.util.tracing as t; "
                  "print('torch' in sys.modules, callable(t.region))")
    assert out.split() == ["False", "True"]


def test_region_span_shares_the_profilers_clock(tmp_path):
    """Tracing on: with no trace context a region exports nothing (it is
    the null span while the profiler is off); under a context it exports a
    child span, and with the profiler on it is also a kineto event that
    starts within 1 ms of the span's ``start_us``."""
    code = f"""
import json
import torch
from torch.profiler import ProfilerActivity, profile
from ray_tpu_torch.util import tracing

tracing.enable_tracing({str(tmp_path)!r})
assert tracing.region("data.claim") is tracing._NULL_SPAN
with tracing.span("root") as root:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.region("train_step", step=7):
            torch.ones(64, 64).sum()
events = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "train_step"]
spans = [s for s in tracing.read_spans() if s["name"] == "train_step"]
print(json.dumps({{"kineto_ns": [e.start_ns() for e in events],
                   "spans": spans, "root": root.span_id}}))
"""
    out = json.loads(_python(code, env={"RAY_TPU_TRACE": "1"}).splitlines()
                     [-1])
    assert len(out["kineto_ns"]) == 1 and len(out["spans"]) == 1
    s = out["spans"][0]
    assert s["parent_id"] == out["root"]
    assert s["attributes"] == {"step": 7}
    assert abs(s["start_us"] - out["kineto_ns"][0] / 1e3) < 1e3
