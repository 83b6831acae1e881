"""A run with the timed path broken underneath must come out not correct.

Each case drives the rest of a run on the CPU at a small size (the look
for a chip is what ``main`` does, and is skipped) with a fault planted in
the program in every worker process: a ``sitecustomize`` on the workers'
import path patches ``ray_tpu_torch`` as it starts.  Faults: a step that
leaves the state unchanged; half of the batch left out, the mean over the
rest, from the first step or only once the window runs; a forward that
reads the weights as the first steps left them once the window runs (a
stale cast); a feed that repeats one block once the window runs.  The same run without a fault
comes out correct.  The small size has limits of its own, set from its
readings (the program reads ~1e-5 on the loss, ~2e-3 on the first
gradient, ~3e-4 on the change, ~1e-5 on the final loss)."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from benchmarks.harness import cell

SHIM = textwrap.dedent('''
    import os
    FAULT = os.environ.get("BENCH_FAULT_UNDER_TEST")
    if FAULT and os.environ.get("RAY_TPU_WORKER_PROFILE"):
        import torch
        from ray_tpu_torch.data import iterator
        from ray_tpu_torch.models import gpt2 as g
        train_step = g.make_train_step
        FOLLOW = 3

        def make_train_step(cfg, optimizer, *a, **k):
            step = train_step(cfg, optimizer, *a, **k)
            calls = [0]
            if FAULT == "unchanged":
                def broken(params, batch):
                    with torch.no_grad():
                        loss = g.loss_fn(g._cast_weights(
                            params, cfg.compute_dtype), batch, cfg)
                    return {"loss": loss}
                return broken
            if FAULT in ("half_batch", "late_half_batch"):
                def broken(params, batch):
                    calls[0] += 1
                    t = batch["tokens"]
                    if FAULT == "half_batch" or calls[0] > FOLLOW:
                        t = t[: len(t) // 2]
                    return step(params, {"tokens": t})
                return broken
            return step

        if FAULT == "stale_cast":
            casts, kept = [0], {}

            def cast(t, dtype):  # the program's cast, which recurses by name
                if isinstance(t, dict):
                    return {k: cast(v, dtype) for k, v in t.items()}
                if t.dtype == torch.float32 and t.dim() >= 2:
                    return t.to(dtype)
                return t

            def detached(t):
                if isinstance(t, dict):
                    return {k: detached(v) for k, v in t.items()}
                return t.detach()

            def stale(old, new):
                if isinstance(old, dict):
                    return {k: stale(old[k], new[k]) for k in old}
                return old + (new - new.detach())  # old values, new grads

            def stale_cast(params, dtype):
                fresh = cast(params, dtype)
                casts[0] += 1
                if casts[0] <= FOLLOW:
                    return fresh
                kept.setdefault("w", detached(fresh))
                return stale(kept["w"], fresh)

            g._cast_weights = stale_cast
        if FAULT == "repeat":
            claimed = iterator.StreamSplitDataIterator._claimed_blocks

            def repeated(self):
                for k, blk in enumerate(claimed(self)):
                    if k == FOLLOW:
                        kept = blk
                    yield kept if k >= FOLLOW else blk

            iterator.StreamSplitDataIterator._claimed_blocks = repeated
        g.make_train_step = make_train_step
''')

SMALL = {"n_embd": 64, "n_head": 2, "n_layer": 2, "vocab_size": 512,
         "n_positions": 128, "n_ctx": 128}
LIMITS = {"loss": 1e-4, "grad": 1e-2, "change": 1e-2, "final_loss": 1e-4,
          "ingest": 0}
RUN = textwrap.dedent('''
    import json, sys, time
    t = time.monotonic()
    sys.path.insert(0, {root!r})
    from benchmarks import run
    from benchmarks.harness import cell
    name, small, limits = {name!r}, {small!r}, {limits!r}
    r = cell.load(name, 2 ** 31 + 17, 2.0, False, "cpu", "/unused", t)
    r.config.update(small)
    r.traffic.update(batch=4, seq_len=128, blocks=256)
    r.traffic["report_every"] = 5
    r.workload.update(reference_rows=2, limits=limits)
    fields, checks, _ = run.run_cell(name, 2 ** 31 + 17, 2.0, False, "cpu",
                                     t, r.config, r.traffic, r.workload)
    ok = all(c["ok"] for c in checks) and fields["failed"] == 0
    print(json.dumps({{"correct": ok, "checks": checks}}))
''')


def _run(name, fault, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(SHIM)
    code = RUN.format(root=cell.ROOT, name=name, small=SMALL, limits=LIMITS)
    env = dict(os.environ, PYTHONPATH=str(tmp_path),
               BENCH_FAULT_UNDER_TEST=fault or "", TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


TRAIN = "gpt2-124m.train-b16-s1024"


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "late_half_batch", "stale_cast",
                                   "repeat"])
def test_fault_makes_the_run_incorrect(fault, tmp_path):
    out = _run(TRAIN, fault, tmp_path)
    assert out["correct"] == (fault is None), out["checks"]
