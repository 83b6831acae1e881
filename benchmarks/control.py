"""Readings for the limits of ``correct``: the program and the control,
each against the reference, seed by seed, at a cell's own sizes.

    python3 benchmarks/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 30] [--no-control] [--faults] [--out FILE]

The program's first steps through the window's own build and step
(``drivers/train.py``'s ``build`` and ``first_steps``) on the blocks a
run's feed delivers first, then ``--seconds`` of steps on the next blocks
(a run's window) and the loss at the parameters they left; the
reference's (float32) and the control's (the reference with every
product in float8: the precision below the configuration's bf16) of the
same.  ``--faults`` adds the readings of half a batch, of steps that
leave the state unchanged, and of a window whose forward reads the
parameters the first steps left (a stale cast).  One JSON line a seed; the run's own
benchmark never runs this.
"""

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the package is imported from the checkout's root, not from its own folder
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        not in (ROOT, os.path.join(ROOT, "benchmarks"))]


def train_readings(run, control=True, faults=False):
    import time

    import torch

    from benchmarks.drivers import train
    from benchmarks.harness import data, yardstick
    from benchmarks.reference import gpt2 as ref

    model, tr, device = run.config, run.traffic, torch.device(run.device)
    B, S, V = int(tr["batch"]), int(tr["seq_len"]), int(model["vocab_size"])
    follow, every = int(tr["follow"]), int(tr["report_every"])

    def block(i):
        return torch.from_numpy(data.token_block(run.seed, i, B, S + 1, V))

    blocks = [block(i) for i in range(follow)]
    cfg, names, params, named, opt, step = train.build(model, run.seed,
                                                       device)
    got = train.first_steps(step, opt, params, named, names,
                            iter([{"tokens": b.to(device)} for b in blocks]),
                            model, run.seed, tr, device)
    if faults:
        # the parameters the first steps left: a forward that keeps
        # reading them through the window (a stale cast) computes its loss
        # there
        w_set = {names[n]: t.detach().clone() for n, t in named}
    # the window's work: ``seconds`` of steps on the next blocks, ending at
    # a report, as a run's window ends
    k, t0 = follow, time.monotonic()
    while True:
        loss = step(params, {"tokens": block(k).to(device)})["loss"]
        k += 1
        if (k - follow) % every == 0:
            loss.item()
            if time.monotonic() - t0 >= run.seconds:
                break
    # the numbers of what it left, on the next block
    rows = int(run.workload["reference_rows"])
    ref.set_precision()
    w_end = {names[n]: t.detach() for n, t in named}
    x = block(k).to(device)
    final = {"reference": ref.mean_loss(w_end, x, model, rows)}
    if control:
        final["control"] = ref.mean_loss(w_end, x, model, rows,
                                         ref.fp8_matmul)
    if faults:
        # half of the batch left out, the mean over the rest
        final["half_batch"] = ref.mean_loss(w_end, x[: B // 2], model,
                                            rows)
        final["stale"] = ref.mean_loss(w_set, x, model, rows)
        del w_set
    final["program"] = step(params, {"tokens": x})["loss"].item()
    del params, named, opt, step, w_end
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = dict(zip(("losses", "grad1", "change"), got))
    hyper = model["assumed"]["optimizer"]
    want = ref.follow_steps(run.seed, model, hyper, blocks, device,
                            rows=rows)

    def final_gap(side):
        return (yardstick.loss_gap([final[side]],
                                         [final["reference"]]), None)

    out = {"program": dict(train.numbers(got, want),
                           final_loss=final_gap("program")),
           "window_steps": k - follow,
           "losses": {"program": got["losses"], "reference": want["losses"]},
           "final": final}
    if control:
        low = ref.follow_steps(run.seed, model, hyper, blocks, device,
                               mm=ref.fp8_matmul, rows=rows)
        out["control"] = dict(train.numbers(low, want),
                              final_loss=final_gap("control"))
        out["losses"]["control"] = low["losses"]
    if faults:
        half = ref.follow_steps(run.seed, model, hyper,
                                [b[: B // 2] for b in blocks], device,
                                rows=rows)
        out["half_batch"] = dict(train.numbers(half, want),
                                 final_loss=final_gap("half_batch"))
        out["stale"] = {"final_loss": final_gap("stale")}
        # steps that leave the state unchanged: every loss at the seed's
        # weights, the first gradient as computed, no change
        w0 = ref.init_weights(run.seed, model, device)
        same = {"losses": [ref.mean_loss(w0, b.to(device), model, rows)
                           for b in blocks],
                "grad1": want["grad1"],
                "change": dict.fromkeys(want["change"], 0.0)}
        out["unchanged"] = train.numbers(same, want)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--seconds", type=float, default=30.0,
                   help="the window's length: steps before the final loss")
    p.add_argument("--faults", action="store_true",
                   help="the readings of half a batch and of steps that "
                   "leave the state unchanged")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import time

    from benchmarks.harness import bytecode, cell

    bytecode.keep_in(ROOT)

    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        with tempfile.TemporaryDirectory() as run_dir:
            run = cell.load(args.workload, seed, args.seconds, False,
                            "cuda", run_dir, t)
            line = dict(cell=args.workload, seed=seed,
                        **train_readings(run, control=not args.no_control,
                                         faults=args.faults),
                        seconds=time.monotonic() - t)
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")


if __name__ == "__main__":
    main()
