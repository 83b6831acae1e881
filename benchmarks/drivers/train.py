"""Training through ``TorchTrainer``: one worker with the card runs the
benchmark's loop over a seeded ``Dataset`` shard.

Set-up: the runtime starts, the trainer brings up one worker that asks
for the chip, and the loop (``train_loop``, in the worker) draws the
weights from the seed on the card, builds AdamW and the program's
``make_train_step``, and takes the first ``follow`` steps through the same
feed and call as the window.  After the first it reads each leaf's first
gradient back from AdamW's first moment (m = (1 - beta1) g after one
step); after the last, each leaf's change from the seed's weights.  Those
steps warm every shape the window uses.

Window: from the first timed step's batch to the ``synchronize`` after
the last, ``report_every`` steps between reports (``session.report`` with
that step's loss: the loop's only host sync), ending at the first report
at or after ``seconds``.  A traced run profiles one report cycle that
starts after a third of the window.

After the window the loop reads the peak memory, then checks what the
window left: the reference's loss (float32, TF32 off) at the parameters
the window left, on the block the feed delivers next, drawn again from
the seed, against the loss that the program's step reports on it; and a
checksum of every block the window took (one reduction on the card a
step) against the blocks drawn again.  Then it frees the program's state
and runs the reference's first steps on the blocks the first steps should
have taken.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict

from benchmarks.harness import yardstick
from benchmarks.harness.result import check


def run(run) -> Dict:
    from ray_tpu_torch.data import Dataset
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    from benchmarks.harness import data, runtime

    cfg, tr = run.config, run.traffic
    B, S = int(tr["batch"]), int(tr["seq_len"])
    on_card = run.device == "cuda"
    out_path = os.path.join(run.run_dir, "worker.json")
    loop_config = {"config": cfg, "traffic": tr, "workload": run.workload,
                   "seed": run.seed, "seconds": run.seconds,
                   "trace": run.trace, "device": run.device,
                   "t_start": run.t_start, "out": out_path}
    with runtime.port_runtime(num_tpus=run.chips if on_card else 0):
        t_init = time.monotonic()
        ds = Dataset.from_read_fns(data.read_fns(
            run.seed, int(tr["blocks"]), B, S + 1, int(cfg["vocab_size"])))
        result = TorchTrainer(
            train_loop, train_loop_config=loop_config,
            scaling_config=ScalingConfig(num_workers=1, use_tpu=on_card),
            run_config=RunConfig(name="bench",
                                 storage_path=os.path.join(run.run_dir,
                                                           "results")),
            datasets={"train": ds}).fit()
        if result.error is not None:
            raise RuntimeError(f"the training worker failed: "
                               f"{result.error!r}")
    with open(out_path) as f:
        w = json.load(f)
    out = summarize(w, run)
    marks = w["marks"]
    t_torch = run.marks.get("torch", run.t_start)
    t_program = run.marks.get("program", t_torch)
    out["setup_parts"] = {
        "import_torch": t_torch - run.t_start,
        "import_program": t_program - t_torch,
        "runtime_init": t_init - t_program,
        "worker_start": marks["loop"] - t_init,
        "device": marks["device"] - marks["loop"],
        "weights": marks["weights"] - marks["device"],
        "optimizer": marks["optimizer"] - marks["weights"],
        "step_built": marks["built"] - marks["optimizer"],
        "first_step": marks["first_step"] - marks["built"],
        "next_steps": marks["first"] - marks["first_step"],
        "to_window": marks["t0"] - marks["first"],
        "after_window:final_loss": marks["final"] - marks["peak"],
        "after_window:reference": marks["reference"] - marks["freed"]}
    return out


def numbers(got: Dict, ref: Dict) -> Dict:
    """The numbers of the first steps, each (value, leaf part): the
    largest relative gap of a step's loss; the worst part's gap of the
    first gradient's norm; the worst part's gap of the change's norm over
    the parts that the reference's first gradient moves (norms by leaf
    part: ``reference.gpt2.leaf_norms``)."""
    moved = yardstick.moved_leaves(ref["grad1"])
    return {
        "loss": (yardstick.loss_gap(got["losses"], ref["losses"]), None),
        "grad": yardstick.worst_leaf_gap(got["grad1"], ref["grad1"]),
        "change": yardstick.worst_leaf_gap(got["change"], ref["change"],
                                           moved)}


def window_numbers(w: Dict, run) -> Dict:
    """The numbers of what the window left, each (value, None):
    ``final_loss``, the relative gap between the program's loss at the
    parameters the window left and the reference's; ``ingest``, how many
    of the blocks the window took (and the one after) differ from the
    blocks drawn again from the seed, by their checksums."""
    from benchmarks.harness import data

    B, S = int(run.traffic["batch"]), int(run.traffic["seq_len"])
    V = int(run.config["vocab_size"])
    want = [int(data.token_block(run.seed, w["first_block"] + i, B, S + 1,
                                 V).sum()) for i in range(len(w["sums"]))]
    final = w["final"]
    return {"final_loss": (yardstick.loss_gap([final["program"]],
                                              [final["reference"]]), None),
            "ingest": (float(sum(g != x for g, x in zip(w["sums"], want))),
                       None)}


#: the order of the compared numbers in a run's output
CHECKS = ("loss", "grad", "change", "final_loss", "ingest")


def summarize(w: Dict, run) -> Dict:
    """The driver's output from the worker's record."""
    found = dict(numbers(w["program"], w["reference"]),
                 **window_numbers(w, run))
    limits = run.workload["limits"]
    checks = [check(k, found[k][0], limits[k]) for k in CHECKS]
    win = w["window"]
    bad = sum(1 for x in w["report_losses"] if not math.isfinite(x))
    return {
        "e2e": {"train_tokens_per_s": win["tokens"] / win["seconds"],
                "setup_s": w["setup_s"]},
        "record": {"rate": win["untraced_tokens_per_s"],
                   "ingest_ms_per_step": 1e3 * win["ingest_s"]
                   / win["steps"],
                   "trace": w["trace"]},
        "attempted": win["steps"], "failed": bad * w["report_every"],
        "checks": checks,
        "device": {"platform": "gpu" if w["device_kind"] != "cpu"
                   else "cpu", "kind": w["device_kind"], "count": 1,
                   "memory_peak_bytes": w["memory_peak_bytes"]},
        "forbidden": w["forbidden"],
    }


def build(model, seed, device, marks=None):
    """The program's model and step at the configuration's widths, its
    weights the seed's: (config, leaf names, parameters, named leaves,
    AdamW, the train step).  ``marks`` gets the time the weights were
    drawn."""
    import torch

    from ray_tpu_torch.models import gpt2

    from benchmarks.harness import port
    from benchmarks.reference import gpt2 as ref

    hyper = model["assumed"]["optimizer"]
    cfg = port.model_config(model)
    weights = ref.init_weights(seed, model, device)
    if marks is not None:
        marks["weights"] = time.monotonic()
    params = port.port_params(weights, cfg.n_layer)
    named = gpt2.named_leaves(params)
    for _, leaf in named:
        leaf.requires_grad_(True)
    opt = torch.optim.AdamW([t for _, t in named], lr=hyper["lr"],
                            betas=tuple(hyper["betas"]), eps=hyper["eps"],
                            weight_decay=hyper["weight_decay"])
    if marks is not None:
        marks["optimizer"] = time.monotonic()
    return (cfg, port.leaf_names(cfg.n_layer), params, named, opt,
            gpt2.make_train_step(cfg, opt))


def first_steps(step, opt, params, named, names, batches, model, seed,
                traffic, device, warm=None, marks=None):
    """The first ``follow`` steps on ``batches``: (each step's loss, the
    first gradient's norm as AdamW got it, the change's norm after the
    last), by the reference's leaf parts (``leaf_norms``).  ``warm``, a
    tracer, profiles the last of them: the profiler's own start-up then
    happens out of the window.  ``marks`` gets the end of the first."""
    import torch

    from benchmarks.reference import gpt2 as ref

    B, S = int(traffic["batch"]), int(traffic["seq_len"])
    beta1 = float(model["assumed"]["optimizer"]["betas"][0])
    follow = int(traffic["follow"])
    losses, grad1 = [], {}
    for k in range(follow):
        b = next(batches)
        if tuple(b["tokens"].shape) != (B, S + 1):
            raise ValueError(f"a batch of {tuple(b['tokens'].shape)}")
        if warm is not None and k == follow - 1:
            warm.start()
        losses.append(step(params, {"tokens": b["tokens"]})["loss"].item())
        if warm is not None and k == follow - 1:
            warm.stop()
        if k == 0:
            if marks is not None:
                marks["first_step"] = time.monotonic()
            grad1 = ref.leaf_norms(
                (names[n], opt.state[t]["exp_avg"] / (1 - beta1)
                 if t in opt.state else torch.zeros_like(t))
                for n, t in named)
    w0 = ref.init_weights(seed, model, device)
    change = ref.leaf_norms((names[n], t.detach() - w0[names[n]])
                            for n, t in named)
    return losses, grad1, change


def train_loop(lc):
    """The loop in the training worker; writes its record to
    ``lc["out"]``."""
    import torch

    from ray_tpu_torch.train import session

    from benchmarks.harness import data, result
    from benchmarks.harness.trace import Tracer, span
    from benchmarks.reference import gpt2 as ref

    marks = {"loop": time.monotonic()}
    model, traffic, workload = lc["config"], lc["traffic"], lc["workload"]
    B, S = int(traffic["batch"]), int(traffic["seq_len"])
    every, follow = int(traffic["report_every"]), int(traffic["follow"])
    hyper = model["assumed"]["optimizer"]
    if lc["device"] == "cuda":
        from ray_tpu_torch.train.torch import get_device

        device = get_device()
        kind = torch.cuda.get_device_name(device)
    else:
        device, kind = torch.device("cpu"), "cpu"
    marks["device"] = time.monotonic()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg, names, params, named, opt, step = build(model, lc["seed"], device,
                                                 marks)
    sync()
    marks["built"] = time.monotonic()
    batches = session.get_dataset_shard("train").iter_torch_batches(
        batch_size=B, device=device.type)
    losses, grad1, change = first_steps(
        step, opt, params, named, names, batches, model, lc["seed"],
        traffic, device, Tracer() if lc["trace"] else None, marks)
    marks["first"] = time.monotonic()
    session.report({"step": follow, "loss": losses[-1]})

    # the window
    tracer = Tracer() if lc["trace"] else None
    traced, stretch = None, (0.0, 0)
    report_losses, steps, ingest_s = [], 0, 0.0
    # a checksum of each block the window takes, one reduction a step
    sums = torch.zeros(int(traffic["blocks"]), dtype=torch.int64,
                       device=device)
    sync()
    t0 = marks["t0"] = time.monotonic()
    while True:
        with span("ingest"):
            ti = time.perf_counter()
            b = next(batches, None)
            ingest_s += time.perf_counter() - ti
            if b is not None:
                torch.sum(b["tokens"].view(1, -1), dim=1,
                          out=sums[steps:steps + 1])
        if b is None:
            break
        with span("step"):
            out = step(params, {"tokens": b["tokens"]})
        steps += 1
        if steps % every:
            continue
        with span("report"):
            loss = out["loss"].item()
            session.report({"step": follow + steps, "loss": loss})
        report_losses.append(loss)
        now = time.monotonic()
        if tracer is not None and tracer.active:
            sync()
            traced = tracer.stop()
            stretch = (time.monotonic() - t_traced, steps - steps_traced)
            now = time.monotonic()
        if now - t0 >= lc["seconds"] and (tracer is None
                                          or traced is not None):
            break
        if (tracer is not None and traced is None
                and now - t0 >= lc["seconds"] / 3):
            sync()
            t_traced, steps_traced = time.monotonic(), steps
            tracer.start()
    sync()
    t_end = time.monotonic()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    marks["peak"] = time.monotonic()

    # what the window left: the program's loss at its parameters on the
    # feed's next block, against the reference's at the same parameters
    # on the same block drawn again from the seed
    V, rows = int(model["vocab_size"]), int(workload["reference_rows"])
    b = next(batches)
    torch.sum(b["tokens"].view(1, -1), dim=1, out=sums[steps:steps + 1])
    ref.set_precision()
    final_ref = ref.mean_loss(
        {names[n]: t.detach() for n, t in named},
        torch.from_numpy(data.token_block(lc["seed"], follow + steps, B,
                                          S + 1, V)).to(device),
        model, rows)
    final_program = step(params, {"tokens": b["tokens"]})["loss"].item()
    sums = sums[:steps + 1].tolist()
    marks["final"] = time.monotonic()

    # the program's state goes; the reference follows the first steps
    del params, named, opt, step, out, b, batches
    if device.type == "cuda":
        torch.cuda.empty_cache()
    marks["freed"] = time.monotonic()
    blocks = [torch.from_numpy(data.token_block(lc["seed"], i, B, S + 1, V))
              for i in range(follow)]
    reference = ref.follow_steps(lc["seed"], model, hyper, blocks, device,
                                 rows=rows)
    marks["reference"] = time.monotonic()
    seconds = t_end - t0
    record = {
        "device_kind": kind, "memory_peak_bytes": int(peak),
        "setup_s": t0 - lc["t_start"], "report_every": every,
        "marks": marks,
        "window": {"steps": steps, "tokens": steps * B * S,
                   "seconds": seconds, "ingest_s": ingest_s,
                   "untraced_tokens_per_s": (steps - stretch[1]) * B * S
                   / (seconds - stretch[0])},
        "report_losses": report_losses,
        "program": {"losses": losses, "grad1": grad1, "change": change},
        "final": {"program": final_program, "reference": final_ref},
        "sums": sums, "first_block": follow,
        "reference": reference, "trace": traced,
        "forbidden": result.forbidden_modules()}
    with open(lc["out"], "w") as f:
        json.dump(record, f)
