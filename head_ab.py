#!/usr/bin/env python3
"""A/B of GPT-2's tied lm head on one NVIDIA GPU: the f32 product of the
up-cast operands (the head before ``ops/lm_head.py``) against
``lm_head.tied_head``.

    python3 head_ab.py [--no-steps]

At the train cells' shapes (N = 16 x 1024 rows, vocabulary 50257, E = 768
for GPT-2 124M and 1600 for XL) it

- checks ``lm_head.split_parts`` (the Triton kernel) against its plain
  version bit for bit, and the split's error against 2^-16 of the
  cotangent;
- times with CUDA events, in turns (in order, then reversed, twice; the
  best turn is printed), the forward, each backward product and the
  split, the whole backward in each design (the parts stacked along each
  contraction in one GEMM a gradient, or ``head_grads``: each part on
  its own, dx's contraction in 1, 2 or ``HEAD_CHUNKS`` chunks), both
  heads' whole forward and backward, and the cross-entropy passes on
  contiguous logits and on a view of padded rows; each product with its
  TFLOP/s (the GEMM's own operations: both parts' products do twice the
  f32 product's), padded (``padded_vocab``) and with rows of V;
- lists the device kernels of one call of each under ``torch.profiler``;
- holds dx and dwte of each design against the f32 products: the norm
  gap before the bf16 cast, the share of elements bit-equal after it;
- unless ``--no-steps``: the gradients of every leaf of GPT-2 124M from
  both heads on one batch, then train steps (AdamW) of 124M and of XL with
  remat at B = 16, S = 1024 with each head in turns, with
  ``head_path_counts`` and the top device kernels of one step of each.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from dataclasses import replace

import torch

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.ops import lm_head

N, V = 16 * 1024, 50257
WIDTHS = {"124m": 768, "xl": 1600}
DEV = "cuda"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def f32_head(x, wte):
    """The head before ``tied_head``: both operands up-cast, one f32 GEMM
    (its backward: two more f32 GEMMs and the casts back to bf16)."""
    return torch.matmul(x.float(), wte.float().T)


def in_turns(fns, reps=10, rounds=2):
    """{name: best ms a call} over turns of ``reps`` calls each, the
    variants in order, then reversed, ``rounds`` times."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    best = {}
    names = list(fns)
    for order in (names, names[::-1]) * rounds:
        for name in order:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fns[name]()
            e.record()
            torch.cuda.synchronize()
            best[name] = min(best.get(name, 1e30), s.elapsed_time(e) / reps)
    return best


def kernels(fn, top=6):
    """[(kernel name, device ms)] of one call of ``fn``, longest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if e.device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])[:top]


def show(label, fn, ms, flop=None):
    rate = f", {flop / ms / 1e9:.1f} TFLOP/s" if flop else ""
    print(f"[{label}] {ms:.4f} ms{rate}", flush=True)
    for name, t in kernels(fn):
        print(f"    {t:9.4f} ms  {name[:110]}", flush=True)


def check_split():
    """The Triton split against the plain version, bit for bit, and the
    parts' error against 2^-16 of the cotangent."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    g = torch.randn((N, V), device=DEV, generator=gen)
    g *= torch.exp(torch.empty_like(g).uniform_(-30, 10, generator=gen))
    vp = lm_head.padded_vocab(V)
    fast = lm_head.split_parts(g, vp)
    plain = lm_head.split_parts_plain(g, vp)
    same = torch.equal(fast, plain)
    p = fast.view(N, 2, vp).float()
    err = ((g - p[:, 0, :V] - p[:, 1, :V]).abs()
           / g.abs().clamp_min(1e-37)).max().item()
    pad = p[:, :, V:].abs().max().item() if vp > V else 0.0
    print(f"[split] Triton vs plain bit-equal: {same}; max |g - hi - lo| / "
          f"|g| {err:.3e} (2^-16 = {2 ** -16:.3e}); pad max {pad}; "
          f"launches {lm_head.SPLIT_LAUNCHES}", flush=True)
    if not same or err > 2 ** -16 or pad != 0:
        sys.exit("split check failed")


def stacked_grads(g, x, wp):
    """The parts contracted at once, each gradient one GEMM over the parts
    stacked along its contraction (K = 2 vp for dx, 2 N for dwte): dx =
    [hi | lo] [wp; wp], dwte = [hi; lo]^T [x; x]."""
    vp = wp.shape[0]
    parts = lm_head.split_parts(g, vp)
    return (lm_head.mm_f32(parts, wp.repeat(2, 1)),
            lm_head.mm_f32(parts.view(-1, vp).T, x.repeat_interleave(2, 0)))


def grads(chunks):
    """``head_grads`` with ``chunks`` chunks of each contraction."""
    return lambda g, x, wp: lm_head.head_grads(g, x, wp, chunks)


def products(tag, E):
    """Each product and the split alone, the backward in each design,
    then both heads whole."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    x = torch.randn((N, E), device=DEV, generator=gen).bfloat16()
    wte = (0.02 * torch.randn((V, E), device=DEV,
                              generator=gen)).bfloat16()
    g = 1e-5 * torch.randn((N, V), device=DEV, generator=gen)
    vp = lm_head.padded_vocab(V)
    flop = 2 * N * E * V
    xf, wf = x.float(), wte.float()
    wp = lm_head.pad_rows(wte, vp)
    fwd = {
        "fwd f32 (casts + SIMT GEMM)": lambda: f32_head(x, wte),
        "fwd f32 GEMM alone": lambda: torch.matmul(xf, wf.T),
        "fwd bf16 -> f32 (N, V)": lambda: lm_head.mm_f32(x, wte.T),
        "fwd bf16 -> f32, vocabulary padded": lambda: lm_head.mm_f32(x,
                                                                     wp.T),
        "fwd pad of wte": lambda: lm_head.pad_rows(wte, vp),
    }
    parts = lm_head.split_parts(g, vp)
    hi = parts.view(N, 2, vp)[:, 0]
    c = lm_head.HEAD_CHUNKS
    wc = wp.view(c, vp // c, E)
    u = parts.view(N, 2, vp)[:, :, :V].contiguous().view(N, 2 * V)
    w2u = torch.cat([wte, wte])
    x2 = x.repeat_interleave(2, 0)
    bwd = {
        "dx f32 (g @ wte)": lambda: g @ wf,
        "dwte f32 (g^T @ x)": lambda: g.T @ xf,
        "split Triton": lambda: lm_head.split_parts(g, vp),
        "split plain torch": lambda: lm_head.split_parts_plain(g, vp),
        f"dx of hi, {c} chunks": lambda: lm_head.bmm_f32(
            hi.view(N, c, vp // c).transpose(0, 1), wc),
        "dwte of hi": lambda: lm_head.mm_f32(hi.T, x),
        "dx stacked parts, rows of 2V": lambda: lm_head.mm_f32(u, w2u),
        "dwte stacked parts, rows of V": lambda: lm_head.mm_f32(
            u.view(-1, V).T, x2),
    }
    designs = {"stacked, one GEMM a gradient": stacked_grads,
               **{f"head_grads, {k} chunk(s)": grads(k) for k in (1, 2, c)}}
    whole_bwd = {f"backward {name}": (lambda d=d: d(g, x, wp))
                 for name, d in designs.items()}
    work = {"fwd bf16 -> f32, vocabulary padded": 2 * N * E * vp,
            f"dx of hi, {c} chunks": 2 * N * E * vp,
            "dwte of hi": 2 * N * E * vp,
            "dx stacked parts, rows of 2V": 2 * flop,
            "dwte stacked parts, rows of V": 2 * flop}
    for name, d in whole_bwd.items():
        work[name] = 2 * 2 * N * E * vp  # dx and dwte over both parts
    for group in (fwd, bwd, whole_bwd):
        best = in_turns(group)
        for name, ms in best.items():
            f = None if name.startswith(("split", "fwd pad")) else \
                work.get(name, flop)
            show(f"{tag} {name}", group[name], ms, f)
    del parts, hi, u, w2u, x2
    dx0, dw0 = g @ wf, g.T @ xf
    for name, design in designs.items():
        dx1, dw1 = design(g, x, wp)
        for what, a, b in (("dx", dx1, dx0), ("dwte", dw1[:V], dw0)):
            a16, b16 = a.bfloat16().float(), b.bfloat16().float()
            apart = (a16 - b16).abs() > torch.finfo(torch.bfloat16).eps * \
                b16.abs()
            print(f"[{tag} {what}, {name}, vs f32] ||gap|| / ||f32|| "
                  f"before the bf16 cast "
                  f"{((a - b).norm() / b.norm()).item():.3e} (2^-14 = "
                  f"{2 ** -14:.3e}); after it "
                  f"{(a16 == b16).float().mean():.4%} bit-equal, "
                  f"{apart.float().mean():.4%} more than one ulp apart",
                  flush=True)
        del dx1, dw1
    del xf, wf, dx0, dw0, wp

    xr = x.detach().requires_grad_()
    wr = wte.detach().requires_grad_()

    def whole(head):
        def run():
            out = head(xr, wr)
            torch.autograd.grad(out, (xr, wr), g)
        return run

    heads = {"whole head f32": whole(f32_head),
             "whole head tied_head": whole(
                 lambda a, b: lm_head.tied_head(a, b, V))}
    for name, ms in in_turns(heads, reps=5).items():
        show(f"{tag} {name}", heads[name], ms, 3 * flop)

    targets = torch.randint(0, V, (N,), device=DEV, generator=gen)
    lc = torch.randn((N, V), device=DEV, generator=gen)
    lp = torch.empty((N, vp), device=DEV)
    lp[:, :V] = lc

    def xent(logits):
        def run():
            leaf = logits.detach().requires_grad_()
            loss = gpt2._xent_terms(leaf, targets).sum()
            loss.backward()
        return run

    passes = {"xent passes, contiguous logits": xent(lc),
              "xent passes, view of padded rows": xent(lp[:, :V])}
    for name, ms in in_turns(passes, reps=5).items():
        print(f"[{tag} {name}] {ms:.4f} ms", flush=True)


def leaf_gaps(cfg):
    """Every leaf's gradient of GPT-2 124M on one batch from both heads,
    and from the f32 head twice (the rest of the step's own spread): the
    three widest relative norm gaps."""
    import chip_smoke as cs

    params, tokens = cs.train_setup(cfg, 0, 16, 1024)
    tokens %= cfg.vocab_size
    batch = {"tokens": tokens}
    names = [n for n, _ in gpt2.named_leaves(params)]
    real = gpt2._lm_head
    out = []
    for head in (f32_head, real, f32_head):
        gpt2._lm_head = head
        try:
            loss = gpt2.loss_fn(gpt2._cast_weights(params, cfg.compute_dtype),
                                batch, cfg)
            grads = torch.autograd.grad(loss, gpt2.param_leaves(params))
        finally:
            gpt2._lm_head = real
        out.append((loss.item(), grads))
    for label, (la, ga), (lb, gb) in (("parts vs f32", out[1], out[0]),
                                      ("f32 vs f32", out[2], out[0])):
        gaps = sorted(((((a - b).norm() / b.norm()).item(), n)
                       for n, a, b in zip(names, ga, gb)), reverse=True)
        print(f"[grads 124m {label}] loss {la:.6f} vs {lb:.6f}; widest "
              f"leaf gaps " + ", ".join(f"{n} {x:.3e}" for x, n in gaps[:3]),
              flush=True)


def steps(tag, cfg, lr, n=5):
    """Train steps (AdamW) with each head in turns: ms a step (CUDA
    events), tokens/s, peak memory, ``head_path_counts`` of the timed
    steps, and the top device kernels of one step of each."""
    import chip_smoke as cs

    params, tokens = cs.train_setup(cfg, 0, 16, 1024)
    tokens %= cfg.vocab_size
    batch = {"tokens": tokens}
    step = gpt2.make_train_step(cfg, cs.adamw(params, lr))
    real = gpt2._lm_head
    heads = {"f32": f32_head, "parts": real}

    def run(name):
        gpt2._lm_head = heads[name]
        try:
            step(params, batch)
        finally:
            gpt2._lm_head = real

    for name in heads:
        run(name)
    torch.cuda.synchronize()
    best = {}
    for order in (["f32", "parts"], ["parts", "f32"]) * 2:
        for name in order:
            gpt2.head_path_counts(reset=True)
            torch.cuda.reset_peak_memory_stats()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(n):
                run(name)
            e.record()
            torch.cuda.synchronize()
            ms = s.elapsed_time(e) / n
            peak = torch.cuda.max_memory_allocated() / 1e9
            counts = gpt2.head_path_counts()
            if ms < best.get(name, (1e30,))[0]:
                best[name] = (ms, peak, counts)
    for name, (ms, peak, counts) in best.items():
        print(f"[steps {tag} {name} head] {ms:.3f} ms a step, "
              f"{16 * 1024 / ms * 1e3:.1f} tokens/s, peak {peak:.2f} GB, "
              f"head calls {counts}", flush=True)
        for kname, t in kernels(lambda: run(name), top=8):
            print(f"    {t:9.4f} ms  {kname[:110]}", flush=True)
    del params, step
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-steps", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("head_ab.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    check_split()
    for tag, E in WIDTHS.items():
        products(tag, E)
        torch.cuda.empty_cache()
    if args.no_steps:
        return
    small = replace(gpt2.GPT2_SMALL, vocab_size=V)
    leaf_gaps(small)
    torch.cuda.empty_cache()
    steps("124m", small, 3e-4)
    steps("xl remat", replace(gpt2.GPT2_XL, vocab_size=V, remat=True), 1e-4,
          n=3)


if __name__ == "__main__":
    main()
