#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases; any failure exits non-zero:

1. build — compile every kernel of ``ray_tpu_torch/csrc`` with nvcc (one
   process per source, all at once); print the build seconds, the ptxas
   register/spill lines, and the card's name and power limit;
2. kernels — the flash-attention forward kernel against its plain version
   (``_reference_attention``) on the card in bf16, both layouts, causal on
   and off, at GPT-2 small shapes (B in {1, 4}, H=12, D=64, S in {128,
   1000, 1024}), at D=128 (H=32, S=2048) and at D=32; max abs errors
   beside their tolerances, kernel / plain / library times (CUDA events
   after warm-up) and the kernel's bound;
3. serve — GPT-2 124M (``GPT2_SMALL``, random weights from ``--seed``) in
   the port's ``Replica`` hosting ``Generator``: 4 requests through
   ``handle_request`` (prompts of 16, 127, 500 and 1000 tokens, 8 new
   tokens each) and one through ``handle_request_stream``; the kernel's
   launch count must equal ``n_layer`` x forwards; the first forward's
   logits with the kernel must match ``attention="dense"`` (plain).

The last two lines are a JSON object of per-kernel numbers and the
result line ``{"ok": true, "device": {...}}``.  ``--profile`` adds a
``torch.profiler`` table of device time by kernel for one forward at
S=1024.

Precision: TF32 is off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), and bf16 GEMMs may not
reduce in reduced precision, so f32 matmuls (the plain attention, the lm
head) run in full f32 and bf16 GEMMs accumulate in f32, as the JAX model's
``preferred_element_type=f32`` does.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import replace

import torch
import torch.nn.functional as F

from ray_tpu_torch.models import gpt2
from ray_tpu_torch.native import build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.serve import Replica

# H100 SXM, dense, at the full 700 W limit (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain, both on the card in bf16.  o: both round o to bf16
# (<= 2^-8 |o| apart), and the kernel rounds p to bf16 before p@v, which
# moves o by <= 2^-9 P@|v| (P@|v|, the plain attention over |v|, exceeds
# |o| where a row's terms cancel); each is held with 2x room, per element:
# |o - o_plain| <= O_RTOL |o_plain| + O_PTOL P@|v|.
O_RTOL = 1e-2
O_PTOL = 2.0 ** -8
# lse: both compute it in f32 from exact bf16 products; only the order of
# the sums and exp2 vs exp differ (~1e-6 relative on |lse| <= ~10).
LSE_TOL = 1e-3
# logits of the 124M model, kernel vs dense attention, bf16 activations:
# the two attention outputs differ by ~1 bf16 ulp per layer and the
# difference passes through 12 bf16 layers and a 768-wide head; logits
# have std ~0.5 at this init, so 0.1 is ~3% of the largest logits.
LOGITS_TOL = 0.1


def set_precision():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Generator:
    """Greedy next-token generator over GPT-2 with no KV cache — port of
    the deployment in ``examples/serve_llm.py``: each token is one full
    ``forward`` over the sequence so far."""

    def __init__(self, cfg_name: str = "small", device: str = "cuda",
                 seed: int = 0):
        if torch.device(device).type == "cuda":
            set_precision()
        self.cfg = getattr(gpt2, f"GPT2_{cfg_name.upper()}")
        self.device = device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = gpt2.init_params(gen, self.cfg, device=device)
        self.forwards = 0

    @torch.inference_mode()
    def _next_token(self, tokens):
        x = torch.tensor([tokens], dtype=torch.long, device=self.device)
        logits = gpt2.forward(self.params, x, self.cfg)
        self.forwards += 1
        return int(logits[0, -1].argmax())

    def __call__(self, request):
        tokens = list((request or {}).get("prompt", [1]))
        for _ in range(int((request or {}).get("max_tokens", 8))):
            tokens.append(self._next_token(tokens))
        return {"tokens": tokens}

    def stream(self, request):
        tokens = list((request or {}).get("prompt", [1]))
        for _ in range(int((request or {}).get("max_tokens", 8))):
            tokens.append(self._next_token(tokens))
            yield {"token": tokens[-1]}


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(fn, iters=20, warmup=3, hold_ms=25):
    """Mean time of fn() over iters calls (CUDA events).  With hold_ms > 0,
    a spin kernel of about that length, queued first, holds the stream
    while the host enqueues the calls, so the events time the device and
    not the host's launch rate; hold_ms=0 times what a caller waits."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_ms:
        torch.cuda._sleep(int(hold_ms * 2e6))  # cycles, at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, H, S, D, causal):
    """(least ms on an H100 SXM, "bytes" or "operations"): 4*B*H*S^2*D
    operations (halved when causal) at the bf16 peak; q, k, v, o (bf16)
    and lse (f32) moved once at the memory rate."""
    flops = 4 * B * H * S * S * D / (2 if causal else 1)
    nbytes = 4 * B * S * H * D * 2 + B * H * S * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(sorted(libs)), flush=True)
    for name, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] card: {card_line()}", flush=True)


def _qkv(B, H, S, D, layout, gen):
    """bf16 q, k, v on the card; bshd ones are strided views of one fused
    (B, S, 3*H*D) tensor, as the model's qkv projection gives them."""
    if layout == "bhsd":
        return tuple(torch.randn((B, H, S, D), generator=gen, device="cuda",
                                 dtype=torch.bfloat16) for _ in range(3))
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    return tuple(t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))


def phase_kernels(seed):
    """Kernel vs plain on the card; returns the served-shape record."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(B, 12, S, 64) for B in (1, 4) for S in (128, 1000, 1024)]
    cases += [(1, 32, 2048, 128), (2, 4, 100, 32)]
    served = None
    worst = 0.0
    for B, H, S, D in cases:
        for layout in ("bshd", "bhsd"):
            for causal in (True, False):
                q, k, v = _qkv(B, H, S, D, layout, gen)
                if layout == "bhsd":
                    run = lambda: fa._flash_fwd(  # noqa: E731
                        q, k, v, causal, None, None, None)
                    qh, kh, vh = q, k, v
                else:
                    run = lambda: fa._flash_fwd_bshd(  # noqa: E731
                        q, k, v, causal, None, None, None)
                    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
                scale = D ** -0.5
                plain = lambda: fa._reference_attention(  # noqa: E731
                    qh, kh, vh, scale, causal)
                o, (_, _, _, _, lse) = run()
                o_ref, lse_ref = plain()
                o_mag, _ = fa._reference_attention(qh, kh, vh.abs(), scale,
                                                   causal)
                if layout == "bshd":
                    o_ref, o_mag = (t.transpose(1, 2) for t in (o_ref, o_mag))
                torch.cuda.synchronize()
                diff = (o.float() - o_ref.float()).abs()
                o_tol = O_RTOL * o_ref.float().abs() + O_PTOL * o_mag.float()
                o_err = diff.max().item()
                o_ratio = (diff / o_tol).max().item()
                lse_err = (lse - lse_ref).abs().max().item()
                ok = o_ratio <= 1 and lse_err <= LSE_TOL
                worst = max(worst, o_err)
                ms = time_ms(run)
                plain_ms = time_ms(plain, iters=5)
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal))
                bound, bound_by = attention_bound(B, H, S, D, causal)
                print(f"[kernel] B={B} H={H} S={S} D={D} {layout} "
                      f"causal={int(causal)}: o_err={o_err:.3e} "
                      f"max o_err/tol={o_ratio:.3f} (tol {O_RTOL}*|o| + "
                      f"2^-8*P@|v|, must be <= 1) "
                      f"lse_err={lse_err:.3e} "
                      f"(tol {LSE_TOL}) kernel_ms={ms:.4f} "
                      f"bound_us={bound * 1e3:.3f} ({bound_by}) "
                      f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f}"
                      f"{'' if ok else '  <-- OUT OF TOLERANCE'}",
                      flush=True)
                if not ok:
                    fail(f"kernel disagrees with plain at B={B} H={H} "
                         f"S={S} D={D} {layout} causal={causal}")
                if (B, H, S, D, layout, causal) == (1, 12, 1024, 64, "bshd",
                                                    True):
                    served = {"ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bound, "bound_by": bound_by,
                              "library_ms": lib_ms}
    served["max_abs_err"] = worst
    return served


def greedy(params, cfg, prompt, n):
    tokens = list(prompt)
    with torch.inference_mode():
        for _ in range(n):
            x = torch.tensor([tokens], dtype=torch.long, device="cuda")
            tokens.append(int(gpt2.forward(params, x, cfg)[0, -1].argmax()))
    return tokens


def phase_serve(seed, profile):
    t0 = time.perf_counter()
    replica = Replica(Generator, ("small", "cuda", seed), {})
    gen_obj = replica._callable
    cfg = gen_obj.cfg
    torch.cuda.synchronize()
    print(f"[serve] GPT2_SMALL: {gpt2.num_params(gen_obj.params)} params, "
          f"replica up in {time.perf_counter() - t0:.2f} s", flush=True)

    rng = torch.Generator().manual_seed(seed)
    vocab = 50257  # GPT-2's real vocabulary; the padded rows stay reachable
    prompts = {L: torch.randint(0, vocab, (L,), generator=rng).tolist()
               for L in (16, 127, 500, 1000, 64)}

    # first forward: kernel vs plain (dense) attention
    x = torch.tensor([prompts[500]], dtype=torch.long, device="cuda")
    with torch.inference_mode():
        lk = gpt2.forward(gen_obj.params, x, cfg)
        ld = gpt2.forward(gen_obj.params, x, replace(cfg, attention="dense"))
    torch.cuda.synchronize()
    if lk.shape != (1, 500, cfg.vocab_size) or not torch.isfinite(lk).all():
        fail(f"logits malformed: {tuple(lk.shape)}")
    l_err = (lk - ld).abs().max().item()
    print(f"[serve] first forward S=500: logits kernel vs dense max abs "
          f"err {l_err:.4e} (tol {LOGITS_TOL}), |logits| max "
          f"{ld.abs().max().item():.3f}", flush=True)
    if l_err > LOGITS_TOL:
        fail("logits with the kernel disagree with dense attention")

    replica.handle_request({"prompt": prompts[16], "max_tokens": 2})  # warm

    fa.KERNEL_LAUNCHES = 0
    f0 = gen_obj.forwards
    results = {}
    for L in (16, 127, 500, 1000):
        t = time.perf_counter()
        out = replica.handle_request({"prompt": prompts[L], "max_tokens": 8})
        dt = time.perf_counter() - t
        toks = out["tokens"]
        if (len(toks) != L + 8 or toks[:L] != prompts[L]
                or not all(0 <= x < cfg.vocab_size for x in toks[L:])):
            fail(f"request with a {L}-token prompt returned {toks[L:]}")
        results[L] = toks
        print(f"[serve] prompt {L}: 8 tokens in {dt * 1e3:.1f} ms = "
              f"{8 / dt:.1f} tokens/s, {dt / 8 * 1e3:.3f} ms per forward "
              f"(S={L}..{L + 7}); new tokens {toks[L:]}", flush=True)
    t = time.perf_counter()
    items = list(replica.handle_request_stream(
        {"prompt": prompts[64], "max_tokens": 8}, method="stream"))
    dt = time.perf_counter() - t
    if len(items) != 8 or not all(0 <= i["token"] < cfg.vocab_size
                                  for i in items):
        fail(f"stream returned {items}")
    print(f"[serve] stream, prompt 64: 8 tokens in {dt * 1e3:.1f} ms = "
          f"{8 / dt:.1f} tokens/s", flush=True)
    launches = fa.KERNEL_LAUNCHES
    forwards = gen_obj.forwards - f0
    print(f"[serve] kernel launches {launches} = n_layer {cfg.n_layer} x "
          f"forwards {forwards}: {launches == cfg.n_layer * forwards}; "
          f"replica stats {replica.stats()}", flush=True)
    if forwards != 40 or launches != cfg.n_layer * forwards:
        fail("the served path did not run the kernel once per layer "
             "per forward")

    dense = greedy(gen_obj.params, replace(cfg, attention="dense"),
                   prompts[127], 8)
    print(f"[serve] greedy tokens, prompt 127, kernel vs dense: "
          f"{'agree' if dense == results[127] else 'differ'} "
          f"(kernel {results[127][127:]}, dense {dense[127:]})", flush=True)

    x = torch.randint(0, vocab, (1, 1024), generator=rng).to("cuda")
    with torch.inference_mode():
        fwd = lambda: gpt2.forward(gen_obj.params, x, cfg)  # noqa: E731
        wall_ms = time_ms(fwd, iters=10, hold_ms=0)
        dev_ms = time_ms(fwd, iters=10, hold_ms=250)
    print(f"[serve] forward at S=1024, B=1: {wall_ms:.3f} ms as issued, "
          f"{dev_ms:.3f} ms of device work (CUDA events); device idle "
          f"{1 - dev_ms / wall_ms:.1%} of the issued time", flush=True)
    if profile:
        profile_forward(gen_obj.params, x, cfg)
    return launches


def profile_forward(params, x, cfg):
    from torch.profiler import ProfilerActivity, profile as tprofile

    with torch.inference_mode():
        for _ in range(2):
            gpt2.forward(params, x, cfg)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            gpt2.forward(params, x, cfg)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=15))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    set_precision()
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}",
          flush=True)
    phase_build()
    kern = phase_kernels(args.seed)
    launches = phase_serve(args.seed, args.profile)
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:443",
        "also_replaces": "ray_tpu/ops/flash_attention.py:192",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
