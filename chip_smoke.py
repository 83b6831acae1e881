#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases; any failure exits non-zero:

1. build — compile every kernel of ``ray_tpu_torch/csrc`` with nvcc (one
   process per source, all at once); print the build seconds, the ptxas
   register/spill lines and warnings (a two-consumer forward or dk/dv
   instantiation must have 168 registers, the budget its setmaxnreg split
   redistributes; a dk/dv instantiation must not spill), the counts of
   TMA loads (UTMALDG), wgmma (HGMMA), mbarrier operations (SYNCS) and
   mma.sync (HMMA) in the SASS of each forward and dk/dv instantiation
   (``cuobjdump``; a dk/dv one must have the first three and no HMMA),
   and the card's name and power limit;
1b. sm90 — the Hopper primitives of ``csrc/sm90.cuh`` against torch
   (``csrc/sm90_check.cu``), at D = 32, 64 and 128: a TMA tile load of a
   strided bshd view with rows past S, an SS and an RS wgmma; exact;
2. kernels — the flash-attention forward kernel against its plain version
   (``_reference_attention``) on the card in bf16, both layouts, causal on
   and off, at GPT-2 small shapes (B in {1, 4}, H=12, D=64, S in {128,
   1000, 1024}), at D=128 (H=32, S=2048), at D=32, and at the training
   shape (B=16, S=1024, bshd); max abs errors beside their tolerances,
   each case's plan (q rows a block, ring slots), kernel / plain /
   library times (CUDA events after warm-up) and the kernel's bound; the
   host time of a launch's tensor-map encodes;
2b. backward kernels — the dq and dk/dv kernels against the plain
   backward (``_reference_attention_bwd``) on the same (o, lse, do), in
   bf16, both layouts, causal on and off, at the training shape (B=16,
   H=12, S=1024, D=64), S=1000 (ragged), D=128 (H=32, S=2048) and D=32
   (H=4, S=100); the dk/dv plan of each case (k rows a block, ring
   slots), the largest |err| / tolerance per gradient, each kernel's
   time, their bound, the plain time and the library's
   (``scaled_dot_product_attention``'s backward, timed only);
3. serve — GPT-2 124M (``GPT2_SMALL``, random weights from ``--seed``) in
   the port's ``Replica`` hosting ``Generator``: 4 requests through
   ``handle_request`` (prompts of 16, 127, 500 and 1000 tokens, 8 new
   tokens each) and one through ``handle_request_stream``; the kernel's
   launch count must equal ``n_layer`` x forwards; the first forward's
   logits with the kernel must match ``attention="dense"`` (plain);
4. train — GPT-2 124M with f32 master weights from ``--seed`` and
   ``torch.optim.AdamW(lr=3e-4, weight_decay=0.1)``, as ``bench.py``
   drives the JAX model: first the loss and gradients of every leaf at
   B=4, S=1024 with the kernels against ``attention="dense"``; then one
   warm-up step and 10 timed steps at B=16, S=1024 on one batch, whose
   losses must be finite and fall, with exactly ``n_layer`` launches of
   each kernel per step; ms per step, tokens/s, MFU and peak memory.

The last two lines are a JSON object of per-kernel numbers and the
result line ``{"ok": true, "device": {...}}``.  ``--profile`` adds
``torch.profiler`` tables of device time by kernel for a forward at
S=1024 and a train step, each with the device's idle share over the
traced calls.

Precision: TF32 is off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), and bf16 GEMMs may not
reduce in reduced precision, so f32 matmuls (the plain attention, the lm
head) run in full f32 and bf16 GEMMs accumulate in f32, as the JAX model's
``preferred_element_type=f32`` does.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
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
# backward kernels vs the plain backward, both on the card, per element:
# |g - g_plain| <= G_RTOL |g_plain| + G_PTOL * M_g.  Both round g to bf16
# (<= 2^-8 |g| each, so 2^-7 apart; G_RTOL gives ~1.3x room).  The kernels
# round p to bf16 (<= 2^-8 relative) before p^T do, so dv moves by
# <= 2^-8 M_dv with M_dv = P^T |dO|; they round p and then ds to bf16
# (<= 2^-7 relative on ds) before ds k and ds^T q, so dq and dk move by
# <= 2^-7 M with M_dq = scale |dS| |K| and M_dk = scale |dS|^T |Q|, where
# |dS| = |P (dP - delta)| of the plain backward.  Each held with 2x room.
# dP and delta are f32 sums of D bf16 products in another order on each
# side (<= D 2^-24 of their sums of |terms| apart, 2^-17 at D = 128); where
# dP - delta vanishes (a causal first row: one key, dP = delta) that noise
# is all of ds, so |dS| also carries 2^-10 P (|dO| |V|^T + rowsum|dO o|),
# 2^-16 of it after G_PTOL.
G_RTOL = 1e-2
G_PTOL = {"dq": 2.0 ** -6, "dk": 2.0 ** -6, "dv": 2.0 ** -7}
# full-width GPT-2 gradients, kernels vs dense attention (bf16 compute):
# the two attention forwards differ by ~1 bf16 ulp per layer and the
# kernels round p and ds to bf16 where the dense backward stays f32.  The
# first run on the card measured a loss difference of 4.8e-5 and a
# largest per-leaf gradient difference of 1.33e-2 (median 9.5e-3); each
# is held with ~4x room or more.
TRAIN_LOSS_TOL = 1e-3        # absolute, on a loss of ~11
TRAIN_GRAD_REL_TOL = 5e-2    # ||g - g_dense|| / ||g_dense|| per leaf


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


def attention_bound(B, H, S, D, causal, products=2, tensors=4, rows=1):
    """(least ms on an H100 SXM, "bytes" or "operations") for attention
    work of ``products`` (S, S, D) products, 2*B*H*S^2*D operations each
    (halved when causal), at the bf16 peak, against ``tensors`` bf16
    (B, S, H, D) tensors and ``rows`` f32 (B, H, S) rows moved once at the
    memory rate.  The forward: 2 products, q, k, v, o and lse."""
    flops = products * 2 * B * H * S * S * D / (2 if causal else 1)
    nbytes = tensors * B * S * H * D * 2 + rows * B * H * S * 4
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (products, bf16 tensors, f32 rows) of each backward kernel's work, and of
# the whole backward: dq recomputes s and dp and forms ds k (q, k, v, do,
# dq; lse, delta); dk/dv recomputes s and dp and forms p^T do and ds^T q
# (q, k, v, do, dk, dv; lse, delta); the backward as one function needs
# five products and q, k, v, do, dq, dk, dv.
BWD_WORK = {"dq": (3, 5, 2), "dkv": (4, 6, 2), "pair": (5, 7, 2)}

#: (B, H, S, D) of a GPT-2 124M train step at B=16, S=1024
TRAIN_SHAPE = (16, 12, 1024, 64)


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

def kernel_name(mangled):
    """``flash_fwd_kernel<64,128,3>`` from a mangled template name."""
    m = re.search(r"([a-z][a-z_]*_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(-?[0-9]+)E', m.group(2)))}>"


def sass_counts(lib, pattern):
    """{kernel: {opcode: count}} of the TMA loads (UTMALDG), wgmma
    (HGMMA), mbarrier operations (SYNCS) and mma.sync (HMMA) in the SASS
    of each kernel of ``lib`` whose name holds ``pattern`` (``cuobjdump
    --dump-sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1)) if pattern in m.group(1) else None
            if name:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", line):
                counts[name][op] += 1
    return counts


SASS_OPS = ("UTMALDG", "HGMMA", "SYNCS", "HMMA")


def phase_build():
    t0 = time.perf_counter()
    libs = build.build()
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s: "
          + ", ".join(sorted(libs)), flush=True)
    regs, spills = {}, {}
    for name, log in sorted(build.BUILD_LOG.items()):
        entry = name
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = kernel_name(m.group(1))
            elif ("registers" in line or "spill" in line
                  or "warning" in line.lower()):
                print(f"[build] {entry}: {line.split(':', 1)[-1].strip()}")
                n = re.search(r"Used (\d+) registers", line)
                if n:
                    regs[entry] = int(n.group(1))
                n = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
                if n:
                    spills[entry] = int(n.group(1)) + int(n.group(2))
    # a block of two consumer warpgroups (384 threads) must be built at 168
    # registers a thread, the budget its setmaxnreg split redistributes
    # (24 + 2 x 240 in the forward's 128-row instantiations, 40 + 2 x 232
    # in the dk/dv kernel's two-consumer ones)
    short = {k: n for k, n in regs.items()
             if re.match(r"flash_fwd_kernel<\d+,128,|"
                         r"flash_bwd_dkv_kernel<\d+,2,", k) and n != 168}
    if short:
        fail(f"two-consumer kernels not built at 168 registers: {short}")
    dkv_spills = {k: n for k, n in spills.items()
                  if k.startswith("flash_bwd_dkv_kernel<") and n}
    if dkv_spills:
        fail(f"dk/dv kernels spill (bytes): {dkv_spills}")
    for lib, pattern in (("flash_fwd", "flash_fwd_kernel"),
                         ("flash_bwd", "flash_bwd_dkv_kernel")):
        for kernel, ops in sorted(sass_counts(libs[lib], pattern).items()):
            print(f"[build] SASS {kernel}: "
                  + ", ".join(f"{op} {n}" for op, n in ops.items()),
                  flush=True)
            if pattern == "flash_bwd_dkv_kernel" and (
                    ops["HMMA"] or not all(ops[op] for op in SASS_OPS[:3])):
                fail(f"{kernel} is not the TMA/mbarrier/wgmma design: {ops}")
    print(f"[build] card: {card_line()}", flush=True)


def phase_sm90_checks(seed):
    """csrc/sm90_check.cu against torch: a TMA tile load of a strided bshd
    view with rows past S, an SS wgmma (q k^T's form) and an RS wgmma with
    an MN-major B (p v's form), at D = 32, 64 and 128.  Entries are small
    integers, so every product and sum is exact in f32 and the results
    must be equal, not close."""
    lib = build.load("sm90_check")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sm90_check_tma.argtypes = [P, P, I, I, I, I, P, I, I, I, P]
    lib.sm90_check_ss.argtypes = [P, P, P, I, P]
    lib.sm90_check_rs.argtypes = [P, P, P, I, P]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        rc = getattr(lib, fn)(*args, stream)
        if rc:
            fail(f"{fn} returned {rc}")

    def ints(*shape):
        return torch.randint(-4, 5, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.bfloat16)

    for D in (32, 64, 128):
        B, S, H, row0, h, b = 2, 1000, 12, 960, 5, 1
        _, view, _ = _qkv(B, H, S, D, "bshd", gen)  # k of a fused qkv
        tile = torch.empty((64, D), dtype=torch.bfloat16, device="cuda")
        st = (ctypes.c_int64 * 3)(*view.stride()[:3])
        call("sm90_check_tma", view.data_ptr(), tile.data_ptr(), B, S, H, D,
             st, row0, h, b)
        want = torch.zeros_like(tile)
        want[:S - row0] = view[b, row0:, h]
        a, bt = ints(64, D), ints(64, D)
        s = torch.empty((64, 64), device="cuda")
        call("sm90_check_ss", a.data_ptr(), bt.data_ptr(), s.data_ptr(), D)
        p, v = ints(64, 64), ints(64, D)
        o = torch.empty((64, D), device="cuda")
        call("sm90_check_rs", p.data_ptr(), v.data_ptr(), o.data_ptr(), D)
        torch.cuda.synchronize()
        res = {"tma": torch.equal(tile, want),
               "ss": torch.equal(s, a.float() @ bt.float().T),
               "rs": torch.equal(o, p.float() @ v.float())}
        print(f"[sm90] D={D}: TMA tile of a strided bshd view, rows "
              f"{row0}..{row0 + 63} of S={S} ({row0 + 64 - S} past S read "
              f"as zeros): "
              f"{'equal' if res['tma'] else 'DIFFERS'}; wgmma SS 64x64x{D} "
              f"vs torch.matmul f32: {'equal' if res['ss'] else 'DIFFERS'}; "
              f"wgmma RS 64x{D}x64, B MN-major: "
              f"{'equal' if res['rs'] else 'DIFFERS'} (exact: integer "
              f"entries)", flush=True)
        if not all(res.values()):
            fail(f"sm90 primitives disagree with torch at D={D}: {res}")


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
    cases = [(B, 12, S, 64, layout) for B in (1, 4) for S in (128, 1000, 1024)
             for layout in ("bshd", "bhsd")]
    cases += [(1, 32, 2048, 128, layout) for layout in ("bshd", "bhsd")]
    cases += [(2, 4, 100, 32, layout) for layout in ("bshd", "bhsd")]
    cases += [TRAIN_SHAPE + ("bshd",)]
    served = None
    worst = 0.0
    for B, H, S, D, layout in cases:
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
            plan = fa._fwd_plan(B, H, S, D, fa._sm_count(q.device))
            print(f"[kernel] B={B} H={H} S={S} D={D} {layout} "
                  f"causal={int(causal)} plan={plan.block_m} rows x "
                  f"{plan.stages} slots: o_err={o_err:.3e} "
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
                print(f"[kernel] served shape: kernel_ms={ms:.4f} "
                      f"library_ms={lib_ms:.4f} bound_ms={bound:.5f} "
                      f"({bound_by}); tensor-map encode "
                      f"{encode_us(q, k, v, layout):.3f} us of host "
                      f"time per launch (3 maps)", flush=True)
            if (B, H, S, D) == TRAIN_SHAPE:
                print(f"[kernel] training shape, causal={int(causal)}: "
                      f"kernel_ms={ms:.4f} library_ms={lib_ms:.4f} "
                      f"bound_ms={bound:.5f} ({bound_by})", flush=True)
    served["max_abs_err"] = worst
    return served


def encode_us(q, k, v, layout, iters=10000):
    """Host microseconds of the three cuTensorMapEncodeTiled calls that
    each forward launch makes (``flash_fwd_encode_us``)."""
    lib = fa._kernel("flash_fwd")
    fn = lib.flash_fwd_encode_us
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_double
    B, H, S, D, dims = fa._geometry(q, layout)
    q, k, v = (fa._kernel_ready(x) for x in (q, k, v))
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, S, D,
            fa._strides(dims, q, k, v, q), iters)
    if us < 0:
        fail("a tensor map was refused")
    return us


def bwd_magnitudes(q, k, v, o, lse, do, scale, causal):
    """(M_dq, M_dk, M_dv) of the G_PTOL bounds, (B, H, S, D) f32."""
    p = torch.exp(fa._scores(q, k, scale, causal, torch.float32)
                  - lse[..., None])
    do, v = do.float(), v.float()
    dp = do @ v.transpose(-1, -2)
    delta = (do * o.float()).sum(-1)[..., None]
    f32_sums = do.abs() @ v.abs().transpose(-1, -2) + (
        do * o.float()).abs().sum(-1)[..., None]
    ads = (p * ((dp - delta).abs() + 2.0 ** -10 * f32_sums)) * scale
    del dp, f32_sums
    m_dq = ads @ k.float().abs()
    m_dk = ads.transpose(-1, -2) @ q.float().abs()
    m_dv = p.transpose(-1, -2) @ do.float().abs()
    return m_dq, m_dk, m_dv


def phase_bwd_kernels(seed):
    """Backward kernels vs the plain backward on the card; returns the
    training-shape records of the dq and dk/dv kernels."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    train_shape = TRAIN_SHAPE
    cases = [train_shape, (1, 12, 1000, 64), (1, 32, 2048, 128),
             (1, 4, 100, 32)]
    worst = {"dq": 0.0, "dkv": 0.0}
    rec = {}
    for B, H, S, D in cases:
        for layout in ("bshd", "bhsd"):
            for causal in (True, False):
                q, k, v = _qkv(B, H, S, D, layout, gen)
                scale = D ** -0.5
                fwd = fa._flash_fwd if layout == "bhsd" else fa._flash_fwd_bshd
                o, res = fwd(q, k, v, causal, None, None, None)
                do = torch.randn(o.shape, generator=gen, device="cuda",
                                 dtype=torch.bfloat16)
                tr = (lambda t: t) if layout == "bhsd" else (  # noqa: E731
                    lambda t: t.transpose(1, 2))
                lse = res[4]
                ops = fa._bwd_operands(q, k, v, o, lse, do, layout)
                dq = fa._launch_bwd_dq(ops, causal, scale, layout)
                dk, dv = fa._launch_bwd_dkv(ops, causal, scale, layout)
                plan = fa._bwd_plan(B, H, S, D, fa._sm_count(q.device))
                qh, kh, vh, oh, doh = (tr(t) for t in (q, k, v, o, do))
                plain = lambda: fa._reference_attention_bwd(  # noqa: E731
                    qh, kh, vh, oh, lse, doh, scale, causal)
                ref = plain()
                mags = bwd_magnitudes(qh, kh, vh, oh, lse, doh, scale, causal)
                torch.cuda.synchronize()
                ratios, errs = {}, {}
                for name, g, r, m in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                         ref, mags):
                    diff = (tr(g).float() - r.float()).abs()
                    tol = G_RTOL * r.float().abs() + G_PTOL[name] * m
                    errs[name] = diff.max().item()
                    ratios[name] = (diff / tol).max().item()
                del mags
                worst["dq"] = max(worst["dq"], errs["dq"])
                worst["dkv"] = max(worst["dkv"], errs["dk"], errs["dv"])
                ok = all(r <= 1 for r in ratios.values())
                dq_ms = time_ms(lambda: fa._launch_bwd_dq(
                    ops, causal, scale, layout))
                dkv_ms = time_ms(lambda: fa._launch_bwd_dkv(
                    ops, causal, scale, layout))
                plain_ms = time_ms(plain, iters=3)
                ql, kl, vl = (t.detach().requires_grad_(True)
                              for t in (qh, kh, vh))
                ol = F.scaled_dot_product_attention(ql, kl, vl,
                                                    is_causal=causal)
                lib = {name: time_ms(lambda wrt=wrt: torch.autograd.grad(
                    ol, wrt, doh, retain_graph=True))
                    for name, wrt in (("all", (ql, kl, vl)), ("dq", (ql,)),
                                      ("dkv", (kl, vl)))}
                del ol
                bounds = {n: attention_bound(B, H, S, D, causal, *w)
                          for n, w in BWD_WORK.items()}
                print(f"[bwd] B={B} H={H} S={S} D={D} {layout} "
                      f"causal={int(causal)} dk/dv plan={plan.block_n} rows "
                      f"x {plan.stages} slots: max err/tol dq="
                      f"{ratios['dq']:.3f} dk={ratios['dk']:.3f} "
                      f"dv={ratios['dv']:.3f} (must be <= 1; max |err| dq="
                      f"{errs['dq']:.3e} dk={errs['dk']:.3e} "
                      f"dv={errs['dv']:.3e}) dq_ms={dq_ms:.4f} "
                      f"dkv_ms={dkv_ms:.4f} sum_ms={dq_ms + dkv_ms:.4f} "
                      f"bound_ms dq={bounds['dq'][0]:.4f} "
                      f"dkv={bounds['dkv'][0]:.4f} "
                      f"pair={bounds['pair'][0]:.4f} "
                      f"({bounds['pair'][1]}) plain_ms={plain_ms:.3f} "
                      f"library_ms={lib['all']:.4f}"
                      f"{'' if ok else '  <-- OUT OF TOLERANCE'}",
                      flush=True)
                if not ok:
                    fail(f"backward kernels disagree with plain at B={B} "
                         f"H={H} S={S} D={D} {layout} causal={causal}")
                if (B, H, S, D) == train_shape and layout == "bshd" \
                        and causal:
                    for n, t in (("dq", dq_ms), ("dkv", dkv_ms)):
                        rec[n] = {"ms": t, "plain_ms": plain_ms,
                                  "bound_ms": bounds[n][0],
                                  "bound_by": bounds[n][1],
                                  "library_ms": lib[n]}
                    print(f"[bwd] training shape: dq bound "
                          f"{bounds['dq'][0]:.4f} ms ({bounds['dq'][1]}), "
                          f"dk/dv bound {bounds['dkv'][0]:.4f} ms "
                          f"({bounds['dkv'][1]}); library grad wrt q "
                          f"{lib['dq']:.4f} ms, wrt k, v {lib['dkv']:.4f} ms",
                          flush=True)
    for n in rec:
        rec[n]["max_abs_err"] = worst[n]
    return rec


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

    reset_launches()
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
    with torch.inference_mode():
        for _ in range(2):
            gpt2.forward(params, x, cfg)
        torch.cuda.synchronize()
        print_profile(lambda: gpt2.forward(params, x, cfg), 15,
                      "forward S=1024 B=1", calls=3)


def device_idle_share(events):
    """1 - (time some device activity runs) / (first start to last end) of
    the traced device events: the gaps on the card's timeline."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return 1 - busy / (max(b for _, b in spans) - spans[0][0])


def print_profile(fn, rows, label, calls=1):
    """Device time by kernel of ``calls`` back-to-back calls of fn
    (torch.profiler's CUDA events), per call, and the device's idle share
    over them; returns the device ms per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # CUDA events, less the ranges that annotations (Optimizer.step, ...)
    # mark on the device timeline over kernels already counted
    def on_device(e):
        return (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    kernels = sorted(filter(on_device, prof.key_averages()),
                     key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in kernels) / calls
    idle = device_idle_share(list(filter(on_device, prof.events())))
    print(f"[profile] {label}: {total:.0f} us of device time per call in "
          f"{sum(e.count for e in kernels) // calls} kernel launches; "
          f"device idle {idle:.2%} of the trace from the first kernel of "
          f"{calls} back-to-back calls to the last; by kernel, per call:")
    for e in kernels[:rows]:
        t = e.self_device_time_total / calls
        print(f"[profile] {t:10.0f} us {100 * t / total:5.1f}% "
              f"{e.count // calls:5d} x  {e.key[:100]}")
    return total / 1e3


def reset_launches():
    fa.KERNEL_LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0


def read_launches():
    return {"flash_fwd": fa.KERNEL_LAUNCHES,
            "flash_bwd_dq": fa.BWD_DQ_LAUNCHES,
            "flash_bwd_dkv": fa.BWD_DKV_LAUNCHES}


def train_grad_check(params, batch, cfg):
    """Loss and every leaf's gradient with the kernels vs dense attention,
    at full width."""
    names, leaves = zip(*gpt2.named_leaves(params))

    def loss_and_grads(c):
        loss = gpt2.loss_fn(gpt2._cast_weights(params, c.compute_dtype),
                            batch, c)
        return loss.item(), torch.autograd.grad(loss, leaves)

    lf, gf = loss_and_grads(cfg)
    ld, gd = loss_and_grads(replace(cfg, attention="dense"))
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(gf, gd)]
    i = max(range(len(rel)), key=rel.__getitem__)
    B, S = batch["tokens"].shape
    print(f"[train] gradient check B={B} S={S - 1}: loss kernels {lf:.6f} "
          f"dense {ld:.6f} |diff| {abs(lf - ld):.3e} (tol "
          f"{TRAIN_LOSS_TOL}); largest ||g - g_dense|| / ||g_dense|| "
          f"{rel[i]:.3e} at {names[i]} (tol {TRAIN_GRAD_REL_TOL}); median "
          f"{sorted(rel)[len(rel) // 2]:.3e}", flush=True)
    if not all(map(torch.isfinite, (torch.tensor(lf), torch.tensor(ld)))):
        fail("train loss not finite")
    if abs(lf - ld) > TRAIN_LOSS_TOL or rel[i] > TRAIN_GRAD_REL_TOL:
        fail("gradients with the kernels disagree with dense attention")


def phase_train(seed, profile):
    """GPT-2 124M train steps at B=16, S=1024; returns the launches of the
    10 timed steps."""
    cfg = gpt2.GPT2_SMALL
    B, S, steps = 16, 1024, 10
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = gpt2.init_params(gen, cfg, device="cuda")
    leaves = gpt2.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    rng = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, 50257, (B, S + 1), generator=rng).to("cuda")
    batch = {"tokens": tokens}

    train_grad_check(params, {"tokens": tokens[:4]}, cfg)

    opt = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.1)
    step = gpt2.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(params, batch)["loss"].item()   # warm-up
    print(f"[train] warm-up step: loss {first:.4f} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = [step(params, batch)["loss"] for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    launches = read_launches()
    ms = start.elapsed_time(end) / steps
    losses = [first] + [x.item() for x in out]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tok_s = B * S / (ms / 1e3)
    mfu = tok_s * gpt2.count_flops_per_token(cfg, S) / PEAK_BF16_FLOPS
    print(f"[train] losses {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"[train] GPT2_SMALL B={B} S={S}: {ms:.3f} ms per step (CUDA "
          f"events over {steps} steps), {tok_s:.1f} tokens/s, MFU "
          f"{mfu:.4f} of {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, peak "
          f"memory {peak_gb:.2f} GB; card {card_line()}", flush=True)
    print(f"[train] launches in {steps} steps: {launches} (n_layer "
          f"{cfg.n_layer} x {steps} each)", flush=True)
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train losses not finite or not falling: {losses}")
    if any(n != cfg.n_layer * steps for n in launches.values()):
        fail("a train step did not launch each kernel once per layer")

    if profile:
        print_profile(lambda: step(params, batch), 30,
                      f"train step B={B} S={S}", calls=3)
    return launches


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
    phase_sm90_checks(args.seed)
    kern = phase_kernels(args.seed)
    bwd = phase_bwd_kernels(args.seed)
    serve_launches = phase_serve(args.seed, args.profile)
    train = phase_train(args.seed, args.profile)
    print(card_line())
    src = "ray_tpu/ops/flash_attention.py"
    rows = [
        ("flash_fwd", "flash_fwd.cu", f"{src}:443", [f"{src}:192"], kern,
         serve_launches + train["flash_fwd"],
         {"serve": serve_launches, "train": train["flash_fwd"]}),
        ("flash_bwd_dq", "flash_bwd.cu", f"{src}:213",
         [f"{src}:203", f"{src}:463"], bwd["dq"], train["flash_bwd_dq"],
         {"train": train["flash_bwd_dq"]}),
        ("flash_bwd_dkv", "flash_bwd.cu", f"{src}:268",
         [f"{src}:203", f"{src}:463"], bwd["dkv"], train["flash_bwd_dkv"],
         {"train": train["flash_bwd_dkv"]}),
    ]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"ray_tpu_torch/csrc/{source}", "replaces": replaces,
        "also_replaces": also, "launches": launches,
        "launches_by_path": by_path, "max_abs_err": r["max_abs_err"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, source, replaces, also, r, launches, by_path in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
