#!/usr/bin/env python3
"""A/B of variants of the flash-attention forward kernel on one NVIDIA GPU.

    python3 flash_fwd_ab.py [--phases] VARIANT [VARIANT ...]

A variant is ``base`` (``ray_tpu_torch/csrc/flash_fwd.cu`` as it is) or
names from PATCHES joined by ``+``, optionally with ``rows64`` (64-row
blocks at every shape).  Each variant is the kernel's source with those
text patches applied, compiled with the package's nvcc flags into its own
library under ``ray_tpu_torch/_build/ab/``.  A patch that no longer
matches the source fails the run: the patches describe the kernel as of
the PR that last measured them (PERF.md names it).

For each shape, every variant's (o, lse) is held against the plain
version at chip_smoke.py's phase-2 tolerances, then all are timed with
CUDA events in turns (in order, then reversed, twice) and the best turn
is printed beside the library's time.  ``--phases`` adds per-phase
cycle counters (``clock64``, one thread a consumer warpgroup, per tile of
its loop): waiting for the tile, q k^T started with the previous tile's
p v until s is in, the softmax, the rest of that p v with the rescale;
the counters' own atomics slow the kernel, so those runs are not timed
against the others.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs
from ray_tpu_torch.native import build
from ray_tpu_torch.ops import flash_attention as fa

SRC = os.path.join(build.CSRC_DIR, "flash_fwd.cu")
OUT = os.path.join(build.BUILD_DIR, "ab")

# name -> [(text in flash_fwd.cu, replacement)]
PATCHES = {
    # one empty-barrier arrival per consumer thread, not per warp
    "thread_arrive": [
        ("sm90::mbar_init(&empty[s], 4 * kConsumers);",
         "sm90::mbar_init(&empty[s], 128 * kConsumers);"),
        ("    __syncwarp();  // the warp's wgmma reads of the slot are done\n"
         "    if (lane == 0) sm90::mbar_arrive(&empty[it % kStages]);",
         "    sm90::mbar_arrive(&empty[it % kStages]);")],
    # the library's accurate exp2f in place of ex2.approx
    "exp2f": [
        ('  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n'
         "  return y;", "  return exp2f(x);")],
    # grid (m, H, B): a head's q blocks side by side, longest first
    "grid_m_fast": [
        ("  const int h = blockIdx.x;\n  const int b = blockIdx.y;\n"
         "  const int m_block = causal ? gridDim.z - 1 - blockIdx.z : "
         "blockIdx.z;",
         "  const int h = blockIdx.y;\n  const int b = blockIdx.z;\n"
         "  const int m_block = causal ? gridDim.x - 1 - blockIdx.x : "
         "blockIdx.x;"),
        ("  const dim3 grid(H, B, (S + kBlockM - 1) / kBlockM);",
         "  const dim3 grid((S + kBlockM - 1) / kBlockM, H, B);")],
    # five ring slots (three in the kernel)
    "stages5": [
        ("  const int want_stages = 3;", "  const int want_stages = 5;"),
        ("launch_rows<32, 3>(", "launch_rows<32, 5>("),
        ("launch_rows<64, 3>(", "launch_rows<64, 5>("),
        ("launch_rows<128, 3>(", "launch_rows<128, 5>(")],
}

# per-phase counters of a consumer's loop (tiles 1 and on): g[0] waiting
# for `full`, g[1] issuing q k^T with the previous tile's p v until s is
# in, g[2] the softmax, g[3] the rest of that p v, the rescale and the
# pack, g[4] tiles; each summed over one thread a consumer warpgroup
PHASES = [
    ("namespace {\n\nconstexpr int kBlockN",
     "__device__ unsigned long long g_phase[8];\n"
     "#define TICK(v) const long long v = clock64()\n"
     "#define ADD(i, x) atomicAdd(&g_phase[i], "
     "static_cast<unsigned long long>(x))\n"
     "namespace {\n\nconstexpr int kBlockN"),
    ("    sm90::mbar_wait(&full[it % kStages], (it / kStages) & 1);\n"
     "    fence_all();\n",
     "    const bool rec = threadIdx.x % 128 == 0;\n    TICK(p0);\n"
     "    sm90::mbar_wait(&full[it % kStages], (it / kStages) & 1);\n"
     "    TICK(p1);\n    if (rec) ADD(0, p1 - p0);\n    fence_all();\n"),
    ("    sm90::fence_regs(sc);\n    softmax(it);\n",
     "    sm90::fence_regs(sc);\n    TICK(p2);\n    if (rec) ADD(1, p2 - p1);\n"
     "    softmax(it);\n    TICK(p3);\n    if (rec) ADD(2, p3 - p2);\n"),
    ("    release(it - 1);\n    pack();\n  }",
     "    release(it - 1);\n    pack();\n    TICK(p4);\n"
     "    if (rec) { ADD(3, p4 - p3); ADD(4, 1); }\n  }"),
    ('extern "C" int flash_fwd_bf16(',
     'extern "C" int fwd_phases(unsigned long long* out) {\n'
     "  unsigned long long zero[8] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_phase, sizeof(zero));\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, "
     "sizeof(zero)));\n}\n\n"
     'extern "C" int flash_fwd_bf16('),
]

# (B, H, S, D, causal): the served and training shapes of GPT-2 124M, B=4
# (the gradient check), and D = 128
SHAPES = [(1, 12, 1024, 64, True), (1, 12, 1024, 64, False),
          (16, 12, 1024, 64, True), (16, 12, 1024, 64, False),
          (4, 12, 1024, 64, True), (1, 32, 2048, 128, True)]


def patched(path, variant, patches, phases=()):
    """The source at ``path`` with the patches of ``variant``'s names (and
    the phase counters) applied; one that does not match exactly once
    fails the run."""
    src = open(path).read()
    names = [n for n in variant.split("+") if n not in ("base", "rows64")]
    edits = [e for n in names for e in patches[n]]
    for old, new in edits + list(phases):
        if src.count(old) != 1:
            sys.exit(f"patch of {variant} does not match "
                     f"{os.path.basename(path)}: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def variant_source(variant, phases):
    return patched(SRC, variant, PATCHES, PHASES if phases else ())


def compile_variants(sources, lib_name, entry, phases):
    """{variant: source} -> {variant: loaded library with ``entry`` bound
    as in ``_SIGNATURES[lib_name]``}; one nvcc each, all started
    together, each named by its entry and variant."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for v, text in sources.items():
        tag = (f"{entry}_{v.replace('+', '_')}"
               + ("_phases" if phases else ""))
        src, lib = os.path.join(OUT, f"{tag}.cu"), os.path.join(OUT,
                                                                f"{tag}.so")
        with open(src, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o",
               lib, src]
        procs[v] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    libs = {}
    for v, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {v}:\n{log}")
        kernel = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = cs.kernel_name(m.group(1))
            elif "warning" in line.lower() or re.search(
                    r"Used \d+ registers|[1-9]\d* bytes spill", line):
                print(f"[ab] {v}: {kernel}: {line.split(':', 1)[-1].strip()}",
                      flush=True)
        libs[v] = ctypes.CDLL(lib)
        getattr(libs[v], entry).argtypes = fa._SIGNATURES[lib_name][entry]
        getattr(libs[v], entry).restype = ctypes.c_int
    return libs


def build_variants(variants, phases):
    """variant -> loaded library of the forward kernel."""
    return compile_variants({v: variant_source(v, phases) for v in variants},
                            "flash_fwd", "flash_fwd_bf16", phases)


def launcher(lib, variant, q, k, v, causal):
    """A call of ``variant``'s kernel on (q, k, v), bshd; returns (run, o,
    lse)."""
    B, H, S, D, dims = fa._geometry(q, "bshd")
    plan = fa._fwd_plan(B, H, S, D, fa._sm_count(q.device))
    rows = 64 if "rows64" in variant.split("+") else plan.block_m
    stages = 5 if "stages5" in variant.split("+") else plan.stages
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, H, S, D, fa._strides(dims, q, k, v, o),
            D ** -0.5 * fa._LOG2E, int(causal), rows, stages, plan.swizzle,
            torch.cuda.current_stream().cuda_stream)

    def run():
        rc = lib.flash_fwd_bf16(*args)
        if rc:
            sys.exit(f"{variant}: flash_fwd_bf16 returned {rc}")
    return run, o, lse


def check(o, lse, q, k, v, causal):
    """(largest |o - o_plain| / tol, largest lse error) at phase-2's
    tolerances."""
    D = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    o_ref, lse_ref = fa._reference_attention(qh, kh, vh, D ** -0.5, causal)
    o_mag, _ = fa._reference_attention(qh, kh, vh.abs(), D ** -0.5, causal)
    tol = cs.O_RTOL * o_ref.float().abs() + cs.O_PTOL * o_mag.float()
    ratio = ((o.float().transpose(1, 2) - o_ref.float()).abs() / tol).max()
    return ratio.item(), (lse - lse_ref).abs().max().item()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_fwd_ab: no CUDA device")
    cs.set_precision()
    libs = build_variants(args.variants, args.phases)
    print(f"[ab] card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    counters = (ctypes.c_ulonglong * 8)()
    for B, H, S, D, causal in SHAPES:
        q, k, v = cs._qkv(B, H, S, D, "bshd", gen)
        runs, notes = {}, {}
        for name, lib in libs.items():
            run, o, lse = launcher(lib, name, q, k, v, causal)
            run()
            torch.cuda.synchronize()
            ratio, lse_err = check(o, lse, q, k, v, causal)
            if ratio > 1 or lse_err > cs.LSE_TOL:
                sys.exit(f"{name} out of tolerance at {(B, H, S, D)}: "
                         f"o ratio {ratio:.3f}, lse {lse_err:.2e}")
            runs[name] = run
            if args.phases:
                lib.fwd_phases(counters)  # reset
                run()
                torch.cuda.synchronize()
                lib.fwd_phases(counters)
                c = list(counters)
                n = max(c[4], 1)
                notes[name] = (f" [cycles a warpgroup tile: wait "
                               f"{c[0] / n:.0f}, q·kᵀ {c[1] / n:.0f}, "
                               f"softmax {c[2] / n:.0f}, p·v rest "
                               f"{c[3] / n:.0f}]")
        times = {name: [] for name in runs}
        order = list(runs) + list(runs)[::-1]
        for _ in range(2):
            for name in order:
                times[name].append(cs.time_ms(runs[name], iters=50))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal), iters=50)
        print(f"[ab] B={B} H={H} S={S} D={D} causal={int(causal)}: library "
              f"{lib_ms:.4f} ms; " + "; ".join(
                  f"{name} {min(t):.4f} ms{notes.get(name, '')}"
                  for name, t in times.items()), flush=True)


if __name__ == "__main__":
    main()
