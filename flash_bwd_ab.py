#!/usr/bin/env python3
"""A/B of variants of the flash-attention backward kernels on one NVIDIA GPU.

    python3 flash_bwd_ab.py [--kernel dkv|dq] [--phases] VARIANT [VARIANT ...]

``--kernel`` picks the dk/dv kernel (the default) or the dq kernel of
``ray_tpu_torch/csrc/flash_bwd.cu``.  A variant is ``base`` (the source as
it is) or names from that kernel's patches (PATCHES, DQ_PATCHES) joined by
``+``, optionally with ``rows64`` (one consumer warpgroup, 64-row blocks,
at every shape).  As in ``flash_fwd_ab.py``, whose compile step this
uses, each variant is the source with those text patches applied,
compiled into its own library under ``ray_tpu_torch/_build/ab/``, and a
patch that no longer matches the source fails the run: the patches
describe the kernel as of the PR that last measured them (PERF.md names
it).

For each shape, the first variant's gradients (dk and dv, or dq) are held
against the plain backward at chip_smoke.py's phase-2b bound, and every
other variant's must equal them bit for bit: no patch changes the
arithmetic or the order of a sum.  Then all are timed with CUDA events in
turns (in order, then reversed, twice) and the best turn is printed
beside the library's time (the gradient of
``scaled_dot_product_attention`` with respect to k and v, or to q).
``--phases`` adds per-phase cycle counters (``clock64``, one thread a
consumer warpgroup, per tile of its loop).  dk/dv: waiting for the slot,
s^T issued until it is in, p^T and its packing, p^T do and dp^T issued
until dp^T is in, ds^T and its packing, dk += ds^T q issued and waited
for.  dq: waiting for the slot, s issued until it is in, p and its
packing, dp issued until it is in, ds and its packing, dq += ds k issued
and waited for.  The counters' own atomics slow the kernel, so those runs
are not timed against the others.  Every build prints ptxas's registers,
spills and warnings (wgmma serialized, for one).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import torch
import torch.nn.functional as F

import chip_smoke as cs
import flash_fwd_ab as ab
from ray_tpu_torch.native import build
from ray_tpu_torch.ops import flash_attention as fa

SRC = os.path.join(build.CSRC_DIR, "flash_bwd.cu")

# name -> [(text in flash_bwd.cu, replacement)]: the dk/dv kernel's
PATCHES = {
    # dk += ds^T q left in flight: it runs on while the warpgroup releases
    # the previous slot, waits for the next one and issues its s^T and
    # dp^T, so the tensor cores do not drain between tiles; a warpgroup
    # holds two slots
    "pipeline": [
        ("      rs(dk_acc, da, sQ);  // dk += ds^T q\n"
         "      sm90::wgmma_wait<0>();\n"
         "      sm90::fence_regs(dk_acc);\n      sm90::fence_regs(dv_acc);\n"
         "      fence_a(pa);\n      fence_a(da);\n    }\n"
         "    __syncwarp();  // the warp's wgmma and shared reads of the slot "
         "are done\n    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n  }\n",
         "      rs(dk_acc, da, sQ);  // dk += ds^T q\n    }\n"
         "    if (it > 0) {  // tile it - 1's products are done\n"
         "      __syncwarp();\n"
         "      if (lane == 0)\n"
         "        sm90::mbar_arrive(&empty[(it - 1) % kStages]);\n"
         "    }\n  }\n  sm90::wgmma_wait<0>();\n"
         "  sm90::fence_regs(dk_acc);\n  sm90::fence_regs(dv_acc);\n"
         "  fence_a(pa);\n  fence_a(da);\n  __syncwarp();\n"
         "  if (lane == 0)\n"
         "    sm90::mbar_arrive(&empty[(n_iter - 1) % kStages]);\n")],
    # dp^T issued with s^T below D = 128 (after p^T, with p^T do, in the
    # kernel)
    "dp_with_s": [
        ("      ss<D>(st, sK, sQ);\n"
         "      sm90::wgmma_wait<0>();  // s^T is in\n",
         "      ss<D>(st, sK, sQ);\n"
         "      if constexpr (D < 128) ss<D>(dpt, sV, sDo);\n"
         "      sm90::wgmma_wait<(D < 128) ? 1 : 0>();  // s^T is in\n"),
        ("      rs(dv_acc, pa, sDo);  // dv += p^T do\n"
         "      ss<D>(dpt, sV, sDo);     // dp^T = v do^T\n"
         "      sm90::wgmma_wait<0>();  // dp^T is in\n",
         "      rs(dv_acc, pa, sDo);  // dv += p^T do\n"
         "      if constexpr (D == 128) ss<D>(dpt, sV, sDo);\n"
         "      sm90::wgmma_wait<(D < 128) ? 1 : 0>();  // dp^T is in\n")],
    # dp^T issued before p^T do, and ds^T computed while p^T do runs
    "dp_first": [
        ("      rs(dv_acc, pa, sDo);  // dv += p^T do\n"
         "      ss<D>(dpt, sV, sDo);     // dp^T = v do^T\n"
         "      sm90::wgmma_wait<0>();  // dp^T is in\n",
         "      ss<D>(dpt, sV, sDo);     // dp^T = v do^T\n"
         "      rs(dv_acc, pa, sDo);  // dv += p^T do\n"
         "      sm90::wgmma_wait<1>();  // dp^T is in\n")],
    # the second consumer of a block starts its first tile once the first
    # has issued p^T do (an mbarrier after the ring's), so that one's
    # exponentials run under the other's products
    "offset": [
        ("  static constexpr int kBar = kDelta + kStages * kTile * 4;\n"
         "  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages)",
         "  static constexpr int kBar = kDelta + kStages * kTile * 4;\n"
         "  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages)"),
        ("    sm90::mbar_init(kv_full, 1);\n",
         "    sm90::mbar_init(kv_full, 1);\n"
         "    sm90::mbar_init(full + 2 * kStages, 4);\n"),
        ("    if (mt >= wg_start) {\n",
         "    if (mt >= wg_start) {\n"
         "      if (wg == 1 && mt == wg_start)\n"
         "        sm90::mbar_wait(full + 2 * kStages, 0);\n"),
        ("      ss<D>(dpt, sV, sDo);     // dp^T = v do^T\n",
         "      ss<D>(dpt, sV, sDo);     // dp^T = v do^T\n"
         "      if (wg == 0 && mt == wg_start) {\n"
         "        __syncwarp();\n"
         "        if (lane == 0) sm90::mbar_arrive(full + 2 * kStages);\n"
         "      }\n")],
    # ring depth (four slots in the kernel)
    "stages3": [("constexpr int kDkvStages = 4;",
                 "constexpr int kDkvStages = 3;")],
    "stages5": [("constexpr int kDkvStages = 4;",
                 "constexpr int kDkvStages = 5;")],
    # grid (H, B, n): all heads' longest causal blocks first, a head's k
    # blocks far apart (grid (H, n, B) in the kernel)
    "grid_hbn": [
        ("  const int b = blockIdx.z;\n  const int n0 = blockIdx.y * ",
         "  const int b = blockIdx.y;\n  const int n0 = blockIdx.z * "),
        ("  const dim3 grid(H, (S + rows - 1) / rows, B);",
         "  const dim3 grid(H, B, (S + rows - 1) / rows);")],
    # grid (n, H, B): a head's k blocks side by side, longest first only
    # within a head
    "grid_n_fast": [
        ("  const int h = blockIdx.x;\n  const int b = blockIdx.z;\n"
         "  const int n0 = blockIdx.y * ",
         "  const int h = blockIdx.y;\n  const int b = blockIdx.z;\n"
         "  const int n0 = blockIdx.x * "),
        ("  const dim3 grid(H, (S + rows - 1) / rows, B);",
         "  const dim3 grid((S + rows - 1) / rows, H, B);")],
}
STAGES = {"stages3": 3, "stages5": 5}

# the dq kernel's
DQ_PATCHES = {
    # dp = do v^T issued with s, to run through the exponentials (issued
    # once p is packed in the kernel)
    "dp_with_s": [
        ("      ss<D>(sc, sQ, sK);  // s = q k^T\n"
         "      sm90::wgmma_wait<0>();  // s is in\n",
         "      ss<D>(sc, sQ, sK);  // s = q k^T\n      ss<D>(dps, sDo, sV);\n"
         "      sm90::wgmma_wait<1>();  // s is in\n"),
        ("      pack(pa, sc);\n      sm90::wgmma_fence();\n"
         "      ss<D>(dps, sDo, sV);  // dp = do v^T\n"
         "      sm90::wgmma_wait<0>();  // dp is in\n",
         "      pack(pa, sc);\n      sm90::wgmma_wait<0>();  // dp is in\n")],
    # the mask as a select per element of every tile (as -inf before the
    # exponentials, on a masked tile only, in the kernel)
    "mask_select": [
        ("""      if (masked) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = n0 + 8 * j + 2 * t + (i & 1);
            const int row = row0 + 8 * (i >> 1);
            if (col >= S || (causal && col > row)) sc[4 * j + i] = -INFINITY;
          }
      }
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i)
        sc[i] = ex2(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);
""", """#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = n0 + 8 * j + 2 * t + (i & 1);
          const int row = row0 + 8 * (i >> 1);
          const float x = sc[4 * j + i] * scale_log2 - lse2[i >> 1];
          const bool keep = !masked || (col < S && !(causal && col > row));
          sc[4 * j + i] = keep ? ex2(x) : 0.f;
        }
      }
""")],
    # ring depth (four slots in the kernel)
    "stages3": [("constexpr int kDqStages = 4;",
                 "constexpr int kDqStages = 3;")],
    "stages5": [("constexpr int kDqStages = 4;",
                 "constexpr int kDqStages = 5;")],
    # grid (m, H, B): a head's q blocks side by side, longest first only
    # within a head (grid (H, m, B) in the kernel)
    "grid_m_fast": [
        ("  const int h = blockIdx.x;\n  const int b = blockIdx.z;\n"
         "  const int m_block = causal ? gridDim.y - 1 - blockIdx.y : "
         "blockIdx.y;",
         "  const int h = blockIdx.y;\n  const int b = blockIdx.z;\n"
         "  const int m_block = causal ? gridDim.x - 1 - blockIdx.x : "
         "blockIdx.x;"),
        ("  const dim3 grid(H, q_blocks, B);",
         "  const dim3 grid(q_blocks, H, B);")],
    # grid (H, B, m), the forward's: all heads' longest causal blocks first,
    # a head's q blocks far apart
    "grid_hbm": [
        ("  const int b = blockIdx.z;\n"
         "  const int m_block = causal ? gridDim.y - 1 - blockIdx.y : "
         "blockIdx.y;",
         "  const int b = blockIdx.y;\n"
         "  const int m_block = causal ? gridDim.z - 1 - blockIdx.z : "
         "blockIdx.z;"),
        ("  const dim3 grid(H, q_blocks, B);",
         "  const dim3 grid(H, B, q_blocks);")],
}

# per-phase counters of a consumer's loop (of the kernel as it is, not with
# "pipeline"): g[0] waiting for the slot, g[1] s^T issued until it is in,
# g[2] p^T, g[3] p^T do and dp^T issued until dp^T is in, g[4] ds^T, g[5]
# dk += ds^T q issued and waited for, g[6] tiles; each summed over one
# thread a warpgroup
COUNTERS = [
    ("namespace {\n\n// ----", "__device__ unsigned long long g_phase[8];\n"
     "#define TICK(v) const long long v = clock64()\n"
     "#define ADD(i, x) atomicAdd(&g_phase[i], "
     "static_cast<unsigned long long>(x))\n"
     "namespace {\n\n// ----"),
    ('extern "C" int flash_bwd_dkv_bf16(',
     'extern "C" int bwd_phases(unsigned long long* out) {\n'
     "  unsigned long long zero[8] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_phase, sizeof(zero));\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, "
     "sizeof(zero)));\n}\n\n"
     'extern "C" int flash_bwd_dkv_bf16('),
]
PHASES = COUNTERS + [
    ("    sm90::mbar_wait(&full[s], (it / kStages) & 1);\n    // a causal",
     "    const bool rec = threadIdx.x % 128 == 0;\n    TICK(p0);\n"
     "    sm90::mbar_wait(&full[s], (it / kStages) & 1);\n    TICK(p1);\n"
     "    if (rec) ADD(0, p1 - p0);\n    // a causal"),
    ("      sm90::fence_regs(st);\n\n      // p^T",
     "      sm90::fence_regs(st);\n      TICK(p2);\n"
     "      if (rec) ADD(1, p2 - p1);\n\n      // p^T"),
    ("      pack(pa, st);\n      fence_a(pa);\n",
     "      pack(pa, st);\n      fence_a(pa);\n      TICK(p3);\n"
     "      if (rec) ADD(2, p3 - p2);\n"),
    ("      sm90::fence_regs(dpt);\n\n      // ds^T",
     "      sm90::fence_regs(dpt);\n      TICK(p4);\n"
     "      if (rec) ADD(3, p4 - p3);\n\n      // ds^T"),
    ("      pack(da, dpt);\n      fence_a(da);\n",
     "      pack(da, dpt);\n      fence_a(da);\n      TICK(p5);\n"
     "      if (rec) ADD(4, p5 - p4);\n"),
    ("      rs(dk_acc, da, sQ);  // dk += ds^T q\n"
     "      sm90::wgmma_wait<0>();\n",
     "      rs(dk_acc, da, sQ);  // dk += ds^T q\n"
     "      sm90::wgmma_wait<0>();\n      TICK(p6);\n"
     "      if (rec) { ADD(5, p6 - p5); ADD(6, 1); }\n"),
]

# per-phase counters of a dq consumer's loop: g[0] waiting for the slot,
# g[1] s issued until it is in, g[2] p and its packing, g[3] dp issued
# until it is in, g[4] ds and its packing, g[5] dq += ds k issued and waited
# for, g[6] tiles; each summed over one thread a warpgroup
DQ_PHASES = COUNTERS + [
    ("    sm90::mbar_wait(&full[s], (it / kStages) & 1);\n    // a tile past",
     "    const bool rec = threadIdx.x % 128 == 0;\n    TICK(p0);\n"
     "    sm90::mbar_wait(&full[s], (it / kStages) & 1);\n    TICK(p1);\n"
     "    if (rec) ADD(0, p1 - p0);\n    // a tile past"),
    ("  // s is in\n      sm90::fence_regs(sc);\n",
     "  // s is in\n      sm90::fence_regs(sc);\n      TICK(p2);\n"
     "      if (rec) ADD(1, p2 - p1);\n"),
    ("      pack(pa, sc);\n",
     "      pack(pa, sc);\n      TICK(p3);\n      if (rec) ADD(2, p3 - p2);\n"),
    ("  // dp is in\n      sm90::fence_regs(dps);\n",
     "  // dp is in\n      sm90::fence_regs(dps);\n      TICK(p4);\n"
     "      if (rec) ADD(3, p4 - p3);\n"),
    ("      pack(da, dps);\n      fence_a(da);\n",
     "      pack(da, dps);\n      fence_a(da);\n      TICK(p5);\n"
     "      if (rec) ADD(4, p5 - p4);\n"),
    ("      rs(dq_acc, da, sK);  // dq += ds k\n      sm90::wgmma_wait<0>();\n",
     "      rs(dq_acc, da, sK);  // dq += ds k\n      sm90::wgmma_wait<0>();\n"
     "      TICK(p6);\n      if (rec) { ADD(5, p6 - p5); ADD(6, 1); }\n"),
]

# kernel -> (patches, phase counters, the names of its phases, C entry)
KERNELS = {
    "dkv": (PATCHES, PHASES, ("slot", "s", "p", "dp", "ds", "dk"),
            "flash_bwd_dkv_bf16"),
    "dq": (DQ_PATCHES, DQ_PHASES, ("slot", "s", "p", "dp", "ds", "dq"),
           "flash_bwd_dq_bf16"),
}

# (B, H, S, D, causal): the training shape of GPT-2 124M (bshd), causal and
# full; its gradient check (B=4); D = 128; one sequence (64-row blocks)
SHAPES = [(16, 12, 1024, 64, True), (16, 12, 1024, 64, False),
          (4, 12, 1024, 64, True), (1, 32, 2048, 128, True),
          (1, 12, 1000, 64, True)]


def variant_source(variant, phases, kernel="dkv"):
    patches, counters, _, _ = KERNELS[kernel]
    return ab.patched(SRC, variant, patches, counters if phases else ())


def launcher(lib, kernel, variant, ops, causal):
    """A call of ``variant``'s kernel on ``_bwd_operands``' tuple (bshd);
    returns (run, its gradients: (dk, dv) or (dq,))."""
    q, k, v, do, lse, delta = ops
    B, H, S, D, dims = fa._geometry(q, "bshd")
    sms = fa._sm_count(q.device)
    if kernel == "dkv":
        plan = fa._bwd_plan(B, H, S, D, sms)
        rows = plan.block_n
    else:
        plan = fa._dq_plan(B, H, S, D, sms)
        rows = plan.block_m
    names = variant.split("+")
    rows = 64 if "rows64" in names else rows
    stages = next((STAGES[n] for n in names if n in STAGES), plan.stages)
    grads = ((torch.empty_like(k), torch.empty_like(v)) if kernel == "dkv"
             else (torch.empty_like(q),))
    entry = KERNELS[kernel][3]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads),
            B, H, S, D, fa._strides(dims, q, k, v, do, *grads),
            D ** -0.5 * fa._LOG2E, D ** -0.5, int(causal), rows, stages,
            plan.swizzle, torch.cuda.current_stream().cuda_stream)

    def run():
        rc = getattr(lib, entry)(*args)
        if rc:
            sys.exit(f"{variant}: {entry} returned {rc}")
    return run, grads


def check(kernel, grads, q, k, v, o, lse, do, causal):
    """The largest |g - g_plain| / tol of the kernel's gradients at
    phase-2b's bound."""
    D = q.shape[-1]
    qh, kh, vh, oh, doh = (t.transpose(1, 2) for t in (q, k, v, o, do))
    refs = fa._reference_attention_bwd(qh, kh, vh, oh, lse, doh, D ** -0.5,
                                       causal)
    mags = cs.bwd_magnitudes(qh, kh, vh, oh, lse, doh, D ** -0.5, causal)
    names = ("dk", "dv") if kernel == "dkv" else ("dq",)
    ratio = 0.0
    for name, g in zip(names, grads):
        i = ("dq", "dk", "dv").index(name)
        tol = cs.G_RTOL * refs[i].float().abs() + cs.G_PTOL[name] * mags[i]
        diff = (g.transpose(1, 2).float() - refs[i].float()).abs()
        ratio = max(ratio, (diff / tol).max().item())
    return ratio


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="+")
    parser.add_argument("--kernel", choices=sorted(KERNELS), default="dkv")
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_ab: no CUDA device")
    cs.set_precision()
    kernel = args.kernel
    _, _, phase_names, entry = KERNELS[kernel]
    libs = ab.compile_variants(
        {v: variant_source(v, args.phases, kernel) for v in args.variants},
        "flash_bwd", entry, args.phases)
    print(f"[ab] card: {cs.card_line()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    counters = (ctypes.c_ulonglong * 8)()
    for B, H, S, D, causal in SHAPES:
        q, k, v = cs._qkv(B, H, S, D, "bshd", gen)
        o, (*_, lse) = fa._flash_fwd_bshd(q, k, v, causal, None, None, None)
        do = torch.randn(o.shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
        ops = fa._bwd_operands(q, k, v, o, lse, do, "bshd")
        runs, notes, first = {}, {}, None
        for name, lib in libs.items():
            run, grads = launcher(lib, kernel, name, ops, causal)
            run()
            torch.cuda.synchronize()
            if first is None:
                first = (name, grads)
                ratio = check(kernel, grads, q, k, v, o, lse, do, causal)
                if ratio > 1:
                    sys.exit(f"{name} out of tolerance at {(B, H, S, D)}: "
                             f"ratio {ratio:.3f}")
            elif not all(map(torch.equal, grads, first[1])):
                sys.exit(f"{name} differs from {first[0]} at {(B, H, S, D)}")
            runs[name] = run
            if args.phases:
                lib.bwd_phases(counters)  # reset
                run()
                torch.cuda.synchronize()
                lib.bwd_phases(counters)
                c = list(counters)
                n = max(c[6], 1)
                notes[name] = " [cycles a warpgroup tile: " + ", ".join(
                    f"{what} {c[i] / n:.0f}"
                    for i, what in enumerate(phase_names)) + "]"
        times = {name: [] for name in runs}
        order = list(runs) + list(runs)[::-1]
        for _ in range(2):
            for name in order:
                times[name].append(cs.time_ms(runs[name], iters=50))
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        wrt = (kh, vh) if kernel == "dkv" else (qh,)
        lib_ms = cs.time_ms(lambda: torch.autograd.grad(
            out, wrt, do.transpose(1, 2), retain_graph=True), iters=50)
        print(f"[ab] B={B} H={H} S={S} D={D} causal={int(causal)}: max "
              f"err/tol {ratio:.3f}; library {lib_ms:.4f} ms; " + "; ".join(
                  f"{name} {min(t):.4f} ms{notes.get(name, '')}"
                  for name, t in times.items()), flush=True)


if __name__ == "__main__":
    main()
