"""The benchmark's own arithmetic: the card's peaks, model FLOPs from a
configuration file's published widths, the least time of attention work,
and the comparison numbers that decide ``correct``.

Kept here, under the benchmark's paths, so that a change to the program
cannot move the yardstick.  ``attention_bound`` and ``BWD_WORK`` are
copies of ``chip_smoke.py``'s; the FLOP count follows PaLM's appendix B
(``6N + 12 L E S`` a trained token) with N the matmul parameters at the
configuration's published vocabulary, not a padded one.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Mapping, Optional, Tuple

#: one NVIDIA H100 SXM, dense bf16, at its full 700 W (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
#: its HBM3 rate
PEAK_BYTES_PER_S = 3.35e12

#: (products, bf16 tensors, f32 rows) of each backward kernel's work, and
#: of the whole backward: dq recomputes s and dp and forms ds k (q, k, v,
#: do, dq; lse, delta); dk/dv recomputes s and dp and forms p^T do and
#: ds^T q (q, k, v, do, dk, dv; lse, delta); the backward as one function
#: needs five products and q, k, v, do, dq, dk, dv.
BWD_WORK = {"dq": (3, 5, 2), "dkv": (4, 6, 2), "pair": (5, 7, 2)}


def widths(config: Mapping) -> Dict[str, int]:
    """L, E, H, D, V, P of a GPT-2 configuration file (Hugging Face keys)."""
    E, H = int(config["n_embd"]), int(config["n_head"])
    if E % H:
        raise ValueError(f"n_embd {E} does not divide by n_head {H}")
    return {"L": int(config["n_layer"]), "E": E, "H": H, "D": E // H,
            "V": int(config["vocab_size"]), "P": int(config["n_positions"])}


def matmul_params(config: Mapping) -> int:
    """N: the blocks' matmul weights (c_attn 3E^2, attention c_proj E^2,
    the MLP 8E^2) and the tied lm head V E; the embedding gather is no
    matmul."""
    w = widths(config)
    return 12 * w["L"] * w["E"] ** 2 + w["V"] * w["E"]


def train_flops_per_token(config: Mapping, seq_len: int) -> float:
    """Forward and backward FLOPs of one trained token (no recompute)."""
    w = widths(config)
    return 6 * matmul_params(config) + 12 * w["L"] * w["E"] * seq_len


def attention_bound(B, H, S, D, causal, products=2, tensors=4, rows=1
                    ) -> Tuple[float, str]:
    """(least seconds on an H100 SXM, "bytes" or "operations") of attention
    work of ``products`` (S, S, D) products, 2*B*H*S^2*D operations each
    (halved when causal), at the bf16 peak, against ``tensors`` bf16
    (B, S, H, D) tensors and ``rows`` f32 (B, H, S) rows moved once at the
    memory rate.  The forward: 2 products, q, k, v, o and lse."""
    flops = products * 2 * B * H * S * S * D / (2 if causal else 1)
    nbytes = tensors * B * S * H * D * 2 + rows * B * H * S * 4
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_shape(config: Mapping, traffic: Mapping) -> Tuple[int, int, int, int]:
    """(B, H, S, D) of the attention a cell's step runs."""
    w = widths(config)
    return (int(traffic["batch"]), w["H"], int(traffic["seq_len"]), w["D"])


# --------------------------------------------------------------------------
# the numbers that decide ``correct``


def worst_leaf_gap(got: Mapping[str, float], ref: Mapping[str, float],
                   leaves=None) -> Tuple[float, Optional[str]]:
    """(the largest |got - ref| / max(ref, median ref), its leaf) over
    ``leaves`` (default: every leaf of ``ref``).  ``got`` and ``ref`` are
    norms by leaf; a leaf missing from ``got`` reads as 0.  The median of
    ``ref`` is taken over every leaf, so that a leaf whose norm is all but
    zero is measured against a typical one."""
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for name in (ref if leaves is None else leaves):
        r = ref[name]
        gap = abs(got.get(name, 0.0) - r) / max(r, med)
        if not math.isfinite(gap):
            return math.inf, name
        if gap > worst or at is None:
            worst, at = gap, name
    return worst, at


def moved_leaves(ref_grad: Mapping[str, float], share: float = 1e-3):
    """The leaves whose first gradient in the reference is at least
    ``share`` of the median leaf's: the others move under Adam by
    round-off alone, and their change is left out of the comparison."""
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= share * med]


def loss_gap(got, ref) -> float:
    """The largest |got - ref| / |ref| over the steps."""
    if len(got) != len(ref):
        return math.inf
    gaps = [abs(g - r) / abs(r) for g, r in zip(got, ref)]
    return max(gaps) if all(math.isfinite(x) for x in gaps) else math.inf
