"""The run's last line, and the checks that guard it.

A run prints one JSON object as the last line of its standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with a
trace ``breakdown``), and, last there, ``checks``: each number that
decided ``correct``, beside its limit.  The same checks end its standard
error.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Dict, List, Optional

#: top-level module names that may not be loaded in a run's processes
BLOCKED = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_modules() -> List[str]:
    """The blocked top-level names that ``sys.modules`` holds, compared
    whole: ``ray_tpu_torch`` is not ``ray_tpu``."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(BLOCKED))


def check(name: str, value: float, limit: float) -> Dict:
    """One compared number: it passes when finite and at most ``limit``."""
    return {"name": name, "value": value, "limit": limit,
            "ok": bool(math.isfinite(value) and value <= limit)}


def line(*, correct: bool, attempted: int, failed: int, metrics: Dict,
         device: Dict, checks: List[Dict],
         breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c["name"]: {"value": _number(c["value"]),
                                 "limit": c["limit"]} for c in checks}
    return json.dumps(out, allow_nan=False)


def _number(x: float):
    """A compared number for JSON, which has no infinity or NaN."""
    return x if math.isfinite(x) else str(x)


def print_checks(checks: List[Dict]):
    """The compared numbers, one a line, as the last lines of stderr."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}) "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr,
              flush=True)
