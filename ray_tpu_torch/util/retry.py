"""Unified retry/backoff policy for transient-failure paths.

One jittered-exponential-backoff policy (reference: the exponential
backoff helpers in `python/ray/_private/utils.py` and the gRPC channel
retry knobs in `ray_config_def.h`) shared by every ad-hoc retry loop in
the runtime — GCS client reconnect, data-channel dials, pull-manager
directory re-lookups — instead of each site hardcoding its own sleep
constant.  Defaults come from the config registry
(``RAY_TPU_RETRY_BACKOFF_*``); a policy can be seeded so chaos tests get
reproducible delay sequences.
"""

from __future__ import annotations

import random
from typing import Optional

from ray_tpu_torch.core.config import config

config.define("retry_backoff_base_s", float, 0.2,
              "Unified retry policy: first-attempt backoff delay.  Used by "
              "the GCS reconnect loop, data-channel dials, and pull-manager "
              "directory re-lookups.")
config.define("retry_backoff_max_s", float, 5.0,
              "Unified retry policy: backoff delay ceiling.")
config.define("retry_backoff_multiplier", float, 2.0,
              "Unified retry policy: per-attempt delay multiplier.")
config.define("retry_backoff_jitter", float, 0.2,
              "Unified retry policy: +/- jitter fraction applied to each "
              "delay (0 disables; keeps retry storms from synchronizing).")


class BackoffPolicy:
    """Jittered exponential backoff: ``delay(attempt)`` for attempt 0,1,2...

    ``None`` parameters resolve from the config registry at construction.
    A seeded policy produces a deterministic jitter sequence (chaos tests);
    unseeded policies share the process RNG.
    """

    __slots__ = ("base_s", "max_s", "multiplier", "jitter", "_rng")

    def __init__(self, base_s: Optional[float] = None,
                 max_s: Optional[float] = None,
                 multiplier: Optional[float] = None,
                 jitter: Optional[float] = None,
                 seed: Optional[int] = None):
        self.base_s = config.retry_backoff_base_s if base_s is None else base_s
        self.max_s = config.retry_backoff_max_s if max_s is None else max_s
        self.multiplier = (config.retry_backoff_multiplier
                           if multiplier is None else multiplier)
        self.jitter = (config.retry_backoff_jitter
                       if jitter is None else jitter)
        self._rng = random.Random(seed) if seed is not None else random

    def delay(self, attempt: int) -> float:
        """Backoff delay for the given 0-based attempt number."""
        d = min(self.max_s,
                self.base_s * (self.multiplier ** max(0, attempt)))
        if self.jitter > 0:
            d *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return max(0.0, d)

    def stagger(self, span_s: float) -> float:
        """A full-range uniform draw in ``[0, span_s]`` — the FIRST-attempt
        de-synchronizer.  ``delay()``'s +/- jitter keeps retry LOOPS from
        re-synchronizing, but when many processes start their loops at the
        same instant (every raylet sees the GCS socket die simultaneously
        on a restart) a fractional jitter still concentrates the herd
        around the shared base delay; a full-span draw spreads the initial
        dials/registrations evenly across the window instead."""
        if span_s <= 0:
            return 0.0
        return self._rng.uniform(0.0, span_s)
