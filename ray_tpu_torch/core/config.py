"""Typed config/flag registry with environment-variable override.

A minimal copy of ``ray_tpu/core/config.py``: every flag has a default,
and ``RAY_TPU_<NAME>`` in the environment overrides it.  The environment
is read once, when the flag is defined; ``config.reload`` re-reads it.
The port defines only the flags its modules use, under the names the JAX
package already registers; all of them are bools so far.
"""

from __future__ import annotations

import os
from typing import Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _Flag:
    __slots__ = ("name", "default", "doc", "value")

    def __init__(self, name, default, doc):
        self.name = name
        self.default = default
        self.doc = doc
        self.value = default
        self.reload()

    @property
    def env_name(self) -> str:
        return _ENV_PREFIX + self.name.upper()

    def reload(self):
        """Default, then the environment override."""
        env = os.environ.get(self.env_name)
        self.value = self.default if env is None else _parse_bool(env)


class _Config:
    """Flag values are materialized as plain instance attributes."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}

    def define(self, name: str, type_: type, default, doc: str = ""):
        if type_ is not bool:
            raise TypeError(f"flag {name}: only bool flags are ported")
        flag = _Flag(name, default, doc)
        self._flags[name] = flag
        object.__setattr__(self, name, flag.value)

    def reload(self, *names: str):
        """Re-read environment overrides — all flags, or just ``names``."""
        for name in names or list(self._flags):
            flag = self._flags[name]
            flag.reload()
            object.__setattr__(self, name, flag.value)

    def __getattr__(self, name: str):
        # only reached for names never defined
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            flag = self._flags[name]
            flag.value = bool(value)
            object.__setattr__(self, name, flag.value)


config = _Config()
