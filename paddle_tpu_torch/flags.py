"""Global FLAGS_* configuration (the port's copy of the flags of
``paddle_tpu/flags.py`` that it reads).

* ``observability``: ``off | metrics | trace`` (``FLAGS_observability``),
  the level of the observability layer (``paddle_tpu_torch/
  observability``): off = dormant, metrics = the metrics exposition and
  coarse flight-recorder timelines, trace = also a span tree per request
  and chrome-trace dumps. Read per call, so ``set_flags`` changes it
  mid-process.
* ``executor_cache_capacity``: the bound on an Executor's cache of
  PreparedPrograms (least recently used first out; <= 0 unbounded).

The values are read from the environment once, at import; programmatic
updates go through ``set_flags`` / ``get_flags`` (paddle's API shape).
The JAX package's other flags tune subsystems the port does not have and
are not copied: setting one raises, naming the known flags.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["FLAGS", "set_flags", "get_flags"]


def _as_obs_mode(s):
    """FLAGS_observability level: off | metrics | trace (bool spellings
    map 0->off, 1->metrics for launch-script convenience)."""
    v = str(s).strip().lower()
    if v in ("off", "metrics", "trace"):
        return v
    if v in ("0", "false", "no", ""):
        return "off"
    if v in ("1", "true", "yes", "on"):
        return "metrics"
    raise ValueError(f"{s!r} is not one of off/metrics/trace")


# name -> (type-coercer, default)
_DEFS = {
    "observability": (_as_obs_mode, "off"),
    "executor_cache_capacity": (int, 64),
}


class _Flags:
    """Attribute-style access: ``flags.FLAGS.observability``."""

    def __init__(self):
        object.__setattr__(self, "_values", {})
        for name, (coerce, default) in _DEFS.items():
            val = default
            env = os.environ.get("FLAGS_" + name)
            if env is not None:
                try:
                    val = coerce(env)
                except (TypeError, ValueError):
                    warnings.warn(
                        f"FLAGS_{name}={env!r} is not a valid "
                        f"{coerce.__name__}; using default {default!r}")
            self._values[name] = val

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}") from None

    def __setattr__(self, name, value):
        set_flags({name: value})

    def _set(self, name, value):
        if name.startswith("FLAGS_"):
            name = name[len("FLAGS_"):]
        if name not in _DEFS:
            raise ValueError(
                f"unknown flag {name!r}; known flags: {sorted(_DEFS)}")
        self._values[name] = _DEFS[name][0](value)


def set_flags(flags: dict):
    """paddle-API-shaped update: set_flags({'FLAGS_observability':
    'trace'})."""
    for k, v in flags.items():
        FLAGS._set(k, v)


def get_flags(names):
    if isinstance(names, str):
        names = [names]
    out = {}
    for n in names:
        key = n[len("FLAGS_"):] if n.startswith("FLAGS_") else n
        out["FLAGS_" + key] = getattr(FLAGS, key)
    return out


FLAGS = _Flags()
