"""Central metrics registry: counters, gauges, fixed-bucket histograms
(the port's copy of ``paddle_tpu/observability/metrics.py``).

Named metric families with labels, exported as a Prometheus text
exposition (``expose()``), byte for byte the JAX module's format: the
same family names, label escaping and summary lines.

* **Histograms are fixed-bucket** (a geometric ladder, ~1.19x a step,
  O(1) memory); ``percentile()`` answers from the bucket counts, off by
  at most one bucket width.
* **Exposition is pull-based.** Long-lived objects (executors, servers)
  register as *providers* by weakref; their counters stay where they
  live and are read only when ``expose()`` is called.
* **Gated by ``FLAGS_observability``** (``paddle_tpu_torch/flags.py``):
  ``off`` empties the exposition, ``metrics`` enables it, ``trace`` adds
  span capture (``tracing.py``). The gates run on the serving hot path,
  so each is one dict read of the flag store, per call: ``set_flags``
  takes effect at once.
"""
from __future__ import annotations

import bisect
import math
import threading
import weakref
from typing import Dict, Iterable, List, Optional, Tuple

from ..flags import FLAGS as _FLAGS

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "REGISTRY", "expose", "counter", "gauge", "histogram",
           "register_provider", "default_ms_buckets", "metrics_on",
           "trace_on"]

# the flag store itself: a gate is one dict read
_OBS_VALUES = _FLAGS._values


def metrics_on() -> bool:
    """True at FLAGS_observability in {metrics, trace}."""
    return _OBS_VALUES["observability"] != "off"


def trace_on() -> bool:
    """True at FLAGS_observability=trace."""
    return _OBS_VALUES["observability"] == "trace"


def default_ms_buckets() -> Tuple[float, ...]:
    """Geometric latency ladder in milliseconds: 1e-3 ms .. ~10 min,
    ratio 2**0.25 (~19% a step, ~118 buckets)."""
    ratio = 2.0 ** 0.25
    edges = []
    v = 1e-3
    while v < 6e5:
        edges.append(v)
        v *= ratio
    return tuple(edges)


_DEFAULT_MS_BUCKETS = default_ms_buckets()


class Counter:
    """Monotonic counter; ``inc`` under a lock (the expose thread reads
    it while request threads bump it)."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (the last set wins)."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    Buckets are upper edges (ascending); one overflow bucket past the
    last edge catches the rest. ``observe`` is one bisect and one
    increment under a lock: O(1) memory whatever the sample count.
    ``percentile(p)`` is nearest-rank over the bucket counts with linear
    interpolation inside the winning bucket (within one bucket width of
    the exact sample's); the overflow bucket reports the tracked max.
    """

    __slots__ = ("name", "help", "labels", "buckets", "_counts",
                 "_count", "_sum", "_max", "_lock")

    def __init__(self, name: str = "", help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = tuple(buckets) if buckets is not None \
            else _DEFAULT_MS_BUCKETS
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be ascending")
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v: float):
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if self._max is None or v > self._max:
                self._max = v

    def __len__(self):
        return self._count

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def reset(self):
        """Window reset (the servers' ``stats(reset=True)``)."""
        with self._lock:
            for i in range(len(self._counts)):
                self._counts[i] = 0
            self._count = 0
            self._sum = 0.0
            self._max = None

    def clear(self):
        self.reset()

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile estimate, None when empty."""
        with self._lock:
            n = self._count
            if n == 0:
                return None
            rank = max(1, math.ceil(p * n))
            seen = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                seen += c
                if seen >= rank:
                    if i >= len(self.buckets):
                        return self._max  # overflow: the exact max
                    hi = self.buckets[i]
                    lo = self.buckets[i - 1] if i > 0 else 0.0
                    frac = (rank - (seen - c)) / c
                    est = lo + (hi - lo) * frac
                    if self._max is not None and est > self._max:
                        est = self._max
                    return est
            return self._max

    def percentile_dict(self) -> dict:
        p50 = self.percentile(0.50)
        p99 = self.percentile(0.99)
        return {"p50": round(p50, 3) if p50 is not None else None,
                "p99": round(p99, 3) if p99 is not None else None}

    def cumulative_counts(self) -> List[Tuple[float, int]]:
        """[(upper edge, cumulative count)], +inf last: the Prometheus
        histogram's shape."""
        with self._lock:
            out, cum = [], 0
            for edge, c in zip(self.buckets, self._counts):
                cum += c
                out.append((edge, cum))
            cum += self._counts[-1]
            out.append((math.inf, cum))
            return out


def _escape_label_value(v) -> str:
    """Prometheus label-value escaping (backslash, quote, newline): one
    bad caller string must not make the whole scrape unparseable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Process-global registry: instruments it owns plus weakly
    registered *providers* (objects whose ``_metrics_samples()`` yields
    ``(name, labels, value-or-Histogram)``), read only at ``expose()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._providers: List[weakref.ref] = []

    # --- owned instruments -------------------------------------------
    def _get_or_make(self, cls, name, help, labels):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help, labels)
                self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  buckets=None) -> Histogram:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = Histogram(name, help, labels, buckets=buckets)
                self._metrics[key] = m
            return m

    # --- providers ----------------------------------------------------
    def register_provider(self, obj):
        """Weakly register `obj` (it must have ``_metrics_samples()``).
        Dead refs are pruned here as well as at collect time: at ``off``
        nothing ever collects, and a process that makes many executors
        or servers must not grow the list for ever."""
        with self._lock:
            self._providers = [r for r in self._providers
                               if r() is not None]
            self._providers.append(weakref.ref(obj))

    def _live_providers(self):
        with self._lock:
            live, refs = [], []
            for r in self._providers:
                o = r()
                if o is not None:
                    live.append(o)
                    refs.append(r)
            self._providers = refs
            return live

    # --- collection ---------------------------------------------------
    def collect(self) -> List[Tuple[str, Dict[str, str], object]]:
        """All samples: (name, labels, float-or-Histogram)."""
        out = []
        with self._lock:
            owned = list(self._metrics.values())
        for m in owned:
            out.append((m.name, m.labels,
                        m if isinstance(m, Histogram) else m.value))
        for p in self._live_providers():
            try:
                samples = list(p._metrics_samples())
            except Exception:
                continue  # a broken provider must never break expose
            for name, labels, value in samples:
                out.append((name, dict(labels or {}), value))
        return out

    def expose(self) -> str:
        """Prometheus text exposition. Histograms render as summaries
        (quantile lines and _count/_sum). Empty (bar a comment) at
        FLAGS_observability=off."""
        if not metrics_on():
            return ("# observability disabled "
                    "(FLAGS_observability=off)\n")
        lines = []
        for name, labels, value in sorted(
                self.collect(), key=lambda s: (s[0], sorted(s[1].items()))):
            if isinstance(value, Histogram):
                for q in (0.5, 0.99):
                    est = value.percentile(q)
                    if est is None:
                        continue
                    ql = dict(labels)
                    ql["quantile"] = f"{q:g}"
                    lines.append(f"{name}{_fmt_labels(ql)} {est:g}")
                lines.append(
                    f"{name}_count{_fmt_labels(labels)} {value.count}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {value.sum:g}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} {value:g}")
        return "\n".join(lines) + "\n"

    def reset(self):
        """Drop owned instruments and provider registrations (tests)."""
        with self._lock:
            self._metrics.clear()
            self._providers = []


REGISTRY = MetricsRegistry()

# the module-level call surface: ``observability.metrics.expose()``
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
register_provider = REGISTRY.register_provider
expose = REGISTRY.expose
