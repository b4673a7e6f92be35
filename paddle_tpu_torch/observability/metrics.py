"""Fixed-bucket latency histograms for the servers' stats (the port's
copy of ``Histogram`` from ``paddle_tpu/observability/metrics.py``).

The counters, gauges, pull providers and the text exposition of the JAX
module belong to a later slice.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Iterable, List, Optional, Tuple


def default_ms_buckets():
    """Geometric latency ladder in milliseconds: 1e-3 ms .. ~10 min,
    ratio 2**0.25 (~19% a step), as the JAX module's."""
    ratio = 2.0 ** 0.25
    edges = []
    v = 1e-3
    while v < 6e5:
        edges.append(v)
        v *= ratio
    return tuple(edges)


class Histogram:
    """Fixed-bucket histogram with percentile estimation: O(1) memory
    whatever the sample count. ``percentile(p)`` is nearest-rank over
    the bucket counts with linear interpolation inside the winning
    bucket (off by at most one bucket width); the overflow bucket past
    the last edge reports the tracked maximum."""

    __slots__ = ("name", "buckets", "_counts", "_count", "_max", "_lock")

    def __init__(self, name: str = "",
                 buckets: Optional[Iterable[float]] = None):
        self.name = name
        self.buckets = tuple(buckets) if buckets is not None \
            else default_ms_buckets()
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be ascending")
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._max = None
        self._lock = threading.Lock()

    def observe(self, v: float):
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            if self._max is None or v > self._max:
                self._max = v

    def clear(self):
        """Window reset (the servers' ``stats(reset=True)``)."""
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._count = 0
            self._max = None

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
                        return self._max
                    hi = self.buckets[i]
                    lo = self.buckets[i - 1] if i > 0 else 0.0
                    est = lo + (hi - lo) * (rank - (seen - c)) / c
                    return min(est, self._max)
            return self._max

    def cumulative_counts(self) -> List[Tuple[float, int]]:
        """[(upper edge, cumulative count)], +inf last: the Prometheus
        histogram's shape."""
        with self._lock:
            out, cum = [], 0
            for edge, c in zip(self.buckets, self._counts):
                cum += c
                out.append((edge, cum))
            out.append((math.inf, cum + self._counts[-1]))
            return out

    def percentile_dict(self) -> dict:
        p50 = self.percentile(0.50)
        p99 = self.percentile(0.99)
        return {"p50": round(p50, 3) if p50 is not None else None,
                "p99": round(p99, 3) if p99 is not None else None}
