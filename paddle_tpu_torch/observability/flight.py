"""Flight recorder: a bounded ring of completed request timelines (the
port's copy of ``paddle_tpu/observability/flight.py``).

Aggregate counters say whether the fleet is healthy; they cannot say
what the request that blew its deadline did. The recorder keeps the
recent timelines and, in a smaller ring of its own, every incident's (an
errored, cancelled or deadline-expired request, or one over its SLO), so
the record survives the churn of healthy traffic. ``incident_report()``
dumps them.

Detail follows ``FLAGS_observability``: ``metrics`` records coarse
timelines, ``trace`` the full span trees (``Trace.finish`` routes every
sealed trace here), ``off`` nothing.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Optional

from .metrics import REGISTRY, metrics_on

__all__ = ["FlightRecorder", "RECORDER", "incident_report"]


class FlightRecorder:
    """Bounded rings of completed request timelines and retained
    incidents."""

    def __init__(self, max_recent: int = 256, max_incidents: int = 64):
        self._lock = threading.Lock()
        self.recent = collections.deque(maxlen=max_recent)
        self.incidents = collections.deque(maxlen=max_incidents)
        self.recorded_total = 0
        self.incidents_total = 0

    def record(self, timeline: dict, incident: bool = False):
        """One completed request's timeline (``Trace.timeline()``, or a
        coarse dict at the metrics level); a no-op at ``off``."""
        if not metrics_on():
            return
        with self._lock:
            self.recorded_total += 1
            self.recent.append(timeline)
            if incident:
                self.incidents_total += 1
                self.incidents.append(timeline)

    def incident_report(self, max_incidents: Optional[int] = None) \
            -> dict:
        """JSON-able dump: every retained incident (newest last) and the
        rings' counts."""
        with self._lock:
            incidents = list(self.incidents)
            if max_incidents is not None:
                incidents = incidents[-int(max_incidents):]
            return {
                "generated_at": time.time(),
                "recorded_total": self.recorded_total,
                "incidents_total": self.incidents_total,
                "incidents_retained": len(incidents),
                "recent_retained": len(self.recent),
                "incidents": incidents,
            }

    def _metrics_samples(self):
        return [
            ("paddle_tpu_flight_recorded_total", {},
             self.recorded_total),
            ("paddle_tpu_flight_incidents_total", {},
             self.incidents_total),
        ]

    def reset(self):
        with self._lock:
            self.recent.clear()
            self.incidents.clear()
            self.recorded_total = 0
            self.incidents_total = 0


RECORDER = FlightRecorder()
# only the process-global ring is a provider: a private ring must not
# add a second paddle_tpu_flight_* series to the exposition
REGISTRY.register_provider(RECORDER)


def incident_report(max_incidents: Optional[int] = None) -> dict:
    return RECORDER.incident_report(max_incidents=max_incidents)
