"""Observability of the port (the counterpart of
``paddle_tpu/observability``): one gate, ``FLAGS_observability = off |
metrics | trace`` (``paddle_tpu_torch/flags.py``), read per call.

* ``metrics``: counters, gauges and fixed-bucket histograms in one
  registry with pull providers (executors, servers); ``metrics.expose()``
  is the Prometheus text exposition.
* ``tracing``: a ``Trace`` of spans per request (queue, admit, dispatch,
  execute, readback, finish), the Executor's PreparedProgram builds as
  global events, and ``dump_trace(path)``, one chrome trace merging them
  with the profiler's host spans.
* ``flight``: a bounded ring of completed request timelines; errors,
  cancels and deadline expiries are kept as incidents
  (``incident_report()``).
* ``devtel``: the decode bundles' device counters (burst exit reason,
  ticks, occupancy, admission tiers), deltaed a dispatch.
* ``costmodel``: static flops and bytes per prepared program and a
  median achieved-rate calibration, so a burst carries its expected
  against its actual tick time.
"""
from __future__ import annotations

from . import metrics
from .flight import RECORDER, incident_report
from .metrics import metrics_on, trace_on
from .tracing import TRACER, dump_trace, start_request

__all__ = ["metrics", "tracing", "flight", "devtel", "costmodel",
           "dump_trace", "incident_report", "start_request",
           "metrics_on", "trace_on", "reset", "TRACER", "RECORDER"]

from . import costmodel, devtel, flight, tracing  # noqa: E402


def reset():
    """Clear the trace sinks and the flight recorder (tests; window
    starts). Metric instruments stay: counters are cumulative."""
    tracing.reset()
    RECORDER.reset()
