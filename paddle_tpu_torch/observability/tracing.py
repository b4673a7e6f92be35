"""Request tracing: one span timeline per request, one chrome dump (the
port's copy of ``paddle_tpu/observability/tracing.py``; reference
platform/profiler.cc RecordEvent and tools/timeline.py:131).

* ``Trace``: one request's timeline, opened at a server's ``submit``
  when ``FLAGS_observability=trace`` and carried on the request across
  the server's threads, so the spans of one request land in one tree
  whichever thread recorded them. Spans are (name, t0, t1, attrs) in
  ``time.monotonic`` seconds; the parent of a span is found at dump time
  as the smallest interval that encloses it.
* **Ambient context**: a server dispatches one batch for many requests
  through a runner of fixed signature (``run_batch(feed)``);
  ``ambient()`` parks the batch's traces in a thread-local so the
  execute and readback spans recorded inside the runner attach to every
  request of the batch.
* **Global events**: the Executor's PreparedProgram builds (the port's
  counterpart of an XLA compile), with ``Program.fingerprint()``.
* ``dump_trace(path)``: one chrome-trace JSON of the host RecordEvent
  spans (``paddle_tpu_torch/profiler.py``), the request span trees and
  the global events.

At ``off`` and ``metrics`` no span is recorded and ``dump_trace`` writes
an empty trace.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import List, Optional

from .metrics import metrics_on, trace_on

__all__ = ["Span", "Trace", "Tracer", "TRACER", "trace_on",
           "metrics_on", "start_request", "current_request_trace",
           "request_context", "ambient", "ambient_traces", "span",
           "execute_span", "cache_tier", "record_global_event",
           "dump_trace", "reset"]

# perf_counter_ns (the profiler's clock) minus monotonic_ns, so host
# events and request spans share one timebase in the dump
_PC_NS_MINUS_MONO_NS = time.perf_counter_ns() - time.monotonic_ns()


class Span:
    """One named host-side interval of a request's timeline."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}


class Trace:
    """One request's timeline: its id, spans and outcome. ``add_span``
    may be called from any thread; ``finish`` seals the trace, records
    the root ``request`` span and hands the trace to the tracer's sink
    and the flight recorder."""

    __slots__ = ("request_id", "seq", "attrs", "t_start", "t_end",
                 "status", "slo_violated", "spans", "owner", "_lock",
                 "_done")

    def __init__(self, request_id: str, seq: int, owner: str = "router",
                 **attrs):
        self.request_id = request_id
        self.seq = seq
        self.attrs = attrs
        self.t_start = time.monotonic()
        self.t_end = None
        self.status = None
        self.slo_violated = False
        self.spans: List[Span] = []
        self.owner = owner
        self._lock = threading.Lock()
        self._done = False

    def add_span(self, name: str, t0: float, t1: float, **attrs):
        with self._lock:
            if not self._done:
                self.spans.append(Span(name, t0, t1, attrs))

    def finish(self, status: str = "ok", slo_violated: bool = False,
               **attrs):
        with self._lock:
            if self._done:
                return
            self._done = True
            self.t_end = time.monotonic()
            self.status = status
            self.slo_violated = bool(slo_violated)
            self.attrs.update(attrs)
            # the root must enclose every child (parents are found by
            # smallest enclosing interval): widen it to the spans' hull
            t0 = min([self.t_start] + [s.t0 for s in self.spans])
            t1 = max([self.t_end] + [s.t1 for s in self.spans])
            self.t_start, self.t_end = t0, t1
            self.spans.append(Span("request", t0, t1,
                                   {"status": status}))
        TRACER._completed(self)
        from . import flight  # deferred: flight imports metrics too

        flight.RECORDER.record(self.timeline(),
                               incident=(status != "ok"
                                         or self.slo_violated))

    def timeline(self) -> dict:
        """JSON-able summary: the flight recorder's entry."""
        lat = None
        if self.t_end is not None:
            lat = round((self.t_end - self.t_start) * 1e3, 3)
        return {
            "request_id": self.request_id,
            "status": self.status,
            "slo_violated": self.slo_violated,
            "latency_ms": lat,
            **{k: v for k, v in self.attrs.items()},
            "spans": [
                {"name": s.name,
                 "t0_ms": round((s.t0 - self.t_start) * 1e3, 3),
                 "dur_ms": round((s.t1 - s.t0) * 1e3, 3),
                 **({"attrs": s.attrs} if s.attrs else {})}
                for s in sorted(self.spans, key=lambda s: s.t0)],
        }


class Tracer:
    """Process-global trace sink: completed request traces and global
    (non-request) events, both bounded rings."""

    def __init__(self, max_traces: int = 1024, max_events: int = 4096):
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self.completed = collections.deque(maxlen=max_traces)
        self.global_events = collections.deque(maxlen=max_events)

    def start_request(self, owner: str = "router", **attrs) \
            -> Optional[Trace]:
        """A new Trace at FLAGS_observability=trace, else None."""
        if not trace_on():
            return None
        seq = next(self._seq)
        return Trace(f"req-{seq:08d}", seq, owner=owner, **attrs)

    def next_request_id(self) -> str:
        """A request id without span capture (the metrics level's
        incident entries)."""
        return f"req-{next(self._seq):08d}"

    def _completed(self, trace: Trace):
        with self._lock:
            self.completed.append(trace)

    def record_global_event(self, name: str, t0: float, t1: float,
                            **attrs):
        if not trace_on():
            return
        with self._lock:
            self.global_events.append(Span(name, t0, t1, attrs))

    def reset(self):
        with self._lock:
            self.completed.clear()
            self.global_events.clear()


TRACER = Tracer()
start_request = TRACER.start_request
record_global_event = TRACER.record_global_event


# --- ambient context ---------------------------------------------------
_tls = threading.local()


class request_context:
    """Parks one request's trace in a thread-local for a downstream
    synchronous call, so the server below attaches to it instead of
    opening its own."""

    def __init__(self, trace: Optional[Trace]):
        self._trace = trace

    def __enter__(self):
        self._prev = getattr(_tls, "request_trace", None)
        _tls.request_trace = self._trace
        return self._trace

    def __exit__(self, *exc):
        _tls.request_trace = self._prev
        return False


def current_request_trace() -> Optional[Trace]:
    return getattr(_tls, "request_trace", None)


class ambient:
    """Parks a batch's traces in a thread-local so spans recorded below a
    fixed-signature boundary (``run_batch``) attach to every request of
    the batch."""

    def __init__(self, traces):
        self._traces = [t for t in (traces or []) if t is not None]

    def __enter__(self):
        self._prev = getattr(_tls, "batch_traces", None)
        _tls.batch_traces = self._traces
        return self._traces

    def __exit__(self, *exc):
        _tls.batch_traces = self._prev
        return False


def ambient_traces() -> List[Trace]:
    return getattr(_tls, "batch_traces", None) or []


def cache_tier(exe, builds_before, disk_loads_before) -> str:
    """Which tier served a dispatch, from the executor's counters across
    it: a PreparedProgram built (``exe.prepare_count`` moved; the port's
    counterpart of an XLA compile) = ``cold``, a disk load = ``disk``
    (the port has no disk cache: never), else ``memory``."""
    if exe.prepare_count > builds_before:
        return "cold"
    if exe.disk_load_count > disk_loads_before:
        return "disk"
    return "memory"


class span:
    """Records one (name, t0, t1) span into every ambient trace; one
    thread-local read when no batch is ambient."""

    __slots__ = ("name", "attrs", "_traces", "_t0")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._traces = ambient_traces()
        self._t0 = time.monotonic() if self._traces else 0.0
        return self

    def __exit__(self, *exc):
        if self._traces:
            t1 = time.monotonic()
            for tr in self._traces:
                tr.add_span(self.name, self._t0, t1, **self.attrs)
        return False


class execute_span(span):
    """``span("execute")`` whose ``cache`` attr comes from the executor's
    build and disk-load counters across the block (the one copy of the
    convention that ``ProgramRunner.run_batch`` and the predictor's
    ``_run_feed`` share). Open it before the prepared-cache lookup: a
    lookup miss is the build the tier must name.

    With ``program=`` the span also carries the cost model's flops and
    bytes of the program (``costmodel.py``); ``feed=`` picks the
    snapshot of the dispatch's own feed shapes."""

    __slots__ = ("_exe", "_c0", "_d0", "_program", "_feed")

    def __init__(self, exe, program=None, feed=None, **attrs):
        super().__init__("execute", **attrs)
        self._exe = exe
        self._program = program
        self._feed = feed

    def __enter__(self):
        self._c0 = self._exe.prepare_count
        self._d0 = self._exe.disk_load_count
        return super().__enter__()

    def __exit__(self, *exc):
        self.attrs["cache"] = cache_tier(self._exe, self._c0, self._d0)
        if self._traces and self._program is not None:
            from . import costmodel

            snap = costmodel.lookup(self._program,
                                    feed_arrays=self._feed) or {}
            for field in ("flops", "bytes_accessed"):
                if snap.get(field) is not None:
                    self.attrs[field] = snap[field]
        return super().__exit__(*exc)


# --- chrome trace dump -------------------------------------------------
def _assign_parents(spans: List[Span]) -> List[int]:
    """Parent index per span (-1 = root): the smallest strictly larger
    interval that encloses it."""
    parents = []
    for i, s in enumerate(spans):
        best, best_len = -1, None
        for j, o in enumerate(spans):
            if j == i:
                continue
            if o.t0 <= s.t0 and s.t1 <= o.t1 \
                    and (o.t1 - o.t0) > (s.t1 - s.t0):
                if best_len is None or (o.t1 - o.t0) < best_len:
                    best, best_len = j, o.t1 - o.t0
        parents.append(best)
    return parents


def dump_trace(path: str) -> dict:
    """Write one chrome://tracing / Perfetto JSON of

    * the host RecordEvent spans (profiler.py, pid 0),
    * the request span trees (pid 1, one tid a request), and
    * the global events (pid 2),

    and return the trace dict. ``path`` gets ``.json`` appended unless it
    ends so."""
    events = []

    def meta(pid, name):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": name}})

    meta(0, "host (RecordEvent)")
    meta(1, "requests")
    meta(2, "compile/cache")

    from .. import profiler

    for name, t0_ns, t1_ns, tid in profiler._snapshot_events():
        mono_us = (t0_ns - _PC_NS_MINUS_MONO_NS) / 1e3
        events.append({
            "name": name, "ph": "X", "pid": 0, "tid": tid,
            "ts": mono_us, "dur": (t1_ns - t0_ns) / 1e3,
            "cat": "host"})

    with TRACER._lock:
        traces = list(TRACER.completed)
        gevents = list(TRACER.global_events)

    for tr in traces:
        spans = sorted(tr.spans, key=lambda s: (s.t0, -(s.t1 - s.t0)))
        parents = _assign_parents(spans)
        for i, s in enumerate(spans):
            args = {"request_id": tr.request_id,
                    "span": f"{tr.request_id}/{i}",
                    "parent": (f"{tr.request_id}/{parents[i]}"
                               if parents[i] >= 0 else None)}
            args.update(tr.attrs)
            args.update(s.attrs)
            events.append({
                "name": s.name, "ph": "X", "pid": 1, "tid": tr.seq,
                "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
                "cat": "request", "args": args})

    for s in gevents:
        events.append({
            "name": s.name, "ph": "X", "pid": 2, "tid": 0,
            "ts": s.t0 * 1e6, "dur": (s.t1 - s.t0) * 1e6,
            "cat": "compile", "args": dict(s.attrs)})

    trace = {"traceEvents": events}
    if not path.endswith(".json"):
        path = path + ".json"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def reset():
    """Clear the trace sinks (tests; window starts)."""
    TRACER.reset()
