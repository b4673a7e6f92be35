"""Profiler (the port's copy of ``paddle_tpu/profiler.py``; reference
python/paddle/fluid/profiler.py, platform/profiler.cc RecordEvent and
tools/timeline.py).

Host-side ``RecordEvent`` scopes, dumped as a chrome://tracing JSON, and
the card's trace: where the JAX package starts ``jax.profiler``, the
port runs ``torch.profiler`` with CUDA activity and exports its chrome
trace (``start_profiler(trace_dir=...)``, ``cuda_profiler``).

``observability.dump_trace(path)`` merges these host spans with the
request span trees and compile events into one chrome trace, so a
RecordEvent captures when the profiler window is open
(start/stop_profiler) or ``FLAGS_observability=trace``.

Capture rule: a span is recorded iff capture was on when it STARTED, so
a span that began before ``start_profiler`` is left out whole and one
that began inside the window is kept whole past ``stop_profiler``. State
flips and event appends share one lock.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "cuda_profiler", "RecordEvent", "record_event"]

# bounded like every other observability sink: at FLAGS_observability=
# trace capture runs outside any profiler window, and the oldest spans
# age out of dumps
_MAX_EVENTS = 65536
_events = collections.deque(maxlen=_MAX_EVENTS)
_enabled = False
_lock = threading.Lock()
_device = None  # the torch.profiler run of start_profiler(trace_dir)

_trace_on = None  # bound on first use (observability imports this module)


def _default_path(name):
    return os.path.join(tempfile.gettempdir(), name)


def _capture_on() -> bool:
    """The capture gate, sampled when a span starts."""
    global _trace_on
    if _enabled:
        return True
    if _trace_on is None:
        from .observability.metrics import trace_on as _t

        _trace_on = _t
    return _trace_on()


class RecordEvent:
    """RAII host annotation (reference platform/profiler.h:81)."""

    def __init__(self, name):
        self.name = name
        self._t0 = None
        self._record = False

    def __enter__(self):
        self._record = _capture_on()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        if self._record:
            t1 = time.perf_counter_ns()
            with _lock:
                _events.append((self.name, self._t0, t1,
                                threading.get_ident()))
        return False


@contextlib.contextmanager
def record_event(name):
    with RecordEvent(name):
        yield


def _device_trace(trace_dir):
    """A started torch.profiler run recording the card (and the host's
    PyTorch ops), exported to `trace_dir` when it stops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kinds = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        kinds.append(ProfilerActivity.CUDA)
    prof = profile(activities=kinds)
    prof.start()
    prof.trace_dir = trace_dir
    return prof


def _export_device_trace(prof):
    prof.stop()
    os.makedirs(prof.trace_dir, exist_ok=True)
    path = os.path.join(prof.trace_dir, "device.chrome_trace.json")
    prof.export_chrome_trace(path)
    return path


def start_profiler(state="All", trace_dir=None):
    """Open the host-span window; with `trace_dir`, also record the card
    through torch.profiler until ``stop_profiler``."""
    global _enabled, _device
    with _lock:
        _enabled = True
    if trace_dir:
        _device = _device_trace(trace_dir)


def stop_profiler(sorted_key=None, profile_path=None):
    """Close the window: the host spans go to
    ``<profile_path>.chrome_trace.json`` and a summary is printed; a
    device trace started by ``start_profiler(trace_dir=...)`` is exported
    into its directory."""
    global _enabled, _device
    with _lock:
        _enabled = False
    if _device is not None:
        prof, _device = _device, None
        _export_device_trace(prof)
    _dump_chrome_trace(profile_path or _default_path("profile"))
    _print_summary(sorted_key)


def reset_profiler():
    with _lock:
        _events.clear()


def _snapshot_events():
    """A copy of the recorded host spans (observability/tracing.py's
    dump_trace merges them)."""
    with _lock:
        return list(_events)


def _dump_chrome_trace(path):
    """chrome://tracing JSON (tools/timeline.py:273 parity)."""
    trace = {"traceEvents": []}
    for name, t0, t1, tid in _snapshot_events():
        trace["traceEvents"].append({
            "name": name, "ph": "X", "pid": 0, "tid": tid,
            "ts": t0 / 1000.0, "dur": (t1 - t0) / 1000.0,
            "cat": "host"})
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path + ".chrome_trace.json", "w") as f:
            json.dump(trace, f)
    except OSError:
        pass


def _print_summary(sorted_key):
    agg = defaultdict(lambda: [0, 0.0])
    for name, t0, t1, _ in _snapshot_events():
        agg[name][0] += 1
        agg[name][1] += (t1 - t0) / 1e6
    rows = sorted(agg.items(), key=lambda kv: -kv[1][1])
    if not rows:
        return
    print(f"{'Event':<40} {'Calls':>8} {'Total(ms)':>12} {'Avg(ms)':>10}")
    for name, (calls, total) in rows:
        print(f"{name:<40} {calls:>8} {total:>12.3f} "
              f"{total / calls:>10.3f}")


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option=None):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """The card's trace for the block: torch.profiler with CUDA activity,
    exported as a chrome trace into the directory `output_file` names
    (``.nvprof`` stripped)."""
    trace_dir = output_file or _default_path("cuda_trace")
    if trace_dir.endswith(".nvprof"):
        trace_dir = trace_dir[:-len(".nvprof")]
    prof = _device_trace(trace_dir)
    try:
        yield
    finally:
        _export_device_trace(prof)
