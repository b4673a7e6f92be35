"""Serving front ends (the port's subset of
paddle_tpu/inference/serving.py).

* ``InferenceServer`` — a thread-safe request queue over a predictor or
  a runner; one batcher thread forms micro-batches up to
  ``max_batch_size`` rows or ``max_wait_ms`` after the oldest queued
  request, pads the batch up a bucket ladder (by default 1, 2, 4, ...
  max_batch_size) by replicating the last real row, runs the program
  once, and hands each caller its own rows back. Requests batch together
  when their non-batch shapes and dtypes agree.
* ``GenerationServer`` — routes generation requests through the
  KV-cached incremental decode program
  (models/decode_engine.build_incremental_decode_program), so a
  T-token generation is one program run and one readback.
* ``ContinuousGenerationServer`` — iteration-level scheduling over a
  fixed slot pool (models/decode_engine.build_decode_step_program):
  queued prompts are admitted into free slots and every live lane
  advances in one fused dispatch, and finished lanes retire at once.
* ``PagedContinuousGenerationServer`` — the same scheduler over the
  paged KV layout: host-allocated block tables over a shared pool,
  prefix-cache admission (a repeated prompt is encoded once), the radix
  tier (chat sessions, n-best fan-out and retired plain prompts admit
  over shared self-KV block chains), lane pausing and
  recompute-preemption under pool pressure, and the named retryable
  ``BlockPoolExhausted``; with a chunked bundle, cold prompts prefill a
  chunk a dispatch beside the decode bursts (chunked prefill), on this
  server or on a ``DisaggregatedPrefillWorker``.
* ``DisaggregatedPrefillWorker`` — runs the chunked-prefill phase
  programs on a scope and thread of its own and hands each finished
  prompt entry's cross-KV rows to the paged server (disaggregated
  prefill, unsharded).
* ``PagedBeamDecoder`` — beam search over the paged pool: the device
  publishes each lane's next-token distribution (the bundle's probe
  program), the host expands the beams, and branching shares full
  blocks by refcount and copies a partial tail block through the
  bundle's COW program.

Both continuous servers serve sampled bundles (``SamplingConfig``): each
request's seed, ``zlib.crc32`` of its prompt unless the caller gives one,
keys its draws.

The front door (``submit(stream=True)`` returns a ``StreamingReply``;
``stream_cb``; ``admit_select`` and ``select_group`` hooks; sequence
buckets and ``aot_warmup``; ``expected_service_ms``) and the
observability of the JAX package (request traces, flight-recorder
incidents, the metrics providers, the burst annotation with the cost
model's expected tick time) are the JAX package's contracts. The
sharded prefill worker and tensor-parallel bundles are not ported.
"""
from __future__ import annotations

import collections
import itertools
import math
import re
import threading
import time
import warnings
import zlib
from concurrent import futures
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.executor import CUDAPlace, Executor, PreparedCache
from ..core.scope import Scope, global_scope
from ..core.types import to_np_dtype
from ..analysis.liveness import session_feasibility
from ..models.decode_engine import (POOL_MARK, AdmissionInfeasible,
                                    BlockPoolExhausted, HostBlockPool,
                                    PromptPrefixCache, RadixBlockTree,
                                    ServingUnavailable)
from ..observability import costmodel as obs_costmodel
from ..observability import devtel as obs_devtel
from ..observability import flight as obs_flight
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from ..observability.metrics import Histogram
from ..observability.tracing import cache_tier as _cache_tier
from .spec_controller import SpecController

SEQ_SUFFIX = "@SEQ_LEN"


def default_batch_buckets(max_batch_size: int) -> List[int]:
    """Power-of-two ladder 1,2,4,... capped at (and always including)
    max_batch_size."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, got "
                         f"{max_batch_size}")
    ladder = []
    b = 1
    while b < max_batch_size:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch_size)
    return ladder


def _bucket_for(size: int, ladder: Sequence[int], what: str) -> int:
    for b in ladder:
        if size <= b:
            return b
    raise ValueError(
        f"{what} {size} exceeds the largest bucket {max(ladder)}; "
        f"raise the bucket ladder or split the request")


def _pad_rows(arr: np.ndarray, rows: int) -> np.ndarray:
    """Pad the batch axis up to `rows` by replicating the last real
    row (numerically benign for any op; sliced away before demux)."""
    have = arr.shape[0]
    if have == rows:
        return arr
    reps = np.repeat(arr[-1:], rows - have, axis=0)
    return np.concatenate([arr, reps], axis=0)


def _pad_axis(arr: np.ndarray, axis: int, size: int) -> np.ndarray:
    """Zero-pad `axis` up to `size` (sequence bucketing; the real lengths
    ride the @SEQ_LEN companion untouched)."""
    have = arr.shape[axis]
    if have == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - have)
    return np.pad(arr, widths)


_Reply = futures.Future


class ServerQuiesced(ServingUnavailable):
    """submit() hit a server that stopped accepting but is still
    draining its queue; retryable after a short wait."""

    retryable = True
    retry_after_ms = 2.0


class ServerClosed(ServingUnavailable):
    """submit() hit a server whose close() already ran."""

    retryable = True
    retry_after_ms = 2.0


def _pct(sorted_vals, p):
    """Nearest-rank percentile over an ascending list; None on empty."""
    if not sorted_vals:
        return None
    idx = max(0, math.ceil(p * len(sorted_vals)) - 1)
    return round(sorted_vals[min(len(sorted_vals) - 1, idx)], 3)


def _pct_dict(vals):
    """p50/p99 of a fixed-bucket Histogram, or of raw samples."""
    if isinstance(vals, Histogram):
        return vals.percentile_dict()
    lat = sorted(vals)
    return {"p50": _pct(lat, 0.50), "p99": _pct(lat, 0.99)}


def _call_scheduling_hook(server, hook, arg, hook_name, fallback):
    """Run a queue-selection hook; on any exception warn once a server
    (its ``_hook_warned`` latch) and return (False, None), so the caller
    falls back to its default policy. A pick the caller finds invalid is
    a silent decline."""
    try:
        return True, hook(arg)
    except Exception as e:
        if not server._hook_warned:
            server._hook_warned = True
            warnings.warn(
                f"{hook_name} hook failed ({type(e).__name__}: {e}); "
                f"falling back to {fallback} for this server")
        return False, None


_obs_server_seq = itertools.count(1)


def _obs_server_id(server) -> str:
    """A stable metrics label for one server instance, e.g.
    InferenceServer-3."""
    return f"{type(server).__name__}-{next(_obs_server_seq)}"


class _Request:
    __slots__ = ("feed", "rows", "reply", "t_arrival", "trace")

    def __init__(self, feed, rows, reply, trace=None):
        self.feed = feed
        self.rows = rows
        self.reply = reply
        self.t_arrival = time.monotonic()
        # the request's Trace (observability.tracing), None below
        # FLAGS_observability=trace; a server-owned one is finished at
        # demux
        self.trace = trace


class ProgramRunner:
    """Runs a Program through an Executor against a scope: one
    PreparedProgram a bucket shape (``PreparedCache``) and one
    device-to-host copy a fetch a batch."""

    def __init__(self, program, feed_names, fetch_names, executor=None,
                 scope=None):
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        self.executor = executor or Executor(CUDAPlace(0))
        self.scope = scope or global_scope()
        self._prepared = PreparedCache(self.executor, program,
                                       self.fetch_names, self.scope)

    def run_batch(self, feed):
        # the execute and readback spans attach to every request of the
        # batch the server parked in the ambient context; the execute
        # span's cache tier counts a prepared lookup's miss
        with obs_tracing.execute_span(self.executor, program=self.program,
                                      feed=feed):
            prepared = self._prepared.lookup(feed)
            outs = prepared.run(feed, return_numpy=False)
        with obs_tracing.span("readback"):
            return [o.cpu().numpy() for o in outs]


class _PredictorRunner:
    """Adapts an AnalysisPredictor to the server's runner protocol."""

    def __init__(self, predictor):
        self._predictor = predictor
        self.feed_names = list(predictor.get_input_names())
        self.fetch_names = list(predictor.get_output_names())
        self.program = predictor.program()
        self.executor = predictor._exe

    def run_batch(self, feed):
        return self._predictor._run_feed(feed)


class InferenceServer:
    """Dynamic-batching, shape-bucketing server over a predictor (an
    AnalysisPredictor) or a runner (an object with ``program``,
    ``executor``, ``feed_names``, ``fetch_names`` and ``run_batch(feed)
    -> [np.ndarray]``), with the JAX package's parameters in its order.

    Requests are feed dicts whose arrays carry a leading batch axis;
    fetched outputs must be batch-major the same way. ``submit``
    enqueues and returns a future; ``infer`` blocks for one request. One
    batcher thread groups requests of the same post-bucketing shape
    signature, pads the batch up the bucket ladder, runs the program
    once and hands each caller its own rows back.

    * ``seq_buckets``: declared -1 dims past the batch axis are
      zero-padded up this ladder (a ``name@SEQ_LEN`` companion keeps the
      real lengths), so the PreparedPrograms are bounded by batch buckets
      x sequence buckets whatever the traffic's lengths; outputs come
      back at the padded length.
    * ``select_group``: ``callable({group key: tuple of queued
      requests}) -> key`` picks the group dispatched next (called under
      the server lock: fast, and never calling back into the server); an
      exception warns once and falls back to oldest-request-first.
    * ``aot_warmup()``: one synthetic batch a (sequence bucket, batch
      bucket) pair through the runner at the padded shape the batcher
      will dispatch, so every PreparedProgram is built before traffic;
      returns the builds it caused (``Executor.prepare_count``, the
      port's counterpart of the JAX package's compiles).

    Each setting comes from the argument, else from the predictor
    config's ``serving_options()`` (``enable_dynamic_batching``), else
    the default (8 rows, 2.0 ms, the power-of-two ladder, no sequence
    buckets). ``batch_buckets`` must cover ``max_batch_size``.
    """

    def __init__(self, predictor_or_runner,
                 max_batch_size: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 select_group=None, start: bool = True):
        knobs = None
        if hasattr(predictor_or_runner, "run_batch"):
            runner = predictor_or_runner
        else:
            runner = _PredictorRunner(predictor_or_runner)
            cfg = getattr(predictor_or_runner, "_config", None)
            knobs = getattr(cfg, "serving_options", lambda: None)()
        if knobs:
            if max_batch_size is None:
                max_batch_size = knobs.get("max_batch_size")
            if max_wait_ms is None:
                max_wait_ms = knobs.get("max_wait_ms")
            if batch_buckets is None:
                batch_buckets = knobs.get("batch_buckets")
            if seq_buckets is None and knobs.get("seq_buckets"):
                seq_buckets = knobs["seq_buckets"]
        self._runner = runner
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None else 8)
        self.max_wait_ms = float(
            max_wait_ms if max_wait_ms is not None else 2.0)
        self.batch_buckets = sorted(set(
            batch_buckets or default_batch_buckets(self.max_batch_size)))
        if self.batch_buckets[-1] < self.max_batch_size:
            raise ValueError(
                f"batch_buckets {self.batch_buckets} do not cover "
                f"max_batch_size={self.max_batch_size}")
        self.seq_buckets = sorted(set(int(s) for s in seq_buckets or ()))
        self._feed_names = list(runner.feed_names)
        self._block = runner.program.global_block

        self._cv = threading.Condition()
        # group key -> FIFO of pending requests
        self._groups: Dict[tuple, collections.deque] = {}
        self._running = False
        self._closed = False
        self._accepting = True
        self._inflight = 0
        self._thread: Optional[threading.Thread] = None
        self._select_group_hook = select_group
        self._hook_warned = False

        # counters, under _cv
        self._n_requests = 0
        self._n_batches = 0
        self._n_rows = 0
        self._n_padded_rows = 0
        self._n_done = 0
        self._n_tokens = 0
        self._latencies = Histogram("paddle_tpu_request_latency_ms")
        # one-shot inference delivers its first token with its last: the
        # TTFT histogram equals the latency's, kept so that every
        # server's stats() has one shape
        self._ttft = Histogram("paddle_tpu_request_ttft_ms")
        self._per_token = Histogram("paddle_tpu_per_token_ms")
        self._t_first_arrival = None
        self._t_last_done = None
        self._warmed_compiles = 0
        self._t_start = time.monotonic()
        self._t_window = self._t_start
        self._obs_id = _obs_server_id(self)
        obs_metrics.register_provider(self)
        if start:
            self.start()

    # --- lifecycle ----------------------------------------------------
    def start(self):
        with self._cv:
            if self._running:
                return
            self._running = True
            self._closed = False
            self._accepting = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def quiesce(self):
        """Stop accepting (submit raises ServerQuiesced) while queued
        and in-flight work drains. Idempotent."""
        with self._cv:
            self._accepting = False

    def drain(self, timeout: Optional[float] = 60.0) -> bool:
        """Block until the queue is empty and no batch is in flight.
        True when drained, False on timeout."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._running and (
                    any(self._groups.values()) or self._inflight):
                if deadline is None:
                    self._cv.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return not (any(self._groups.values()) or self._inflight)

    def close(self, timeout: float = 5.0):
        """Stop the batcher; pending requests fail with ServerClosed."""
        with self._cv:
            self._running = False
            self._closed = True
            self._accepting = False
            pending = [r for grp in self._groups.values() for r in grp]
            self._groups.clear()
            self._cv.notify_all()
        for r in pending:
            r.reply.set_exception(ServerClosed("InferenceServer closed"))
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- request path -------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray]) -> _Reply:
        feed = {k: np.asarray(v) for k, v in feed.items()}
        missing = [n for n in self._feed_names if n not in feed]
        if missing:
            raise ValueError(f"missing inputs: {missing}")
        rows = int(feed[self._feed_names[0]].shape[0])
        if rows < 1:
            raise ValueError("empty request: feeds need >= 1 row")
        for n in self._feed_names:
            if feed[n].shape[0] != rows:
                raise ValueError(
                    f"feed {n!r} has {feed[n].shape[0]} rows but "
                    f"{self._feed_names[0]!r} has {rows}; all inputs "
                    f"share the batch axis")
        if rows > self.max_batch_size:
            raise ValueError(
                f"request of {rows} rows exceeds max_batch_size="
                f"{self.max_batch_size}; split it client-side")
        feed, key = self._bucket_seq(feed)
        reply = _Reply()
        # adopt a caller's trace parked in the request context, else (at
        # FLAGS_observability=trace) open a server-owned one
        trace = obs_tracing.current_request_trace()
        if trace is None:
            trace = obs_tracing.start_request(owner="server",
                                              server=self._obs_id)
        req = _Request(feed, rows, reply, trace=trace)
        with self._cv:
            if self._closed:
                raise ServerClosed("InferenceServer is closed")
            if not self._accepting:
                raise ServerQuiesced(
                    "InferenceServer is quiesced (draining); retry "
                    "against its replacement")
            self._groups.setdefault(key, collections.deque()).append(req)
            self._n_requests += 1
            if self._t_first_arrival is None:
                self._t_first_arrival = req.t_arrival
            self._cv.notify_all()
        return reply

    def infer(self, feed: Dict[str, np.ndarray],
              timeout: Optional[float] = 60.0) -> List[np.ndarray]:
        return self.submit(feed).result(timeout)

    # --- bucketing ----------------------------------------------------
    def _declared_shape(self, name):
        v = self._block._find_var_recursive(name)
        return tuple(v.shape) if v is not None and v.shape else None

    def _bucket_seq(self, feed):
        """Pad the declared -1 dims past the batch axis up the sequence
        ladder; returns (padded feed, group key). @SEQ_LEN companions
        keep the real lengths."""
        out = {}
        key = []
        for name in sorted(feed):
            arr = feed[name]
            want = self._declared_shape(name)
            if want is not None and not name.endswith(SEQ_SUFFIX) \
                    and len(want) == arr.ndim and self.seq_buckets:
                for ax in range(1, arr.ndim):
                    if want[ax] == -1:
                        arr = _pad_axis(arr, ax, _bucket_for(
                            arr.shape[ax], self.seq_buckets,
                            f"sequence dim of {name!r}"))
            out[name] = arr
            key.append((name, arr.shape[1:], str(arr.dtype)))
        return out, tuple(key)

    # --- batcher thread -----------------------------------------------
    def _oldest_group(self):
        best = None
        for key, grp in self._groups.items():
            if grp and (best is None
                        or grp[0].t_arrival
                        < self._groups[best][0].t_arrival):
                best = key
        return best

    def _pick_group(self):
        """The next group to dispatch: the hook's pick when set and
        valid, else oldest-request-first. Called under _cv."""
        hook = self._select_group_hook
        if hook is not None and any(self._groups.values()):
            ok, key = _call_scheduling_hook(
                self, hook,
                {k: tuple(g) for k, g in self._groups.items() if g},
                "select_group", "oldest-first")
            if ok and key in self._groups and self._groups[key]:
                return key
        return self._oldest_group()

    def _loop(self):
        while True:
            with self._cv:
                while self._running and self._oldest_group() is None:
                    self._cv.wait()
                if not self._running:
                    return
                key = self._pick_group()
                grp = self._groups[key]
                deadline = grp[0].t_arrival + self.max_wait_ms / 1e3
                while self._running:
                    rows = sum(r.rows for r in grp)
                    now = time.monotonic()
                    if rows >= self.max_batch_size or now >= deadline:
                        break
                    self._cv.wait(timeout=deadline - now)
                    grp = self._groups.get(key)
                    if not grp:
                        break  # close() drained us
                if not self._running:
                    return
                grp = self._groups.get(key)
                if not grp:
                    continue
                batch, taken = [], 0
                while grp and taken + grp[0].rows <= self.max_batch_size:
                    r = grp.popleft()
                    batch.append(r)
                    taken += r.rows
                if not grp:
                    del self._groups[key]
                self._inflight += 1  # drain() waits on this
            try:
                self._dispatch(batch, taken)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _dispatch(self, batch: List[_Request], rows: int):
        bucket = _bucket_for(rows, self.batch_buckets, "batch rows")
        traces = [r.trace for r in batch if r.trace is not None]
        exe = self._runner.executor
        c0, d0 = exe.prepare_count, exe.disk_load_count
        t_d0 = time.monotonic()
        try:
            feed = {
                name: _pad_rows(
                    np.concatenate([r.feed[name] for r in batch], axis=0)
                    if len(batch) > 1 else batch[0].feed[name],
                    bucket)
                for name in batch[0].feed}
            with obs_tracing.ambient(traces):
                outs = self._runner.run_batch(feed)
        except Exception as e:  # the caller of each request gets it
            for r in batch:
                # the span before the future: its done-callback may
                # finish a caller-owned trace, which then takes no more
                if r.trace is not None:
                    r.trace.add_span("server.queue", r.t_arrival, t_d0)
                r.reply.set_exception(e)
                if r.trace is not None and r.trace.owner == "server":
                    r.trace.finish(status="error", error=repr(e))
            return
        done_t = time.monotonic()
        for r in batch:
            if r.trace is not None:
                # queue: arrival to the batch; dispatch: the padded
                # batch's runner call (its execute and readback spans
                # were recorded inside run_batch)
                r.trace.add_span("server.queue", r.t_arrival, t_d0)
                r.trace.add_span("server.dispatch", t_d0, done_t,
                                 rows=rows, bucket=bucket,
                                 cache=_cache_tier(exe, c0, d0))
        # counters BEFORE fulfilling the futures: a caller unblocked by
        # set_result may read stats() at once and must see this batch
        with self._cv:
            self._n_batches += 1
            self._n_rows += rows
            self._n_padded_rows += bucket
            off = 0
            for r in batch:
                lat = (done_t - r.t_arrival) * 1e3
                self._latencies.observe(lat)
                self._ttft.observe(lat)
                ntok = self._tokens_in_rows(outs[0][off:off + r.rows])
                if ntok:
                    self._n_tokens += ntok
                    self._per_token.observe(lat / ntok)
                self._n_done += 1
                off += r.rows
            self._t_last_done = done_t
        off = 0
        for r in batch:
            r.reply.set_result([o[off:off + r.rows] for o in outs])
            off += r.rows
            if r.trace is not None and r.trace.owner == "server":
                r.trace.finish()

    def _tokens_in_rows(self, rows) -> Optional[int]:
        """Generated-token count of one request's output rows, or None
        for a program that does not generate."""
        return None

    # --- AOT warmup ---------------------------------------------------
    def _warmup_feed_specs(self):
        """A synthetic feed a bucket pair, from the program's declared
        shapes: the batch -1 takes each batch bucket, the other -1 dims
        each sequence bucket (every sequence-bucketed input moves
        together)."""
        shapes = {}
        needs_seq = False
        for name in self._feed_names:
            want = self._declared_shape(name)
            if want is None:
                raise ValueError(
                    f"aot_warmup: feed {name!r} has no declared shape in "
                    f"the program; warm manually via infer()")
            if any(d == -1 for d in want[1:]):
                needs_seq = True
            shapes[name] = want
        if needs_seq and not self.seq_buckets:
            raise ValueError(
                "aot_warmup: the program declares -1 sequence dims; pass "
                "seq_buckets=(...) so warmup knows the ladder")
        for seq in (self.seq_buckets if needs_seq else [None]):
            for b in self.batch_buckets:
                feed = {}
                for name, want in shapes.items():
                    v = self._block._find_var_recursive(name)
                    dt = to_np_dtype(v.dtype) if v is not None \
                        and v.dtype is not None else np.float32
                    if name.endswith(SEQ_SUFFIX):
                        bw = shapes.get(name[:-len(SEQ_SUFFIX)])
                        full = seq if (bw is not None and any(
                            d == -1 for d in bw[1:])) \
                            else (bw[1] if bw and len(bw) > 1 else 1)
                        feed[name] = np.full((b,), full, dtype=dt)
                    else:
                        feed[name] = np.zeros(
                            [b] + [seq if d == -1 else d
                                   for d in want[1:]], dtype=dt)
                yield feed

    def aot_warmup(self) -> int:
        """Build every bucket's PreparedProgram before traffic: one
        synthetic batch a (sequence bucket x batch bucket) pair goes
        straight through the runner at the padded shape the batcher will
        dispatch (queued probes would coalesce into one batch). Returns
        the PreparedPrograms built (``Executor.prepare_count``)."""
        exe = self._runner.executor
        before = exe.prepare_count
        evict_before = exe.cache_evict_count
        for feed in self._warmup_feed_specs():
            self._runner.run_batch(feed)
        if exe.cache_evict_count > evict_before:
            warnings.warn(
                f"aot_warmup: the bucket ladder overflowed the executor's "
                f"bounded cache ({exe.cache_evict_count - evict_before} "
                f"eviction(s)); early buckets will be built again inside "
                f"the traffic. Raise FLAGS_executor_cache_capacity above "
                f"the ladder's size.")
        self._warmed_compiles = exe.prepare_count - before
        return self._warmed_compiles

    # --- observability ------------------------------------------------
    def stats(self, reset: bool = False) -> dict:
        """Atomic snapshot of the serving counters; reset=True zeroes
        the window counters under the same lock. The executor's counters
        are cumulative: ``compile_count`` its CUDA-graph captures,
        ``prepare_count`` its PreparedProgram builds."""
        exe = self._runner.executor
        with self._cv:
            now = time.monotonic()
            occ = (self._n_rows / self._n_padded_rows
                   if self._n_padded_rows else None)
            done_span = (
                self._t_last_done - self._t_first_arrival
                if self._t_last_done is not None
                and self._t_first_arrival is not None else None)
            snap = {
                "requests": self._n_requests,
                "completed": self._n_done,
                "batches": self._n_batches,
                "rows": self._n_rows,
                "padded_rows": self._n_padded_rows,
                "batch_occupancy": round(occ, 4) if occ else None,
                "queue_depth": sum(len(g) for g in self._groups.values()),
                "uptime_s": round(now - self._t_start, 3),
                "window_s": round(now - self._t_window, 3),
                "compile_count": exe.compile_count,
                "prepare_count": exe.prepare_count,
                "cache_hit_count": exe.cache_hit_count,
                "disk_load_count": exe.disk_load_count,
                "cache_evict_count": exe.cache_evict_count,
                "warmed_compiles": self._warmed_compiles,
                "latency_ms": _pct_dict(self._latencies),
                "ttft_ms": _pct_dict(self._ttft),
                "per_token_ms": _pct_dict(self._per_token),
                "tokens": self._n_tokens,
                "retired_per_s": (round(self._n_done / done_span, 1)
                                  if done_span else None),
            }
            if reset:
                self._n_requests = self._n_batches = 0
                self._n_rows = self._n_padded_rows = 0
                self._n_done = self._n_tokens = 0
                self._latencies.clear()
                self._ttft.clear()
                self._per_token.clear()
                self._t_first_arrival = None
                self._t_last_done = None
                self._t_window = now
            return snap

    def _metrics_samples(self):
        """Pull-provider for observability.metrics.expose(): the
        counters stats() reports, as Prometheus samples."""
        lab = {"server": self._obs_id}
        with self._cv:
            occ = (self._n_rows / self._n_padded_rows
                   if self._n_padded_rows else 0.0)
            return [
                ("paddle_tpu_server_requests_total", lab,
                 self._n_requests),
                ("paddle_tpu_server_completed_total", lab, self._n_done),
                ("paddle_tpu_server_batches_total", lab, self._n_batches),
                ("paddle_tpu_server_queue_depth", lab,
                 sum(len(g) for g in self._groups.values())),
                ("paddle_tpu_server_batch_occupancy", lab, occ),
                ("paddle_tpu_server_tokens_total", lab, self._n_tokens),
                ("paddle_tpu_request_latency_ms", lab, self._latencies),
                ("paddle_tpu_request_ttft_ms", lab, self._ttft),
                ("paddle_tpu_per_token_ms", lab, self._per_token),
            ]


class GenerationServer(InferenceServer):
    """Dynamic-batching server for autoregressive generation over the
    KV-cached incremental decode program: the whole greedy loop is one
    program run, so a served generation costs one run and one readback
    whatever its length.

    ``generate(src_ids)`` takes one source row ([T] or [1, T]) or a
    [B, T] block and returns the token buffer rows of the real rows.
    With ``end_id`` set, positions after the first emitted end_id
    become the -1 sentinel, so the result does not depend on which
    requests the batcher happened to co-batch.
    """

    def __init__(self, program, out_var, feed_name: str = "src_ids",
                 executor: Optional[Executor] = None, scope=None,
                 end_id: Optional[int] = None, **kwargs):
        out_name = getattr(out_var, "name", out_var)
        runner = ProgramRunner(program, [feed_name], [out_name],
                               executor=executor, scope=scope)
        self._end_id = end_id
        super().__init__(runner, **kwargs)

    def generate(self, src_ids, timeout: Optional[float] = 120.0):
        arr = np.asarray(src_ids)
        one_row = arr.ndim == 1
        if one_row:
            arr = arr[None]
        toks = self.infer({self._feed_names[0]: arr}, timeout=timeout)[0]
        toks = apply_eos_sentinel(toks, self._end_id)
        return toks[0] if one_row else toks

    def _tokens_in_rows(self, rows) -> Optional[int]:
        return int(count_generated_tokens(rows, self._end_id).sum())

    def stats(self, reset: bool = False) -> dict:
        st = super().stats(reset=reset)
        st["slots"] = self.max_batch_size
        st["slot_occupancy"] = st["batch_occupancy"]
        return st


def count_generated_tokens(tokens: np.ndarray,
                           end_id: Optional[int]) -> np.ndarray:
    """Per-row generated-token count of a [B, maxT] decode buffer:
    positions 1..first-end_id inclusive, maxT-1 when the row never
    emitted end_id."""
    toks = np.asarray(tokens)
    if end_id is None:
        return np.full((toks.shape[0],), toks.shape[1] - 1,
                       dtype=np.int64)
    hit = toks[:, 1:] == end_id
    return np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                    toks.shape[1] - 1).astype(np.int64)


def apply_eos_sentinel(tokens: np.ndarray,
                       end_id: Optional[int]) -> np.ndarray:
    """Rewrite positions strictly after each row's first `end_id` to -1
    (the first end_id itself stays as the terminator; position 0, the
    GO token, never counts)."""
    if end_id is None:
        return tokens
    toks = np.array(tokens, copy=True)
    hit = toks[:, 1:] == end_id
    first = np.where(hit.any(axis=1), hit.argmax(axis=1) + 1,
                     toks.shape[1])
    pos = np.arange(toks.shape[1])[None, :]
    toks[pos > first[:, None]] = -1
    return toks


# ---------------------------------------------------------------------------
# Continuous batching over a slot pool (dense and paged KV).
# ---------------------------------------------------------------------------
class RequestCancelled(ServingUnavailable):
    """The outcome of ``reply.cancel()``: the request was torn down
    (dequeued, or its lane retired at the next burst boundary with its
    blocks and prompt entry released). Not retryable."""

    retryable = False


class DeadlineExceeded(ServingUnavailable):
    """A request's ``deadline_ms`` expired while it was queued or still
    decoding; it was torn down as a cancel is. Not retryable as it is."""

    retryable = False


class GenerationReply(futures.Future):
    """Whole-response future of one continuous-batching request, whose
    ``cancel()`` goes through the server: the lane retires at the next
    burst boundary and releases what it holds, and the reply fails with
    ``RequestCancelled``. True when the cancel was taken, False when
    the outcome was already decided."""

    _gen_server = None
    _gen_req = None

    def cancel(self):
        srv, req = self._gen_server, self._gen_req
        if srv is not None and req is not None:
            return srv._cancel_request(req, "cancelled")
        return super().cancel()


class StreamingReply:
    """The per-token delivery handle ``submit(stream=True)`` returns.

    Iterating yields ``(seq, token)`` pairs as bursts land: ``seq`` a
    monotone 0-based sequence number, ``token`` a python int. Tokens come
    from the per-burst readback the scheduler already performs: streaming
    adds no fetch and no program. Iteration ends after the final token;
    ``finish_reason`` then reads "eos" | "length" | "cancelled" |
    "deadline" | "error".

    Byte parity: the streamed tokens, concatenated, equal the generated
    region ``row[1:1+n]`` of the sentinel-normalized row the
    whole-response path returns for the same submit (``n`` =
    ``count_generated_tokens``; position 0, the GO token, and the -1
    tail are not streamed), and ``result(timeout)`` returns that row.

    ``cancel()`` tears the request down as ``GenerationReply.cancel``
    does (iteration ends with "cancelled" and ``result`` raises
    ``RequestCancelled``). ``ttft_s`` is the wall time from submit to the
    first token's arrival here. One scheduler produces; any number of
    consumer threads may iterate (each event is delivered once)."""

    def __init__(self, server):
        self._cond = threading.Condition()
        self._events = collections.deque()  # (seq, int token)
        self._fin = None        # finish_reason once decided
        self._exc = None
        self._server = server
        self._req = None        # set by submit()
        self._future = None     # the underlying GenerationReply
        self.t_submit = time.monotonic()
        self.t_first = None     # when the first token landed

    # --- consumer side -------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            while not self._events and self._fin is None:
                self._cond.wait()
            if self._events:
                return self._events.popleft()
            raise StopIteration

    def result(self, timeout: Optional[float] = None):
        """The whole sentinel-normalized row (raises RequestCancelled,
        DeadlineExceeded or the dispatch's error on teardown)."""
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    def cancel(self) -> bool:
        return self._server._cancel_request(self._req, "cancelled")

    @property
    def finish_reason(self) -> Optional[str]:
        with self._cond:
            return self._fin

    @property
    def ttft_s(self) -> Optional[float]:
        with self._cond:
            if self.t_first is None:
                return None
            return self.t_first - self.t_submit

    # --- producer side (the scheduler thread, outside the server lock) -
    def _push(self, first_seq: int, toks) -> None:
        now = time.monotonic()
        with self._cond:
            if self.t_first is None:
                self.t_first = now
            for i, t in enumerate(toks):
                self._events.append((first_seq + i, int(t)))
            self._cond.notify_all()

    def _finish(self, reason: str, exc=None) -> None:
        with self._cond:
            if self._fin is None:
                self._fin = reason
                self._exc = exc
            self._cond.notify_all()


# the device's speculative counters, in fetch order
_SPEC_COUNTERS = ("proposed", "accepted", "emitted", "draft_steps",
                  "target_steps")


class _GenRequest:
    __slots__ = ("src", "reply", "t_arrival", "t_first", "t_admit",
                 "trace", "seed", "session", "harvest", "radix", "stream",
                 "stream_cb", "deadline", "cancel_reason", "finalized",
                 "emitted", "n_streamed")

    def __init__(self, src, reply, trace=None, seed=0, session=None,
                 harvest=True, stream=None, stream_cb=None, deadline=None):
        self.src = src
        self.reply = reply
        self.t_arrival = time.monotonic()
        self.t_first = None  # when its first token landed
        self.t_admit = None  # when a slot admitted it
        self.trace = trace   # see _Request.trace
        # the noise seed of a sampled bundle's draws (fed at admission)
        self.seed = seed
        # chat-session id (paged radix tier); the branches of an n-best
        # fan-out carry harvest=False: they never extend the session's
        # history
        self.session = session
        self.harvest = harvest
        # the admission's radix plan (history, resume step, history
        # length), written by the paged scheduler under its lock
        self.radix = None
        # streaming: the StreamingReply (None: whole response only) and
        # the callback form; `emitted` is the highest token-buffer
        # position delivered (0: only the GO token, never streamed) and
        # survives a preemption, whose byte-exact re-decode then resumes
        # delivery without duplicates; `n_streamed` is the next sequence
        # number
        self.stream = stream
        self.stream_cb = stream_cb
        self.deadline = deadline  # absolute time.monotonic() instant
        # the one-way teardown mark ("cancelled" | "deadline"), and the
        # scheduler's commit, under its lock, that the outcome is decided
        self.cancel_reason = None
        self.finalized = False
        self.emitted = 0
        self.n_streamed = 0


class ContinuousGenerationServer:
    """Continuous-batching generation over a fixed slot pool
    (``serving.py:1109`` in the JAX package; iteration-level scheduling
    as in Orca, slot-based KV as in vLLM).

    Wraps a ``build_decode_step_program`` bundle: KV caches, token
    buffers, per-lane step counters and the active mask live as
    persistable scope state on the executor's device, and the host loops
    over fused scheduler cycles, each one run of a ``bundle.serves``
    program:

      admit   FIFO: up to A oldest queued prompts fill free slots (A from
              the power-of-two admission ladder; padded rows land on
              the dustbin lane);
      step    the same run then advances every live lane up to
              ``steps_per_tick`` tokens in a device While that exits
              early when lanes go idle (or, with ``exit_on_retire``, the
              moment one retires);
      retire  lanes whose active flag dropped (EOS, or the buffer is
              full) are read back, sentinel-normalized
              (``apply_eos_sentinel``) and their futures fulfilled; the
              slot is free for the next arrival at once.

    Greedy parity: a lane's row equals the whole-loop decode of the same
    prompt, whatever the admission order or slot: the step's math is
    the whole-loop body and every op is row-wise.

    Sampled bundles: each request's draws are keyed on its seed and the
    position alone, so its tokens do not depend on the admission order,
    the slot or the burst length.

    Speculative bundles (``DraftConfig``): a tick verifies k proposals a
    lane and emits 1..k+1 tokens; greedy speculation is token-exact
    against the plain decode. ``stats()["speculative"]`` holds the
    window's proposed, accepted and emitted counts and the draft and
    target steps. A bundle with a k ladder (``k_options``) runs under a
    ``spec_controller`` (a ``SpecController`` built from the ladder
    unless the caller passes one), which picks the rung of every
    admission or tick-only dispatch from the per-lane acceptance; the
    per-rung windows are in ``stats()["speculative"]["per_k"]``.

    Cancellation (``reply.cancel()``) and ``deadline_ms`` tear a request
    down at the next planning pass or burst boundary. Chat sessions and
    n-best fan-out need the radix serves of a paged bundle
    (``PagedContinuousGenerationServer``); this server refuses them, as
    the JAX package's does. ``admit_select`` (``callable(tuple of queued
    requests) -> index``) picks the next admission instead of FIFO; an
    exception warns once and falls back to FIFO. ``mesh_devices`` (a
    tensor-parallel bundle) is not ported and raises.

    Observability (``FLAGS_observability``): at ``trace`` a request
    carries a span tree (queue, dispatch with the burst's ticks, exit
    reason and expected against actual tick time, decode); cancels,
    deadlines and errors are flight-recorder incidents from ``metrics``
    up; ``expected_service_ms`` estimates a request's decode time from
    the cost model calibrated on this server's own bursts.
    """

    # how long a cycle with nothing to dispatch sleeps before it plans
    # again (a handoff, a submit or a cancel wakes it at once)
    _IDLE_WAIT_S = 0.01

    def __init__(self, bundle, executor=None, scope=None,
                 steps_per_tick: Optional[int] = None,
                 drain_steps: Optional[int] = None,
                 exit_on_retire: bool = False, admit_select=None,
                 start: bool = True, mesh_devices=None,
                 spec_controller=None):
        if type(self) is ContinuousGenerationServer \
                and bundle.cache.layout != "dense":
            raise ValueError(
                f"ContinuousGenerationServer serves DENSE bundles; this "
                f"bundle's KV layout is {bundle.cache.layout!r} -- use "
                f"PagedContinuousGenerationServer")
        if mesh_devices is not None:
            raise NotImplementedError(
                "mesh_devices places a tensor-parallel bundle, which is "
                "not ported yet (serving step 10 of the port: "
                "ShardingConfig)")
        self.bundle = bundle
        self.executor = executor or Executor(CUDAPlace(0))
        self.scope = scope or global_scope()
        # steps_per_tick bounds the burst while requests queue (a
        # retired lane's slot refills only at the next cycle);
        # drain_steps bounds the empty-queue burst
        self.steps_per_tick = int(steps_per_tick) \
            if steps_per_tick is not None else 8
        self.drain_steps = int(drain_steps) if drain_steps is not None \
            else bundle.max_out_len
        self.exit_on_retire = bool(exit_on_retire)
        self.n_slots = bundle.n_slots
        self._end_id = bundle.end_id
        bundle.init_slot_state(self.scope, self.executor.device)
        # sampled and speculative bundles: per-request seeds in every
        # admission feed
        self._needs_seeds = bool(getattr(bundle, "needs_seeds", False))
        # speculation: tokens a lane may emit a tick (the paged scheduler
        # sizes block coverage by it) and the device counters
        self._spec_k = int(getattr(bundle, "spec_k", 0))
        self._toks_per_tick = int(getattr(bundle, "tokens_per_tick", 1))
        spec = self._spec_k > 0
        self._spec_names = [bundle.state[c] for c in (
            "spec_proposed", "spec_accepted", "spec_emitted",
            "spec_draft_steps", "spec_target_steps")] if spec else []
        self._spec_tot = dict.fromkeys(_SPEC_COUNTERS, 0)
        self._spec_base = dict(self._spec_tot)
        # the per-lane acceptance counters, the controller's signal
        self._lane_names = [bundle.state[c] for c in (
            "spec_lane_accepted", "spec_lane_ticks")] if spec else []
        self._lane_tot = [None] * len(self._lane_names)
        self._spec_k_options = tuple(
            getattr(bundle, "spec_k_options", ()) or ())
        if spec_controller is None and self._spec_k_options:
            draft = bundle.draft
            spec_controller = SpecController(
                self._spec_k_options, default_k=self._spec_k,
                draft_cost_ratio=0.0 if draft.kind == "ngram" else 0.25)
        self._spec_ctl = spec_controller
        if self._spec_ctl is not None and not self._spec_k_options:
            raise ValueError(
                "spec_controller given but the bundle has no k ladder -- "
                "build it with DraftConfig(k_options=...)")
        # per-rung windows: a fused dispatch runs the whole pool at one
        # rung, so its counter deltas belong to that rung
        self._per_k_tot: Dict[int, dict] = {
            k: dict.fromkeys(("dispatches", "proposed", "accepted",
                              "emitted"), 0)
            for k in self._spec_k_options}
        self._per_k_base = {k: dict(v) for k, v in self._per_k_tot.items()}
        acc_buckets = tuple(round(0.1 * i, 1) for i in range(1, 11))
        self._acc_hist_k = {
            k: Histogram(f"paddle_tpu_spec_acceptance_rate_k{k}",
                         buckets=acc_buckets)
            for k in self._spec_k_options if k > 0}
        # accepted over proposed, one sample a dispatch
        self._acc_hist = Histogram("paddle_tpu_spec_acceptance_rate",
                                   buckets=acc_buckets)
        self._devtel = obs_devtel.DeviceTelemetry(bundle)
        # the cost model's snapshot of each serve key, resolved at the
        # key's first dispatch at FLAGS_observability >= metrics
        self._cost_snaps: Dict[object, dict] = {}
        before = self.executor.prepare_count
        st = bundle.state
        self._fetches = [st["tok_buf"], st["step"], st["active"],
                         st["finished"]] + self._spec_names \
            + self._lane_names + self._devtel.fetch_names
        # where the device telemetry starts in a dispatch's fetches
        self._tel_off = 4 + len(self._spec_names) + len(self._lane_names)
        self._serves = {
            key: self.executor.prepare(
                prog, feed=bundle.serve_feed_spec(key),
                fetch_list=self._fetches, scope=self.scope)
            for key, prog in bundle.serves.items()
            if not self._skip_serve_key(key)}
        self._admit_buckets = sorted(
            {k for k in self._serves if isinstance(k, int) and k > 0}
            | {k[1] for k in self._serves if isinstance(k, tuple)
               and k[0] not in ("chunked", "k")})
        # the radix tier (sessions, n_best, plain-prompt reuse) needs
        # ("radix", A) serves, which only paged bundles build
        self._radix_ok = any(isinstance(k, tuple) and k[0] == "radix"
                             for k in self._serves)
        self._warmed_compiles = self.executor.prepare_count - before
        # lanes the paged scheduler parked for lack of a KV block
        # (always empty on the dense server); retirement skips them
        self._paused: set = set()

        self._cv = threading.Condition()
        self._queue: "collections.deque[_GenRequest]" = \
            collections.deque()
        self._lanes: List[Optional[_GenRequest]] = [None] * self.n_slots
        self._running = False
        self._closed = False
        self._accepting = True
        self._busy = False      # a fused cycle is mid-dispatch
        self._thread: Optional[threading.Thread] = None
        # admission order: callable(tuple of queued requests) -> index,
        # called under the server lock; FIFO when None
        self._admit_select = admit_select
        self._hook_warned = False

        self._n_requests = 0
        self._n_done = 0
        self._n_tokens = 0
        self._n_ticks = 0
        self._occ_sum = 0.0
        self._n_cancelled = 0
        self._n_deadline = 0
        self._latencies = Histogram("paddle_tpu_request_latency_ms")
        self._ttft = Histogram("paddle_tpu_request_ttft_ms")
        self._per_token = Histogram("paddle_tpu_per_token_ms")
        self._t_first_arrival = None
        self._t_last_done = None
        self._t_start = time.monotonic()
        self._t_window = self._t_start
        self._obs_id = _obs_server_id(self)
        obs_metrics.register_provider(self)
        if start:
            self.start()

    # --- lifecycle ----------------------------------------------------
    def start(self):
        with self._cv:
            if self._running:
                return
            self._running = True
            self._closed = False
            self._accepting = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def quiesce(self):
        """Stop accepting (submit raises ServerQuiesced); queued prompts
        and live lanes run to completion. Idempotent."""
        with self._cv:
            self._accepting = False

    def drain(self, timeout: Optional[float] = 60.0) -> bool:
        """Block until the queue is empty, every lane retired and no
        cycle is mid-dispatch. True when drained, False on timeout."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            def dirty():
                return (self._queue or self._busy
                        or any(l is not None for l in self._lanes)
                        or self._has_background_work_locked()
                        or self._has_pending_external_locked())

            while self._running and dirty():
                if deadline is None:
                    self._cv.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return not dirty()

    def close(self, timeout: float = 5.0):
        with self._cv:
            self._running = False
            self._closed = True
            self._accepting = False
            pending = list(self._queue)
            self._queue.clear()
            for slot, r in enumerate(self._lanes):
                if r is not None:
                    self._release_lane(slot, r)
                    pending.append(r)
            self._lanes = [None] * self.n_slots
            bg = self._background_abort_locked()
            if bg is not None:
                pending.append(bg)
            for r in pending:
                r.finalized = True
            self._flush_requests_locked(pending)
            self._cv.notify_all()
        self._fail_requests([(r, ServerClosed(
            "ContinuousGenerationServer closed")) for r in pending])
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- request path -------------------------------------------------
    def submit(self, src_ids, seed=None, session_id=None,
               extend_tokens=None, n_best=1, stream=False, stream_cb=None,
               deadline_ms=None):
        """Enqueue one prompt row of exactly seq_len tokens; returns a
        ``GenerationReply``. ``deadline_ms`` is a completion budget from
        now: a request still queued or decoding past it is torn down and
        fails with ``DeadlineExceeded``. ``seed`` keys a sampled bundle's
        draws (default: ``zlib.crc32`` of the prompt's int64 bytes, as the
        JAX package computes it); greedy bundles draw nothing.

        * ``stream=True`` returns a ``StreamingReply`` instead: tokens
          arrive a burst at a time from the readback the scheduler
          already does (a speculative burst delivers each tick's accepted
          run), so TTFT becomes the first burst's latency.
        * ``stream_cb``: ``cb(tokens, first_seq, finish_reason)`` is
          called from the scheduler thread, outside its lock, with a
          fresh int64 chunk and the sequence number of its first token;
          the last call carries an empty chunk and the finish reason. The
          whole-response reply is returned as without it.

        Paged servers (the radix tier; elsewhere these raise):

        * ``session_id``: a multi-turn chat session. The first turn
          decodes as a plain request; when it retires, the full blocks
          behind its tokens join the server's radix tree and its history
          is kept. The next submit with the same session_id (and the
          same prompt: the bidirectional encoder ties every KV chain to
          the whole prompt) admits through the encoder-free radix tier:
          the longest shared block prefix is mapped read-only, only the
          divergent tail is replayed teacher-forced, and decoding
          resumes where the history ends.
        * ``extend_tokens``: appended to the session's history before
          the turn runs (the user's turn in the decoder stream); needs a
          session with a retired turn. Submit the next turn after the
          previous one resolved.
        * ``n_best``: n requests sharing the prompt entry (and, in a
          session, the chain); returns a list of replies. Branch i draws
          with seed ``seed + i``, so sampled branches differ; greedy
          branches are identical. The branches never extend the
          session's history.
        """
        arr = np.asarray(src_ids)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.shape != (1, self.bundle.seq_len):
            raise ValueError(
                f"continuous generation takes one prompt row of exactly "
                f"seq_len={self.bundle.seq_len} tokens; got shape "
                f"{tuple(np.asarray(src_ids).shape)}")
        arr = arr.astype(np.int64)
        n_best = int(n_best)
        if n_best < 1:
            raise ValueError(f"n_best must be >= 1, got {n_best}")
        if (session_id is not None or n_best > 1) and not self._radix_ok:
            raise ValueError(
                "session_id/n_best need the radix serve tier: a PAGED "
                "bundle served by PagedContinuousGenerationServer")
        if extend_tokens is not None and session_id is None:
            raise ValueError(
                "extend_tokens extends an existing chat session; pass "
                "session_id")
        if (stream or stream_cb is not None) and n_best > 1:
            raise ValueError(
                "streaming delivers one ordered token sequence; n_best "
                "fan-out returns whole-response replies -- submit the "
                "branches separately to stream them")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        deadline = (time.monotonic() + float(deadline_ms) / 1e3
                    if deadline_ms is not None else None)
        if seed is None:
            seed = zlib.crc32(arr.tobytes())
        reqs = []
        for i in range(n_best):
            trace = obs_tracing.current_request_trace() if i == 0 \
                else None
            if trace is None:
                trace = obs_tracing.start_request(owner="server",
                                                  server=self._obs_id)
            reply = GenerationReply()
            sreply = StreamingReply(self) if stream else None
            req = _GenRequest(arr, reply, trace=trace, seed=int(seed) + i,
                              session=session_id, harvest=(n_best == 1),
                              stream=sreply, stream_cb=stream_cb,
                              deadline=deadline)
            reply._gen_server = self
            reply._gen_req = req
            if sreply is not None:
                sreply._req = req
                sreply._future = reply
            reqs.append(req)
        with self._cv:
            if self._closed:
                raise ServerClosed("ContinuousGenerationServer is closed")
            if not self._accepting:
                raise ServerQuiesced(
                    "ContinuousGenerationServer is quiesced (draining); "
                    "retry against its replacement")
            if session_id is not None:  # paged only: the gate above
                self._session_submit_locked(session_id, arr,
                                            extend_tokens)
            self._queue.extend(reqs)
            self._n_requests += len(reqs)
            if self._t_first_arrival is None:
                self._t_first_arrival = reqs[0].t_arrival
            self._cv.notify_all()
        if stream:
            return reqs[0].stream
        return reqs[0].reply if n_best == 1 else [r.reply for r in reqs]

    def generate(self, src_ids, timeout: Optional[float] = 120.0,
                 seed=None):
        """One prompt row in, one sentinel-normalized [max_out_len] row
        out."""
        return self.submit(src_ids, seed=seed).result(timeout)

    def expected_service_ms(self, n_tokens=None) -> Optional[float]:
        """The cost model's estimate of one request's decode time for
        ``n_tokens`` (default the bundle's max_out_len): the expected
        wall of one tick of the key-0 serve (its While body costed once,
        divided by the achieved rate calibrated on this process's
        bursts, whose samples are tick-flops x ticks over a burst's wall,
        so the host's per-burst cost is already in the per-tick figure)
        times the ticks the request needs. None until calibrated. Lanes
        decode in lockstep, so co-residents do not stretch it; queue wait
        is the caller's term."""
        snap = obs_costmodel.lookup(self.bundle.serves[0]) or {}
        per_tick = obs_costmodel.expected_ms(snap.get("flops"))
        if per_tick is None:
            return None
        toks = self.bundle.max_out_len if n_tokens is None \
            else max(1, int(n_tokens))
        return per_tick * math.ceil(toks / max(1, self._toks_per_tick))

    # --- cancellation and deadlines -----------------------------------
    def _cancel_request(self, req, reason: str) -> bool:
        """Mark the request under the scheduler lock and wake the loop;
        the scheduler thread releases its state. False when the outcome
        was already decided."""
        with self._cv:
            if req is None or req.finalized:
                return False
            if req.cancel_reason is None:
                req.cancel_reason = reason
            self._cv.notify_all()
        return True

    def _expired_locked(self, req, now: float) -> Optional[str]:
        reason = req.cancel_reason
        if reason is None and req.deadline is not None \
                and now > req.deadline:
            reason = req.cancel_reason = "deadline"
        return reason

    def _count_cancel_locked(self, reason: str):
        if reason == "deadline":
            self._n_deadline += 1
        else:
            self._n_cancelled += 1

    def _drop_queued_locked(self, req):
        """Hook: a queued request is being shed (cancel or deadline); drop
        what it holds without a lane (the paged server: the entry ref of a
        disaggregated handoff). Called under _cv."""

    def _shed_cancelled_locked(self, now: float):
        """Drop cancelled and expired requests from the queue before
        admission; returns the (req, reason) pairs to fail outside the
        lock."""
        out = []
        kept = collections.deque()
        for req in self._queue:
            reason = self._expired_locked(req, now)
            if reason is None:
                kept.append(req)
            else:
                req.finalized = True
                self._drop_queued_locked(req)
                self._count_cancel_locked(reason)
                out.append((req, reason))
        self._queue = kept
        return out

    def _cancel_lane_locked(self, slot, req, reason: str):
        """Burst-boundary teardown of a live lane: its holds go back
        through _release_lane, as at retirement, without the harvest (a
        torn-down turn must not extend a session's history)."""
        req.harvest = False
        req.finalized = True
        self._release_lane(slot, req)
        self._lanes[slot] = None
        self._paused.discard(slot)
        self._count_cancel_locked(reason)

    def _deliver_stream(self, req, first_seq: int, chunk):
        """Push one burst's new tokens to the request's streams (the
        scheduler thread, outside the lock: stream_cb is user code)."""
        if req.stream is not None:
            req.stream._push(first_seq, chunk)
        if req.stream_cb is not None:
            try:
                req.stream_cb(chunk, first_seq, None)
            except Exception as e:
                if not self._hook_warned:
                    self._hook_warned = True
                    warnings.warn(
                        f"stream_cb raised ({type(e).__name__}: {e}); "
                        f"further failures are silent")

    @staticmethod
    def _finish_stream(req, reason: str, exc=None):
        """The terminal stream event (outside the lock): ends the
        StreamingReply's iteration and makes the last stream_cb call (an
        empty chunk and the finish reason)."""
        if req.stream is not None:
            req.stream._finish(reason, exc)
        if req.stream_cb is not None:
            try:
                req.stream_cb(np.empty(0, np.int64), req.n_streamed, reason)
            except Exception:
                pass

    def _finalize_cancelled(self, cancels):
        """Fail torn-down requests with the typed error and seal their
        record (outside the lock): the span tree carries the reason and
        the request is kept as a flight-recorder incident."""
        for req, reason in cancels:
            exc = DeadlineExceeded(
                "deadline_ms expired before completion; request torn "
                "down") if reason == "deadline" else RequestCancelled(
                "request cancelled by client")
            self._finish_stream(req, reason, exc)
            try:
                req.reply.set_exception(exc)
            except futures.InvalidStateError:
                pass
            if req.trace is not None and req.trace.owner == "server":
                req.trace.finish(status="cancelled", reason=reason,
                                 error=repr(exc))
            elif obs_metrics.metrics_on():
                obs_flight.RECORDER.record(
                    {"request_id": obs_tracing.TRACER.next_request_id(),
                     "status": "cancelled", "reason": reason,
                     "server": self._obs_id, "error": repr(exc)},
                    incident=True)

    # --- scheduler ----------------------------------------------------
    def _pop_next(self):
        """The next queued request to admit: FIFO, or the admit_select
        hook's pick (an index into the queue). Called under _cv with a
        non-empty queue."""
        hook = self._admit_select
        idx = 0
        if hook is not None and len(self._queue) > 1:
            # an int() failure counts as the hook's (warned), an index out
            # of range as a silent decline
            ok, raw = _call_scheduling_hook(
                self, lambda q: int(hook(q)), tuple(self._queue),
                "admit_select", "FIFO admission")
            if ok and 0 <= raw < len(self._queue):
                idx = raw
        if idx == 0:
            return self._queue.popleft()
        self._queue.rotate(-idx)
        req = self._queue.popleft()
        self._queue.rotate(idx)
        return req

    def _plan_admissions_locked(self, failures):
        """Admission into free slots (FIFO, or admit_select's order),
        lowest slot first, at most the largest admission bucket a cycle.
        Called under _cv; `failures` collects (req, exc) pairs to fail
        outside the lock."""
        admits = []
        t_admit = time.monotonic()
        for slot in range(self.n_slots):
            if not self._queue or len(admits) >= self._admit_buckets[-1]:
                break
            if self._lanes[slot] is None:
                req = self._pop_next()
                self._lanes[slot] = req
                req.t_admit = t_admit
                if req.trace is not None:
                    req.trace.add_span("slotpool.queue", req.t_arrival,
                                       t_admit, slot=slot)
                admits.append((slot, req))
        return admits

    def _plan_burst_locked(self, admits, drain, failures):
        """(n_steps, min_active, run) for the coming cycle."""
        occupied = sum(l is not None for l in self._lanes)
        if not occupied:
            return 0, 0, False
        n = self.drain_steps if drain else self.steps_per_tick
        m = occupied - 1 if (self.exit_on_retire and not drain) else 0
        return n, max(0, m), True

    def _admission_feed(self, admits):
        """(serve key, feeds) of this cycle's admissions; padded rows
        repeat the last prompt and land on the dustbin lane."""
        A = _bucket_for(len(admits), self._admit_buckets,
                        "admission batch")
        feed = {
            "src_ids": np.concatenate(
                [req.src for _, req in admits]
                + [admits[-1][1].src] * (A - len(admits)), axis=0),
            "slots": np.array(
                [slot for slot, _ in admits]
                + [self.bundle.dustbin] * (A - len(admits)), np.int64)}
        if self._needs_seeds:
            # padded rows' seeds land on the dustbin lane, which never
            # activates
            feed["seeds"] = self._seeds_feed(admits, A)
        return A, feed

    @staticmethod
    def _seeds_feed(admits, A):
        return np.array([req.seed for _, req in admits]
                        + [0] * (A - len(admits)), np.int64)

    def _pre_dispatch(self):
        """Hook: publish host-owned state just before the dispatch."""

    def _post_dispatch(self, outs):
        """Hook: absorb fetched state right after a dispatch."""

    # --- background work (chunked prefill) ----------------------------
    # A cycle that admits nothing may still carry device work fused with
    # the decode burst (the paged server's chunked prefill: one phase
    # program a dispatch). The hooks keep the loop generic: the wait
    # stays awake while a job is in flight, the cycle swaps the serve
    # key, and a failed dispatch aborts the job with the lanes.
    def _has_background_work_locked(self) -> bool:
        """Hook: True while a background job needs dispatches even with
        an empty queue and no live lane. Called under _cv."""
        return False

    def _has_pending_external_locked(self) -> bool:
        """Hook: True while requests are in flight outside this
        scheduler (a disaggregated prefill worker): drain() waits on
        them, the cycle loop does not wake for them (their completion
        callback notifies _cv). Called under _cv."""
        return False

    def _skip_serve_key(self, key) -> bool:
        """Hook: True to leave a serve program unprepared (the paged
        server's chunked phases when a prefill worker runs them)."""
        return False

    def _background_feed(self):
        """Hook: (serve key, extra feeds) of this cycle's background
        work, or None. Consulted only when the cycle admits nothing."""
        return None

    def _background_abort_locked(self):
        """Hook: a dispatch raised, or the server is closing: drop the
        in-flight background job and return its request (failed by the
        caller), or None. Called under _cv."""
        return None

    def _flush_requests_locked(self, pending):
        """Hook: the listed requests are being failed wholesale
        (close()); drop their per-request holds. Called under _cv."""

    def _release_lane(self, slot, req):
        """Hook: a lane stopped serving `req` (retired, cancelled or
        failed)."""

    def _fail_requests(self, failures):
        for req, exc in failures:
            self._finish_stream(req, "error", exc)
            try:
                req.reply.set_exception(exc)
            except futures.InvalidStateError:
                pass
            if req.trace is not None and req.trace.owner == "server":
                req.trace.finish(status="error", error=repr(exc))

    def _loop(self):
        while True:
            failures = []
            with self._cv:
                while self._running and not self._queue \
                        and all(l is None for l in self._lanes) \
                        and not self._has_background_work_locked():
                    self._cv.wait()
                if not self._running:
                    return
                cancels = self._shed_cancelled_locked(time.monotonic())
                admits = self._plan_admissions_locked(failures)
                drain = not self._queue
                n_steps, min_active, run = self._plan_burst_locked(
                    admits, drain, failures)
                if run:
                    self._busy = True
                elif not (cancels or failures):
                    # nothing to dispatch: the queued requests wait on
                    # work outside this scheduler (a prefill worker's
                    # jobs), whose handoff notifies. Sleep instead of
                    # spinning on the lock, which starves the worker's
                    # thread of the interpreter; wake now and then for
                    # the queue's deadlines
                    self._cv.wait(self._IDLE_WAIT_S)
            # futures' done-callbacks run synchronously: never under
            # the scheduler lock
            self._finalize_cancelled(cancels)
            self._fail_requests(failures)
            if run:
                try:
                    self._cycle(admits, n_steps, min_active)
                finally:
                    with self._cv:
                        self._busy = False
                        self._cv.notify_all()

    def _cycle(self, admits, n_steps, min_active):
        """One fused dispatch: admit the planned prompts, then decode
        ticks over every live lane until n_steps ran or the live-lane
        count drops to min_active; then retire."""
        feed = {"n_steps": np.array([n_steps], np.int64),
                "min_active": np.array([max(0, min_active)], np.int64)}
        key = 0
        background = False
        if admits:
            key, extra = self._admission_feed(admits)
            feed.update(extra)
        else:
            bg = self._background_feed()
            if bg is not None:
                key, extra = bg
                feed.update(extra)
                background = True
        k_used = self._spec_k
        if self._spec_ctl is not None and not background:
            # the controller picks the rung the whole pool runs; another
            # rung than the default routes through its ("k", kv, key)
            # serve. A chunk dispatch keeps the default body
            for slot, _req in admits:
                self._spec_ctl.reset_lane(slot)
            kv = int(self._spec_ctl.choose())
            if kv != self._spec_k and ("k", kv, key) in self._serves:
                key = ("k", kv, key)
                k_used = kv
        self._pre_dispatch()
        try:
            c0 = self.executor.prepare_count
            d0 = self.executor.disk_load_count
            with obs_tracing.ambient(
                    [r.trace for r in self._lanes
                     if r is not None and r.trace is not None]):
                with obs_tracing.span("slotpool.dispatch",
                                      admits=len(admits),
                                      n_steps=n_steps) as sp:
                    t_run0 = time.monotonic()
                    outs = self._serves[key].run(feed, return_numpy=True)
                    wall_s = time.monotonic() - t_run0
                    sp.attrs["cache"] = _cache_tier(self.executor, c0, d0)
                    if self._devtel.active:
                        # the burst's interior: ticks, exit reason,
                        # occupancy, expected against actual tick time
                        self._absorb_devtel(key, outs, wall_s, sp)
                    if self._spec_names:
                        d = self._absorb_spec_counters(outs)
                        self._absorb_lane_counters(outs, d, k_used)
                        if d["proposed"] > 0:
                            self._acc_hist.observe(
                                d["accepted"] / d["proposed"])
                            # tokens a lane advanced a verify: a low value
                            # explains a slow burst
                            sp.attrs["mean_accepted_len"] = round(
                                d["emitted"] * k_used / d["proposed"], 3)
                        if self._spec_ctl is not None:
                            sp.attrs["spec_k"] = k_used
        except BaseException as e:
            with self._cv:
                lanes = [(slot, r) for slot, r in enumerate(self._lanes)
                         if r is not None]
                for slot, r in lanes:
                    r.finalized = True
                    self._release_lane(slot, r)
                self._lanes = [None] * self.n_slots
                bg_req = self._background_abort_locked()
                if bg_req is not None:
                    bg_req.finalized = True
                    lanes.append((None, bg_req))
            self._fail_requests([(r, e) for _, r in lanes])
            return
        self._post_dispatch(outs)
        tok_buf, step, active = outs[:3]
        done_t = time.monotonic()
        retired, cancels, stream_out = [], [], []
        with self._cv:
            occupied = 0
            for slot in range(self.n_slots):
                req = self._lanes[slot]
                if req is None:
                    continue
                occupied += 1
                if req.t_first is None:
                    req.t_first = done_t  # its first token just landed
                retiring = active[slot] == 0 and slot not in self._paused
                reason = self._expired_locked(req, done_t)
                if reason is not None and not retiring:
                    # a finished result wins over a same-burst cancel
                    self._cancel_lane_locked(slot, req, reason)
                    cancels.append((req, reason))
                    continue
                if retiring:
                    toks = apply_eos_sentinel(tok_buf[slot:slot + 1],
                                              self._end_id)[0]
                    ntok = int(count_generated_tokens(toks[None],
                                                      self._end_id)[0])
                    lat = (done_t - req.t_arrival) * 1e3
                    self._latencies.observe(lat)
                    self._ttft.observe((req.t_first - req.t_arrival) * 1e3)
                    if ntok:
                        self._per_token.observe(lat / ntok)
                        self._n_tokens += ntok
                    self._n_done += 1
                    self._t_last_done = done_t
                    req.finalized = True
                    self._release_lane(slot, req)
                    self._lanes[slot] = None
                    if req.trace is not None:
                        req.trace.add_span(
                            "slotpool.decode",
                            req.t_admit if req.t_admit is not None
                            else req.t_arrival, done_t, slot=slot,
                            tokens=ntok)
                    fin = "eos" if (ntok < toks.shape[0]
                                    and toks[ntok] == self._end_id) \
                        else "length"
                    retired.append((req, toks, fin))
                    # stream through the terminator: the row is
                    # sentinel-normalized, nothing past ntok is real
                    hi, row = ntok, toks
                else:
                    # a live lane: step[slot] is the next write position,
                    # so step - 1 is the newest token. A preempted lane's
                    # re-decode repeats its prefix byte for byte, and the
                    # monotone `emitted` mark skips what was delivered
                    hi, row = int(step[slot]) - 1, tok_buf[slot]
                if (req.stream is not None or req.stream_cb is not None) \
                        and hi > req.emitted:
                    chunk = np.asarray(
                        row[req.emitted + 1:hi + 1]).astype(np.int64)
                    stream_out.append((req, req.n_streamed, chunk))
                    req.n_streamed += len(chunk)
                    req.emitted = hi
            self._n_ticks += 1
            self._occ_sum += occupied / self.n_slots
        # in order, outside the lock: a burst's tokens land before its
        # finish marker, which lands before the whole-response future
        for req, first_seq, chunk in stream_out:
            self._deliver_stream(req, first_seq, chunk)
        for req, toks, fin in retired:
            self._finish_stream(req, fin)
            try:
                req.reply.set_result(toks)
            except futures.InvalidStateError:
                pass
            if req.trace is not None and req.trace.owner == "server":
                req.trace.finish()
        self._finalize_cancelled(cancels)

    # --- speculation --------------------------------------------------
    def _absorb_spec_counters(self, outs) -> dict:
        """This dispatch's deltas of the device's speculative counters
        (cumulative since init_slot_state)."""
        vals = {key: int(np.asarray(outs[4 + i]).reshape(-1)[0])
                for i, key in enumerate(_SPEC_COUNTERS)}
        with self._cv:
            deltas = {k: vals[k] - self._spec_tot[k] for k in vals}
            self._spec_tot = vals
        return deltas

    def _absorb_lane_counters(self, outs, spec_deltas, k_used):
        """Delta the per-lane acceptance counters, feed the controller,
        and book this dispatch's deltas to the rung it ran."""
        off = 4 + len(self._spec_names)
        lane_deltas = []
        with self._cv:
            for i in range(len(self._lane_names)):
                cur = np.asarray(outs[off + i]).reshape(-1).astype(
                    np.int64)
                prev = self._lane_tot[i]
                lane_deltas.append(cur if prev is None else cur - prev)
                self._lane_tot[i] = cur
            per_k = self._per_k_tot.get(int(k_used))
            if per_k is not None:
                per_k["dispatches"] += 1
                for c in ("proposed", "accepted", "emitted"):
                    per_k[c] += spec_deltas[c]
            hist = self._acc_hist_k.get(int(k_used))
            if hist is not None and spec_deltas["proposed"] > 0:
                hist.observe(spec_deltas["accepted"]
                             / spec_deltas["proposed"])
        if self._spec_ctl is not None:
            self._spec_ctl.observe(lane_deltas[0], lane_deltas[1],
                                   k=int(k_used))

    def _cost_snapshot(self, key) -> Optional[dict]:
        """The cost model's snapshot of serves[key], counted at the key's
        first dispatch at FLAGS_observability >= metrics and kept on the
        server after."""
        snap = self._cost_snaps.get(key)
        if snap is None and obs_metrics.metrics_on():
            snap = obs_costmodel.lookup(self.bundle.serves[key])
            if snap is not None:
                self._cost_snaps[key] = snap
        return snap

    def _absorb_devtel(self, key, outs, wall_s, sp):
        """Delta the device counters of this dispatch and annotate the
        burst span: the ticks run, the exit reason, the occupancy
        integral and, once the cost model is calibrated, the expected
        against the actual tick time; feed the calibration."""
        with self._cv:
            deltas = self._devtel.absorb(outs[self._tel_off:])
        ticks = deltas.get("tel_ticks", 0)
        if not ticks:
            return
        sp.attrs["ticks"] = ticks
        sp.attrs["occupancy_integral"] = deltas.get("tel_occupancy", 0)
        reason = obs_devtel.DeviceTelemetry.exit_reason(deltas)
        if reason is not None:
            sp.attrs["exit_reason"] = reason
        if not obs_metrics.metrics_on():
            return
        # a tick's cost is the key-0 serve's (no admission body: its
        # While body counted once is one tick); a per-key snapshot would
        # fold the admission prologue into every tick
        flops = (self._cost_snapshot(0) or {}).get("flops")
        actual_tick_ms = wall_s * 1e3 / ticks
        # the rate calibrated before this dispatch: a burst does not
        # vouch for itself
        expected = obs_costmodel.expected_ms(flops)
        sp.attrs["actual_tick_ms"] = round(actual_tick_ms, 3)
        if expected is not None:
            sp.attrs["expected_tick_ms"] = round(expected, 3)
            if expected > 0:
                sp.attrs["tick_time_ratio"] = round(
                    actual_tick_ms / expected, 3)
        if flops:
            # the burst's work: tick-flops x ticks, plus an admission
            # dispatch's prologue (its key's flops less one tick); a
            # prologue of unknown cost skips the sample rather than
            # depress the median
            work = flops * ticks
            if sp.attrs.get("admits", 0) and key != 0:
                kflops = (self._cost_snapshot(key) or {}).get("flops")
                work = None if kflops is None \
                    else work + max(0.0, kflops - flops)
            if work:
                obs_costmodel.observe(work, wall_s)

    def _speculative_stats_locked(self) -> Optional[dict]:
        """``stats()["speculative"]`` over the window (reset=True
        re-bases the counters and clears the histograms together)."""
        if self._spec_k <= 0:
            return None
        t = {key: self._spec_tot[key] - self._spec_base[key]
             for key in self._spec_tot}
        out = {
            "k": self._spec_k,
            "proposed": t["proposed"],
            "accepted": t["accepted"],
            "emitted": t["emitted"],
            "draft_steps": t["draft_steps"],
            "target_steps": t["target_steps"],
            "acceptance_rate": (round(t["accepted"] / t["proposed"], 4)
                                if t["proposed"] else None),
            # tokens a lane advances a verify, in [1, k+1] (proposed / k
            # is the live lane-ticks)
            "mean_accepted_len": (
                round(t["emitted"] * self._spec_k / t["proposed"], 3)
                if t["proposed"] else None),
            "acceptance_rate_hist": self._acc_hist.percentile_dict(),
        }
        if self._spec_k_options:
            per_k = {}
            for kv in self._spec_k_options:
                w = {c: self._per_k_tot[kv][c] - self._per_k_base[kv][c]
                     for c in self._per_k_tot[kv]}
                w["acceptance_rate"] = (
                    round(w["accepted"] / w["proposed"], 4)
                    if w["proposed"] else None)
                hist = self._acc_hist_k.get(kv)
                if hist is not None:
                    w["acceptance_rate_hist"] = hist.percentile_dict()
                per_k[kv] = w
            out["per_k"] = per_k
            out["k_options"] = list(self._spec_k_options)
            if self._spec_ctl is not None:
                out["controller"] = self._spec_ctl.stats()
        return out

    # --- observability ------------------------------------------------
    def _host_tel_locked(self, reset: bool) -> dict:
        """Host-side supplement to stats()['device_telemetry'] (the
        paged server's allocation counters). Called under _cv."""
        return {}

    def stats(self, reset: bool = False) -> dict:
        """Atomic snapshot; reset=True zeroes the window counters under
        the scheduler lock (uptime_s keeps counting). ``compile_count``
        is the executor's CUDA-graph captures (serving captures none),
        ``prepare_count`` its PreparedProgram builds."""
        exe = self.executor
        with self._cv:
            now = time.monotonic()
            done_span = (
                self._t_last_done - self._t_first_arrival
                if self._t_last_done is not None
                and self._t_first_arrival is not None else None)
            occ = (self._occ_sum / self._n_ticks
                   if self._n_ticks else None)
            snap = {
                "requests": self._n_requests,
                "completed": self._n_done,
                "queue_depth": len(self._queue),
                "slots": self.n_slots,
                "slot_occupancy": round(occ, 4) if occ else None,
                "ticks": self._n_ticks,
                "steps_per_tick": self.steps_per_tick,
                "uptime_s": round(now - self._t_start, 3),
                "window_s": round(now - self._t_window, 3),
                "compile_count": exe.compile_count,
                "prepare_count": exe.prepare_count,
                "cache_hit_count": exe.cache_hit_count,
                "disk_load_count": exe.disk_load_count,
                "cache_evict_count": exe.cache_evict_count,
                "warmed_compiles": self._warmed_compiles,
                "latency_ms": self._latencies.percentile_dict(),
                "ttft_ms": self._ttft.percentile_dict(),
                "per_token_ms": self._per_token.percentile_dict(),
                "tokens": self._n_tokens,
                "retired_per_s": (round(self._n_done / done_span, 1)
                                  if done_span else None),
                "cancelled": self._n_cancelled,
                "deadline_expired": self._n_deadline,
            }
            spec = self._speculative_stats_locked()
            if spec is not None:
                snap["speculative"] = spec
            if self._devtel.active:
                dt = self._devtel.stats_dict(self._devtel.window())
                dt.update(self._host_tel_locked(reset))
                snap["device_telemetry"] = dt
            if reset:
                self._n_requests = self._n_done = 0
                self._n_tokens = self._n_ticks = 0
                self._occ_sum = 0.0
                self._latencies.clear()
                self._ttft.clear()
                self._per_token.clear()
                self._acc_hist.clear()
                self._spec_base = dict(self._spec_tot)
                self._per_k_base = {k: dict(v) for k, v in
                                    self._per_k_tot.items()}
                for hist in self._acc_hist_k.values():
                    hist.clear()
                self._devtel.rebase()
                self._t_first_arrival = None
                self._t_last_done = None
                self._t_window = now
            return snap

    def _metrics_samples(self):
        """Pull-provider for observability.metrics.expose()."""
        lab = {"server": self._obs_id}
        with self._cv:
            occ = (self._occ_sum / self._n_ticks
                   if self._n_ticks else 0.0)
            samples = [
                ("paddle_tpu_server_requests_total", lab,
                 self._n_requests),
                ("paddle_tpu_server_completed_total", lab, self._n_done),
                ("paddle_tpu_server_queue_depth", lab, len(self._queue)),
                ("paddle_tpu_server_slot_occupancy", lab, occ),
                ("paddle_tpu_server_ticks_total", lab, self._n_ticks),
                ("paddle_tpu_server_tokens_total", lab, self._n_tokens),
                ("paddle_tpu_server_cancelled_total", lab,
                 self._n_cancelled),
                ("paddle_tpu_server_deadline_expired_total", lab,
                 self._n_deadline),
                ("paddle_tpu_request_latency_ms", lab, self._latencies),
                ("paddle_tpu_request_ttft_ms", lab, self._ttft),
                ("paddle_tpu_per_token_ms", lab, self._per_token),
            ]
            if self._spec_k > 0:
                t = self._spec_tot
                samples += [
                    (f"paddle_tpu_spec_{c}_total", lab, t[c])
                    for c in _SPEC_COUNTERS]
                samples.append(("paddle_tpu_spec_acceptance_rate", lab,
                                self._acc_hist))
                for kv in self._spec_k_options:
                    klab = dict(lab, k=str(kv))
                    samples.append(
                        ("paddle_tpu_spec_k_dispatches_total", klab,
                         self._per_k_tot[kv]["dispatches"]))
                    hist = self._acc_hist_k.get(kv)
                    if hist is not None:
                        samples.append(
                            ("paddle_tpu_spec_acceptance_rate_k", klab,
                             hist))
            samples += self._devtel.metric_samples(lab)
            return samples


class PagedContinuousGenerationServer(ContinuousGenerationServer):
    """Continuous batching over the paged KV layout
    (``serving.py:2458`` in the JAX package; vLLM-style block tables
    and prefix reuse, SGLang-style radix reuse). The base scheduler's
    fused admit-and-burst cycles and immediate retirement carry over;
    this subclass adds the host side of paging:

    * block allocation: a lane starts with one block from the
      ``HostBlockPool`` and grows lazily as it crosses block boundaries
      (``_plan_burst_locked`` caps each burst at the coverage it could
      allocate), so a short request holds one block, not maxT positions;
    * prefix-cache admission: prompts are classified hit / partial /
      miss against the ``PromptPrefixCache``; hits admit through the
      encoder-free ``("hit", A)`` serves, misses and partials encode
      once into an entry later hits reuse. One admission flavor a
      cycle; a duplicate cold prompt in one batch waits a cycle and
      comes back a hit;
    * the radix tier: a lane's table is a read-only shared prefix of
      radix-tree blocks followed by its exclusive writable tail. A
      retiring session turn, or (with ``radix_reuse``) a retiring plain
      request, gives its full blocks to the ``RadixBlockTree``; the
      next turn of the session, an n-best branch or the same plain
      prompt sent again admits through the ``("radix", A)`` serves over
      the longest shared chain and replays the rest of its history
      teacher-forced. Tree-only blocks are reclaimable: an allocation
      that finds the free list empty evicts the deepest one.
      ``radix_reuse=False`` keeps the session API but replays every
      turn's whole history into fresh blocks and harvests no plain
      request (the re-prefill baseline);
    * chunked prefill (a bundle built with ``CacheConfig(chunk_tokens=C)``,
      on unless ``chunked_prefill=False``): a cold plain prompt becomes
      the server's one chunk job, which takes a fresh entry and fills it
      one ``("chunked", p)`` phase program a dispatch, phase-major, each
      dispatch also running the live lanes' decode burst; admissions and
      the job take cycles in turn, so prompts whose entries are cached
      keep admitting while a long one prefills. The finished request
      comes back to the queue's front and admits as a prefix hit. A
      ``prefill_worker`` (``DisaggregatedPrefillWorker``) runs the jobs
      on its own scope and thread instead, and its finished cross-KV
      rows are copied into this server's pools. A cancelled or failed
      job releases and invalidates its part-written entry;
    * pressure: admission waits; a lane that cannot get its next block
      is paused for the cycle (its active flag host-masked, so it
      writes nothing); when every live lane is blocked the tree's
      tree-only leaves go first, then the lane that loses the least work
      (deepest shared prefix, then youngest) is recompute-preempted
      (blocks freed, request re-queued at the front; greedy decode
      re-decodes it byte-identically). Only a lone request that outgrows
      the whole pool fails, with the named retryable
      ``BlockPoolExhausted``: never a hang.

    FIFO admission: ``admit_select`` is refused (the prefix tiers own the
    admission order). A bundle that declares its session workload
    (``bundle.workload = {"distinct_session_prompts": K, ...}``) is
    checked at construction by ``analysis.liveness.session_feasibility``
    and refused with the named ``AdmissionInfeasible``; an open session
    that would pin more distinct prompts than the entry pool holds is
    refused at its submit. Sampled bundles take no plain-prompt radix
    reuse: a resubmitted prompt draws anew from its own seed.
    """

    # how deep past the queue head the tier-grouped admission scan
    # looks for batch-compatible requests
    _ADMIT_SCAN_DEPTH = 64

    def __init__(self, bundle, radix_reuse=True, chunked_prefill=None,
                 prefill_worker=None, **kwargs):
        cache = getattr(bundle, "cache", None)
        if cache is None or cache.layout != "paged":
            raise ValueError(
                "PagedContinuousGenerationServer needs a bundle built "
                "with CacheConfig(layout='paged') -- for dense bundles "
                "use ContinuousGenerationServer")
        chunk_keys = bundle.chunk_phase_keys
        if prefill_worker is not None:
            if chunked_prefill is False:
                raise ValueError(
                    "prefill_worker implies chunked scheduling; "
                    "chunked_prefill=False contradicts it")
            if prefill_worker.bundle is not bundle:
                raise ValueError(
                    "prefill_worker must serve the SAME bundle (the "
                    "handoff copies cross-KV rows between scopes by the "
                    "bundle's state names)")
            chunked_prefill = True
        spec_k = int(getattr(bundle, "spec_k", 0))
        if chunked_prefill is None:
            chunked_prefill = bool(chunk_keys) and spec_k == 0
        if chunked_prefill and not chunk_keys:
            raise ValueError(
                "chunked_prefill=True needs a bundle built with "
                "CacheConfig(chunk_tokens=C): this bundle carries no "
                "('chunked', phase) serve programs")
        if chunked_prefill and spec_k > 0:
            raise ValueError(
                "chunked prefill does not compose with speculative "
                "bundles (the draft's encoder runs over the whole prompt "
                "at admission); pass chunked_prefill=False")
        if kwargs.get("admit_select") is not None:
            raise ValueError(
                "paged serving owns the admission order (prefix-tier "
                "grouping); admit_select hooks are not supported")
        self._chunked = bool(chunked_prefill)
        self._radix_reuse = bool(radix_reuse)
        self.cache = cache
        workload = getattr(bundle, "workload", None)
        if isinstance(workload, dict) \
                and "distinct_session_prompts" in workload:
            # a provably infeasible session workload is refused here,
            # not left to wedge admissions at run time
            chk = session_feasibility(
                cache.n_prompt_entries,
                int(workload["distinct_session_prompts"]),
                sessions_close=bool(workload.get("sessions_close", False)),
                cold_traffic=bool(workload.get("cold_traffic", False)))
            if not chk.feasible:
                raise AdmissionInfeasible(chk.witness)
        self._bs = cache.block_size
        self._blocks = HostBlockPool(cache.n_blocks)
        self._prefix = PromptPrefixCache(cache.n_prompt_entries,
                                         cache.block_size)
        rows = bundle.n_slots + 1
        self._tab = np.zeros((rows, cache.pages(bundle.max_out_len)),
                             np.int32)
        self._pref = np.full((rows,), cache.n_prompt_entries, np.int32)
        # a lane's chain: the read-only shared radix prefix (one pool ref
        # a block) and the exclusive writable tail
        self._lane_shared = [[] for _ in range(bundle.n_slots)]
        self._lane_blocks = [[] for _ in range(bundle.n_slots)]
        self._lane_entry: List[Optional[int]] = [None] * bundle.n_slots
        self._lane_sess: List[Optional[object]] = [None] * bundle.n_slots
        self._lane_step = np.zeros((rows,), np.int64)
        self._admit_tier = None
        self._radix = RadixBlockTree(self._blocks, self._bs)
        self._sessions: Dict[object, dict] = {}
        # the harvest's source: the last dispatch's token buffer, valid
        # only between a dispatch's _post_dispatch and the next
        # _pre_dispatch (a failed dispatch must not graft a stale row)
        self._last_tok = None
        self._harvest_ok = False
        self._radix_admits = 0
        # retired plain greedy generations, prompt -> history (bounded
        # LRU): an identical sessionless prompt re-admits through the
        # radix tier
        self._plain_hist: "collections.OrderedDict[tuple, list]" = \
            collections.OrderedDict()
        self._plain_hist_cap = 32
        self._plain_radix_admits = 0
        # how deep radix admissions share, in blocks
        self._hit_depth = Histogram(
            "paddle_tpu_blockpool_prefix_hit_depth",
            buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))
        self._pause_events = 0  # lanes parked for >= 1 cycle
        self._preemptions = 0   # recompute-preempted lanes
        self._blocks_hwm = 0
        self._entries_hwm = 0
        self._pause_base = 0
        self._preempt_base = 0
        # chunked prefill: one job at a time, {req, prompt, entry, phase,
        # ci}, one phase program a dispatch
        self._chunk_keys = chunk_keys
        self._prefill_job = None
        self._chunk_turn = False     # the next cycle belongs to the job
        self._bg_ticked = False      # this dispatch carried a chunk
        self._handoff: Dict[int, int] = {}  # id(req) -> the job's entry ref
        self._chunk_jobs = 0
        self._chunk_ticks_host = 0
        self._n_chunks = cache.n_chunks(bundle.seq_len)
        self._prefill_blocked = False
        # disaggregated prefill: cold prompts go to the worker; finished
        # rows come back through the inbox, landed on this scheduler's
        # thread
        self._prefill_worker = prefill_worker
        self._disagg_inbox: "collections.deque" = collections.deque()
        self._disagg_prompts: set = set()
        self._disagg_out = 0
        self._disagg_handoffs = 0
        super().__init__(bundle, **kwargs)

    # --- chat sessions (the radix tier) -------------------------------
    def _session_submit_locked(self, session_id, arr, extend_tokens):
        prompt = tuple(int(x) for x in arr.reshape(-1))
        sess = self._sessions.get(session_id)
        if sess is None:
            if extend_tokens is not None:
                raise ValueError(
                    f"session {session_id!r} has no retired turn to "
                    f"extend; submit its first turn plain")
            # every open session pins one prompt entry per distinct
            # prompt for its lifetime: a session past the entry pool
            # could never be admitted until another closes
            open_prompts = {s["prompt"] for s in self._sessions.values()}
            open_prompts.add(prompt)
            chk = session_feasibility(self.cache.n_prompt_entries,
                                      len(open_prompts))
            if not chk.feasible:
                raise AdmissionInfeasible(
                    f"opening session {session_id!r} would pin "
                    f"{len(open_prompts)} distinct prompts against "
                    f"n_prompt_entries={self.cache.n_prompt_entries}; "
                    f"close a session (close_session) or grow the entry "
                    f"pool. {chk.witness}")
            self._sessions[session_id] = {
                "prompt": prompt, "hist": None, "entry": None,
                "turns": 0}
            return
        if sess["prompt"] != prompt:
            raise ValueError(
                f"session {session_id!r} was opened with a different "
                f"prompt: sessions are keyed by PROMPT content (the "
                f"bidirectional encoder pins every KV chain to the whole "
                f"prompt); open a new session for a new prompt")
        if extend_tokens is not None:
            if sess["hist"] is None:
                raise ValueError(
                    f"session {session_id!r}'s first turn has not retired "
                    f"yet; extend after its reply resolves")
            ext = [int(t) for t in np.asarray(extend_tokens).reshape(-1)]
            maxT = self.bundle.max_out_len
            if len(sess["hist"]) + len(ext) > maxT - 1:
                raise ValueError(
                    f"session {session_id!r} history "
                    f"({len(sess['hist'])} + {len(ext)} tokens) exceeds "
                    f"the decode buffer (max_out_len-1 = {maxT - 1}); "
                    f"close_session and restart")
            sess["hist"] = sess["hist"] + ext

    def close_session(self, session_id):
        """Drop a chat session: releases its prompt-entry pin and forgets
        its history. Its radix nodes stay as shared cache until evicted.
        Idempotent; an in-flight turn finishes (without its harvest)."""
        with self._cv:
            sess = self._sessions.pop(session_id, None)
            if sess is not None and sess["entry"] is not None:
                self._prefix.release(sess["entry"])

    def session_history(self, session_id):
        """The session's decoded-token history (ints, the GO token first,
        the terminator left out), or None before its first turn retired
        and for an unknown session."""
        with self._cv:
            sess = self._sessions.get(session_id)
            if sess is None or sess["hist"] is None:
                return None
            return list(sess["hist"])

    def _alloc_block_locked(self):
        """Pool alloc with the radix tree as reclaimable capacity: a miss
        first evicts the deepest tree-only leaf."""
        b = self._blocks.alloc()
        if b is None and self._radix.evict(1):
            b = self._blocks.alloc()
        return b

    # --- chunked prefill: the job and the disaggregated handoff --------
    def _has_background_work_locked(self):
        return self._prefill_job is not None or bool(self._disagg_inbox)

    def _has_pending_external_locked(self):
        return self._disagg_out > 0

    def _skip_serve_key(self, key):
        return (self._prefill_worker is not None
                and isinstance(key, tuple) and key[0] == "chunked")

    def _prefill_inflight_locked(self, prompt) -> bool:
        """True while `prompt`'s entry is registered but still filling
        (the local job or the worker): lookup says hit, but admitting
        against it would read a part-written entry."""
        if self._prefill_worker is not None:
            return prompt in self._disagg_prompts
        return self._prefill_job is not None \
            and prompt == self._prefill_job["prompt"]

    def _maybe_start_prefill_locked(self, failures):
        """Make the first cold plain prompt in the scan window the chunk
        job: its entry is acquired fresh now and filled a phase program
        a dispatch; the request comes back to the queue as a hit when the
        last phase lands. With a prefill worker, every such prompt goes
        to the worker instead (_route_prefills_locked)."""
        if self._prefill_worker is not None:
            self._route_prefills_locked(failures)
            return
        if self._prefill_job is not None or not self._queue:
            return
        for pos, req in enumerate(self._queue):
            if pos >= self._ADMIT_SCAN_DEPTH:
                return
            if req.session is not None:
                continue  # session turns keep the monolithic path
            prompt = tuple(int(x) for x in req.src.reshape(-1))
            tier, _entry = self._prefix.lookup(prompt)
            if tier == "hit":
                continue
            entry = self._prefix.acquire_fresh(
                prompt, partial=(tier == "partial"))
            if entry is None:
                # every entry pinned: the idle-pool exhaustion check reads
                # this flag (with nothing in flight, waiting would hang)
                self._prefill_blocked = True
                return
            del self._queue[pos]
            self._prefill_job = {"req": req, "prompt": prompt,
                                 "entry": entry, "phase": 0, "ci": 0}
            self._chunk_jobs += 1
            return

    def _route_prefills_locked(self, failures):
        """Send every cold plain prompt in the scan window to the prefill
        worker. This server owns the entry cache: it acquires the entry
        fresh here; the worker fills it on its own scope and hands the
        rows back through the inbox, which lands them in order."""
        pos = scanned = 0
        while pos < len(self._queue) and scanned < self._ADMIT_SCAN_DEPTH:
            req = self._queue[pos]
            scanned += 1
            prompt = tuple(int(x) for x in req.src.reshape(-1))
            tier = self._prefix.lookup(prompt)[0]
            if req.session is not None or prompt in self._disagg_prompts \
                    or tier == "hit":
                pos += 1
                continue
            entry = self._prefix.acquire_fresh(
                prompt, partial=(tier == "partial"))
            if entry is None:
                self._prefill_blocked = True
                return
            try:
                self._prefill_worker.submit_job(
                    req, prompt, entry, self._disagg_done,
                    self._disagg_fail)
            except BaseException as e:
                self._prefix.release(entry)
                self._prefix.invalidate(entry)
                del self._queue[pos]
                failures.append((req, e))
                return
            del self._queue[pos]
            self._disagg_prompts.add(prompt)
            self._disagg_out += 1
            self._chunk_jobs += 1

    def _disagg_done(self, req, prompt, entry, rows):
        """The worker's thread: a job finished. Queue the handoff for the
        scheduler's thread, which owns this scope between dispatches."""
        fail = None
        with self._cv:
            self._disagg_prompts.discard(prompt)
            self._disagg_out -= 1
            if self._closed:
                self._prefix.release(entry)
                fail = ServerClosed(
                    "server closed while its prompt prefilled")
            else:
                self._disagg_inbox.append((req, entry, rows))
            self._cv.notify_all()
        if fail is not None:
            self._fail_requests([(req, fail)])

    def _disagg_fail(self, req, prompt, entry, exc):
        """The worker's thread: a job died with the entry part-written;
        unmap it so the prompt never hits it, and fail the request."""
        with self._cv:
            self._disagg_prompts.discard(prompt)
            self._disagg_out -= 1
            self._prefix.release(entry)
            self._prefix.invalidate(entry)
            self._cv.notify_all()
        self._fail_requests([(req, exc)])

    def _drain_disagg_inbox_locked(self):
        """Land finished prefills: copy each entry's cross-KV rows into
        this scope's pools, then put the requests back at the queue's
        front, each with the job's entry ref held (the handoff) until its
        hit admission takes its own."""
        if not self._disagg_inbox:
            return
        drained = []
        while self._disagg_inbox:
            drained.append(self._disagg_inbox.popleft())
        dev = self.executor.device
        for _req, entry, rows in drained:
            for name, row in rows.items():
                self.scope._get(name)[entry].copy_(row.to(dev))
            self._disagg_handoffs += 1
        for req, entry, _rows in reversed(drained):
            self._handoff[id(req)] = entry
            self._queue.appendleft(req)

    def _background_feed(self):
        job = self._prefill_job
        if job is None:
            return None
        C = self.cache.chunk_tokens
        key = self._chunk_keys[job["phase"]]
        feed = {"chunk_entry": np.array([job["entry"]], np.int64),
                "chunk_pos": np.array([job["ci"] * C], np.int64)}
        if key[1] == 0:
            # only the embed phase reads tokens; the ragged last chunk is
            # zero-padded (its rows past seq_len select nothing)
            toks = np.zeros((1, C), np.int64)
            seg = np.asarray(job["req"].src).reshape(-1)[
                job["ci"] * C: job["ci"] * C + C]
            toks[0, :len(seg)] = seg
            feed["chunk_toks"] = toks
        self._bg_ticked = True
        return key, feed

    def _advance_prefill(self):
        """A chunk dispatch landed: walk the cursor phase-major. After the
        last phase the entry holds the prompt's cross-KV: the request goes
        back to the queue's front and admits as a prefix hit, the job's
        entry ref held until that admission takes its own."""
        with self._cv:
            self._chunk_ticks_host += 1
            job = self._prefill_job
            job["ci"] += 1
            if job["ci"] < self._n_chunks:
                return
            job["ci"] = 0
            job["phase"] += 1
            if job["phase"] < len(self._chunk_keys):
                return
            req = job["req"]
            self._handoff[id(req)] = job["entry"]
            self._prefill_job = None
            self._chunk_turn = False
            self._queue.appendleft(req)
            self._cv.notify_all()

    def _background_abort_locked(self):
        job = self._prefill_job
        if job is None:
            return None
        self._prefill_job = None
        self._chunk_turn = False
        # the entry is part-written: unmap it so the prompt can never be
        # looked up as a hit against it
        self._prefix.release(job["entry"])
        self._prefix.invalidate(job["entry"])
        return job["req"]

    def _flush_requests_locked(self, pending):
        while self._disagg_inbox:
            # finished handoffs never landed: drop the job's ref and fail
            # the request with the rest
            req, entry, _rows = self._disagg_inbox.popleft()
            self._prefix.release(entry)
            pending.append(req)
        for r in pending:
            e = self._handoff.pop(id(r), None)
            if e is not None:
                self._prefix.release(e)

    def _drop_queued_locked(self, req):
        e = self._handoff.pop(id(req), None)
        if e is not None:
            self._prefix.release(e)

    def _shed_cancelled_locked(self, now: float):
        out = super()._shed_cancelled_locked(now)
        job = self._prefill_job
        if job is not None:
            reason = self._expired_locked(job["req"], now)
            if reason is not None:
                req = self._background_abort_locked()
                req.finalized = True
                self._count_cancel_locked(reason)
                out.append((req, reason))
        return out

    # --- admission -----------------------------------------------------
    def _admit_lane_locked(self, slot, req, shared, blk, entry, t_admit):
        h = len(shared)
        self._lane_shared[slot] = shared
        self._lane_blocks[slot] = [blk]
        self._lane_entry[slot] = entry
        self._lane_sess[slot] = req.session
        self._lane_step[slot] = h * self._bs
        self._tab[slot, :] = 0
        self._tab[slot, :h] = shared
        self._tab[slot, h] = blk
        self._pref[slot] = entry
        self._lanes[slot] = req
        req.t_admit = t_admit
        if req.trace is not None:
            # the prefix tier explains a slow (miss: the encoder runs) or
            # fast (hit: a lane reset) admission; blocks_reused is the
            # radix tier's win
            req.trace.add_span(
                "slotpool.queue", req.t_arrival, t_admit, slot=slot,
                prefix=self._admit_tier, blocks_reused=h)

    def _plan_admissions_locked(self, failures):
        admits = []
        self._admit_tier = None
        self._prefill_blocked = False
        if self._prefill_worker is not None:
            self._drain_disagg_inbox_locked()
        if self._chunked:
            self._maybe_start_prefill_locked(failures)
        if self._prefill_job is not None and self._chunk_turn:
            # the job's cycle: admit nothing, so the cycle runs the phase
            # program (the live lanes' burst rides along)
            self._chunk_turn = False
            return admits
        if not self._queue:
            return admits
        t_admit = time.monotonic()
        free_slots = [s for s in range(self.n_slots)
                      if self._lanes[s] is None]
        max_A = self._admit_buckets[-1]
        seen_cold = set()
        blocked_reason = None
        taken = []
        # one admission flavor a cycle, set by the queue head (it always
        # ships first); the batch fills with same-flavor requests from
        # deeper in the queue
        for pos, req in enumerate(self._queue):
            if pos >= self._ADMIT_SCAN_DEPTH or not free_slots \
                    or len(admits) >= max_A:
                break
            prompt = tuple(int(x) for x in req.src.reshape(-1))
            if self._prefill_inflight_locked(prompt):
                # registered by the in-flight prefill, so lookup says hit,
                # but the entry is still filling: wait for the handoff
                continue
            tier, _entry = self._prefix.lookup(prompt)
            sess = self._sessions.get(req.session) \
                if req.session is not None else None
            if sess is not None and sess["hist"] is not None \
                    and sess["entry"] is not None:
                # a session with a retired turn: the radix tier
                flavor = "radix"
            else:
                flavor = "hit" if tier == "hit" else "miss"
                if flavor == "miss" and self._chunked \
                        and req.session is None:
                    # cold plain prompts go through the chunk job; the
                    # requests behind them admit this cycle
                    continue
                if flavor == "hit" and req.session is None \
                        and self._radix_ok and self._radix_reuse \
                        and self._spec_k == 0 and not self._needs_seeds \
                        and prompt in self._plain_hist:
                    # a plain prompt sent again replays its own retired
                    # greedy generation over the chain the tree holds
                    flavor = "radix"
            if self._admit_tier is None:
                self._admit_tier = flavor
            if flavor != self._admit_tier:
                continue  # next cycle's flavor
            if flavor == "miss" and prompt in seen_cold:
                # a duplicate cold prompt would alias the entry write;
                # it comes back a hit next cycle
                continue
            # admission watermark: one spare block must remain per
            # already-live lane, or growth turns into preempt/re-admit
            # thrash; tree-only blocks are reclaimed first
            live_now = self.n_slots - len(free_slots)
            if self._blocks.free_count - 1 < live_now:
                self._radix.evict(live_now + 1 - self._blocks.free_count)
            if self._blocks.free_count - 1 < live_now:
                blocked_reason = ("free KV blocks below the live-lane "
                                  "watermark")
                break
            if flavor == "radix":
                if sess is not None:
                    hist = list(sess["hist"])
                else:
                    hist = list(self._plain_hist[prompt])
                    self._plain_hist.move_to_end(prompt)
                    self._plain_radix_admits += 1
                P = len(hist)
                # at most (P-1)//BS shared blocks: at least one history
                # position is replayed, so the first device write lands
                # in the fresh exclusive block, never a shared one
                shared = self._radix.acquire(
                    prompt, hist, max_blocks=(P - 1) // self._bs) \
                    if self._radix_reuse else []
                blk = self._alloc_block_locked()
                if blk is None:
                    self._radix.release(shared)
                    blocked_reason = "no free KV block"
                    break
                # the session's (or the retired plain prompt's) entry is
                # resident: always a hit
                entry = self._prefix.acquire_hit(prompt)
                slot = free_slots.pop(0)
                taken.append(req)
                self._admit_lane_locked(slot, req, shared, blk, entry,
                                        t_admit)
                req.radix = (hist, len(shared) * self._bs, P)
                self._radix_admits += 1
                self._hit_depth.observe(float(len(shared)))
                admits.append((slot, req))
                continue
            blk = self._alloc_block_locked()
            if blk is None:
                blocked_reason = "no free KV block"
                break
            if flavor == "hit":
                entry = self._prefix.acquire_hit(prompt)
            else:
                entry = self._prefix.acquire_fresh(
                    prompt, partial=(tier == "partial"))
                if entry is None:
                    self._blocks.free([blk])
                    blocked_reason = "every prompt entry is pinned"
                    break
                seen_cold.add(prompt)
            slot = free_slots.pop(0)
            taken.append(req)
            self._admit_lane_locked(slot, req, [], blk, entry, t_admit)
            admits.append((slot, req))
        if taken:
            taken_ids = {id(r) for r in taken}
            self._queue = collections.deque(
                r for r in self._queue if id(r) not in taken_ids)
            for r in taken:
                e = self._handoff.pop(id(r), None)
                if e is not None:
                    # the job held the filled entry until this admission
                    # took its own ref
                    self._prefix.release(e)
        if admits and self._prefill_job is not None:
            self._chunk_turn = True  # the next cycle belongs to the job
        if blocked_reason is None and self._prefill_blocked:
            blocked_reason = "every prompt entry is pinned"
        if blocked_reason and not admits and self._queue \
                and self._prefill_job is None and self._disagg_out == 0 \
                and not self._disagg_inbox \
                and all(l is None for l in self._lanes):
            # nothing in flight can ever free a block or an entry: fail
            # the head with the named retryable error instead of hanging
            req = self._queue.popleft()
            self._drop_queued_locked(req)
            failures.append((req, BlockPoolExhausted(
                f"cannot admit prompt: {blocked_reason} with the pool "
                f"otherwise idle (n_blocks={self._blocks.n_blocks}, "
                f"n_prompt_entries={self._prefix.n_entries}); retryable "
                f"against a larger pool")))
        return admits

    def _admission_feed(self, admits):
        tier = self._admit_tier
        A = _bucket_for(len(admits), self._admit_buckets,
                        "admission batch")
        feed = {"slots": np.array(
            [slot for slot, _ in admits]
            + [self.bundle.dustbin] * (A - len(admits)), np.int64)}
        if tier == "radix":
            # teacher-forced resume: each lane replays its history from
            # resume (the first position past the shared prefix) and
            # decodes from step P-1 on; padded rows feed zero rows
            maxT = self.bundle.max_out_len
            hist = np.zeros((A, maxT), np.int64)
            resume = np.zeros((A,), np.int64)
            until = np.zeros((A,), np.int64)
            for i, (_slot, req) in enumerate(admits):
                htoks, r, n = req.radix
                hist[i, :n] = htoks
                resume[i] = r
                until[i] = n
            feed.update(hist_toks=hist, resume_steps=resume,
                        prefill_until=until)
        elif tier == "miss" or self._spec_k > 0:
            # a speculative hit feeds src_ids too: its program skips only
            # the target's encoder, the draft's runs per lane
            feed["src_ids"] = np.concatenate(
                [req.src for _, req in admits]
                + [admits[-1][1].src] * (A - len(admits)), axis=0)
        if tier == "miss":
            # padded rows write the dustbin entry (index E)
            feed["prompt_slots"] = np.array(
                [self._lane_entry[slot] for slot, _ in admits]
                + [self.cache.n_prompt_entries] * (A - len(admits)),
                np.int64)
        if self._needs_seeds:
            feed["seeds"] = self._seeds_feed(admits, A)
        return (tier, A), feed

    # --- burst planning: coverage, pausing, exhaustion -----------------
    def _grow_blocks_locked(self, slot, upto_pos):
        need = upto_pos // self._bs + 1
        # the shared prefix is never grown or written
        base = len(self._lane_shared[slot])
        blocks = self._lane_blocks[slot]
        while base + len(blocks) < need:
            b = self._alloc_block_locked()
            if b is None:
                return
            self._tab[slot, base + len(blocks)] = b
            blocks.append(b)

    def _free_lane_locked(self, slot):
        # the lane's refs on its shared prefix (the tree keeps its own)
        self._radix.release(self._lane_shared[slot])
        self._lane_shared[slot] = []
        # decref from refcount 1 is the strict free; a block the tree
        # adopted at the harvest (refcount 2) stays tree-owned. Newest
        # block first
        for b in reversed(self._lane_blocks[slot]):
            self._blocks.decref(b)
        self._lane_blocks[slot] = []
        if self._lane_entry[slot] is not None:
            self._prefix.release(self._lane_entry[slot])
            self._lane_entry[slot] = None
        self._lane_sess[slot] = None
        self._paused.discard(slot)

    def _plan_burst_locked(self, admits, drain, failures):
        n_steps, min_active, run = super()._plan_burst_locked(
            admits, drain, failures)
        if not run:
            if self._prefill_job is not None:
                # a chunk-only dispatch: the phase body runs before the
                # decode While, which exits at once (no live lane)
                return 0, 0, True
            return n_steps, min_active, run
        maxT = self.bundle.max_out_len
        tpt = self._toks_per_tick
        while True:
            live = [s for s in range(self.n_slots)
                    if self._lanes[s] is not None]
            if not live:
                self._paused = set()
                break
            k = n_steps
            blocked = []
            for s in live:
                st = int(self._lane_step[s])
                # a K-tick burst writes KV at positions st..st+K*tpt-1: a
                # speculative tick verifies tpt = k+1 positions however
                # few it accepts, so coverage is sized by the worst case,
                # or a rejected run's verify would write through
                # unallocated table rows into another lane's blocks
                self._grow_blocks_locked(s, min(st + n_steps * tpt - 1,
                                                maxT - 1))
                covered = (len(self._lane_shared[s])
                           + len(self._lane_blocks[s])) * self._bs
                # a lane whose blocks cover the whole buffer never writes
                # outside them (the verify gates positions past maxT-1)
                coverable = n_steps if covered >= maxT \
                    else (covered - st) // tpt
                if coverable <= 0:
                    blocked.append(s)
                else:
                    k = min(k, coverable)
            if blocked and len(blocked) == len(live):
                # every live lane sits at a block boundary with an empty
                # free list: drop cached tree-only blocks before work
                if self._radix.evict(len(blocked)):
                    continue
                # then preempt the lane that loses the least work: the
                # deepest shared prefix (its re-admission resumes past
                # it), the youngest on a tie
                victim = max(blocked,
                             key=lambda s: (len(self._lane_shared[s]),
                                            self._lanes[s].t_admit or 0))
                req = self._lanes[victim]
                self._free_lane_locked(victim)
                self._lanes[victim] = None
                if len(live) == 1:
                    # a lone lane owns every block in use and still
                    # cannot advance: re-running it cannot do better
                    failures.append((req, BlockPoolExhausted(
                        f"KV block pool exhausted mid-generation "
                        f"(n_blocks={self._blocks.n_blocks}, the request "
                        f"alone outgrows the pool); request evicted -- "
                        f"retryable against a larger pool")))
                    continue
                self._preemptions += 1
                req.t_admit = None
                req.t_first = None
                self._queue.appendleft(req)
                continue
            self._pause_events += len(set(blocked) - self._paused)
            self._paused = set(blocked)
            n_steps = k
            break
        if self.exit_on_retire and not drain:
            live_unpaused = sum(
                1 for s in range(self.n_slots)
                if self._lanes[s] is not None and s not in self._paused)
            min_active = max(0, live_unpaused - 1)
        self._blocks_hwm = max(self._blocks_hwm, self._blocks.in_use)
        self._entries_hwm = max(self._entries_hwm, self._prefix.in_use)
        return n_steps, min_active, True

    def _pre_dispatch(self):
        """Publish the host-owned block table, prompt refs and the
        pause mask just before the dispatch (a prepared run reads the
        scope at every call, so this is the whole host-to-device
        channel)."""
        names = self.bundle.state
        dev = self.executor.device
        act = np.zeros((self.n_slots + 1,), np.int64)
        for s in range(self.n_slots):
            if self._lanes[s] is not None and s not in self._paused:
                act[s] = 1
        # paused, retired and idle lanes read 0 (a gated pool write is
        # the exclusivity contract); admitted lanes are raised by the
        # admission body inside the same dispatch
        for name, val in ((names["block_tab"], self._tab),
                          (names["prompt_ref"], self._pref),
                          (names["active"], act)):
            self.scope._set(name, torch.from_numpy(val.copy()).to(dev))
        self._harvest_ok = False  # until this dispatch's outs land

    def _post_dispatch(self, outs):
        self._lane_step = np.asarray(outs[1]).astype(np.int64).copy()
        self._last_tok = np.asarray(outs[0])
        self._harvest_ok = True
        if self._bg_ticked:
            self._bg_ticked = False
            self._advance_prefill()

    def _release_lane(self, slot, req):
        sid = self._lane_sess[slot]
        if req.harvest and self._harvest_ok:
            if sid is not None:
                self._harvest_session_locked(slot, sid)
            elif self._radix_ok and self._radix_reuse \
                    and self._spec_k == 0 and not self._needs_seeds:
                self._harvest_plain_locked(slot, req)
        self._free_lane_locked(slot)

    def _retired_history(self, slot):
        """The lane's row up to its terminator: (history, full blocks)."""
        row = np.asarray(self._last_tok[slot]).reshape(-1)
        hit = row[1:] == self._end_id
        e = int(hit.argmax()) + 1 if hit.any() else row.shape[0] - 1
        return [int(t) for t in row[:e]], e // self._bs

    def _harvest_session_locked(self, slot, sid):
        """Adopt a retiring session turn: the full blocks behind its
        tokens become tree nodes (existing nodes win, so replayed chunks
        are idempotent), and its history, the terminator left out so the
        next turn can extend past it, is kept for the next turn."""
        sess = self._sessions.get(sid)
        if sess is None:
            return  # closed mid-flight: nothing to extend
        hist, f = self._retired_history(slot)
        if f and self._radix_reuse:
            chain = self._lane_shared[slot] + self._lane_blocks[slot]
            self._radix.insert(sess["prompt"], hist, chain[:f])
        sess["hist"] = hist
        sess["turns"] += 1
        if sess["entry"] is None:
            # the session keeps the lane's entry ref for its lifetime,
            # so later turns admit as hits (the lane free below must not
            # release it)
            sess["entry"] = self._lane_entry[slot]
            self._lane_entry[slot] = None

    def _harvest_plain_locked(self, slot, req):
        """The sessionless harvest: a retired greedy generation's full
        blocks join the tree under its prompt and its history is
        memoized (bounded LRU), so the same prompt sent again admits
        through the radix tier, replaying its own deterministic output.
        The entry ref is not kept: the entry stays cached like any
        retired one."""
        hist, f = self._retired_history(slot)
        prompt = tuple(int(x) for x in req.src.reshape(-1))
        if f:
            chain = self._lane_shared[slot] + self._lane_blocks[slot]
            self._radix.insert(prompt, hist, chain[:f])
        self._plain_hist.pop(prompt, None)
        self._plain_hist[prompt] = hist
        while len(self._plain_hist) > self._plain_hist_cap:
            self._plain_hist.popitem(last=False)

    # --- observability ------------------------------------------------
    def pool_stats(self) -> dict:
        """Block-pool, prefix-cache and radix counters."""
        with self._cv:
            return {
                "layout": "paged",
                "block_size": self._bs,
                "n_blocks": self._blocks.n_blocks,
                "blocks_in_use": self._blocks.in_use,
                "blocks_free": self._blocks.free_count,
                "prompt_entries": self._prefix.n_entries,
                "prompt_entries_in_use": self._prefix.in_use,
                "prefix_hits": self._prefix.hits,
                "prefix_misses": self._prefix.misses,
                # partial-tier admissions encode anew: each is a copy
                "cow_copies": self._prefix.partials,
                "evictions": self._prefix.evictions,
                "paused_lanes": len(self._paused),
                "pause_events": self._pause_events,
                "preemptions": self._preemptions,
                # the radix tier: shared (refcount > 1) residency, the
                # tree, and its admissions
                "shared_blocks": len(self._blocks.shared_blocks()),
                "radix_nodes": self._radix.n_nodes,
                "radix_hit_blocks": self._radix.hit_blocks,
                "radix_inserts": self._radix.inserts,
                "radix_adoptions": self._radix.adoptions,
                "radix_evicted_blocks": self._radix.evicted_blocks,
                "radix_admissions": self._radix_admits,
                "plain_radix_admissions": self._plain_radix_admits,
                "sessions_open": len(self._sessions),
                # radix admissions by shared depth in blocks,
                # cumulative at each bucket's upper edge
                "prefix_hit_depth": {
                    ("+Inf" if math.isinf(e) else f"{e:g}"): n
                    for e, n in self._hit_depth.cumulative_counts()},
                # chunked prefill (the host's count; the device counter
                # tel_chunks agrees)
                "chunked_prefill": self._chunked,
                "chunk_jobs": self._chunk_jobs,
                "chunk_ticks": self._chunk_ticks_host,
                # disaggregated prefill
                "disaggregated": self._prefill_worker is not None,
                "disagg_outstanding": self._disagg_out,
                "disagg_handoffs": self._disagg_handoffs,
            }

    def _host_tel_locked(self, reset: bool) -> dict:
        out = {
            "blocks_hwm": self._blocks_hwm,
            "prompt_entries_hwm": self._entries_hwm,
            "pause_events": self._pause_events - self._pause_base,
            "preemptions": self._preemptions - self._preempt_base,
        }
        if reset:
            # the next window's mark starts at the current residency
            self._blocks_hwm = self._blocks.in_use
            self._entries_hwm = self._prefix.in_use
            self._pause_base = self._pause_events
            self._preempt_base = self._preemptions
        return out

    def stats(self, reset: bool = False) -> dict:
        st = super().stats(reset=reset)
        st["block_pool"] = self.pool_stats()
        return st

    def _metrics_samples(self):
        samples = super()._metrics_samples()
        lab = {"server": self._obs_id}
        host_tel = {
            "blocks_hwm": self._blocks_hwm,
            "prompt_entries_hwm": self._entries_hwm,
            "pause_events": self._pause_events,
            "preemptions": self._preemptions,
        }
        samples += [(c.metric, lab, host_tel[c.stat])
                    for c in obs_devtel.HOST_COUNTERS]
        b, p = self._blocks, self._prefix
        samples += [
            ("paddle_tpu_blockpool_blocks_in_use", lab, b.in_use),
            ("paddle_tpu_blockpool_blocks_free", lab, b.free_count),
            ("paddle_tpu_blockpool_prompt_entries_in_use", lab, p.in_use),
            ("paddle_tpu_blockpool_prefix_hits_total", lab, p.hits),
            ("paddle_tpu_blockpool_prefix_misses_total", lab, p.misses),
            ("paddle_tpu_blockpool_cow_copies_total", lab, p.partials),
            ("paddle_tpu_blockpool_evictions_total", lab, p.evictions),
            # how much KV the pool holds once for many readers
            ("paddle_tpu_blockpool_shared_blocks", lab,
             len(b.shared_blocks())),
            ("paddle_tpu_blockpool_radix_nodes", lab, self._radix.n_nodes),
            ("paddle_tpu_blockpool_radix_hit_blocks_total", lab,
             self._radix.hit_blocks),
            ("paddle_tpu_blockpool_radix_evicted_blocks_total", lab,
             self._radix.evicted_blocks),
            ("paddle_tpu_blockpool_radix_admissions_total", lab,
             self._radix_admits),
            ("paddle_tpu_blockpool_sessions_open", lab,
             len(self._sessions)),
            ("paddle_tpu_blockpool_prefix_hit_depth", lab,
             self._hit_depth),
        ]
        return samples


class DisaggregatedPrefillWorker:
    """The prefill half of disaggregated serving
    (``serving.py:3634`` in the JAX package; DistServe's phase split):
    a dispatcher of the bundle's ``("chunked", p)`` phase programs on a
    scope and a thread of its own.

    The decode server owns the host allocators: it acquires a cold
    prompt's cross-KV entry and sends the prompt here
    (``PagedContinuousGenerationServer(prefill_worker=...)``). The worker
    runs every phase at every chunk cursor back to back with
    ``n_steps=0`` (each phase program carries the decode While, which
    exits at once: this scope's slot state is never decoded), copies the
    finished entry's cross-KV rows off its scope, waits for its stream to
    finish writing them, and hands them to the server's callback; the
    server copies them into its own pools and admits the request as a
    prefix hit.

    Unsharded two-scope mode: ``params_from=`` copies the weights (every
    value of that scope the worker's scope lacks) into its scope. The
    default executor is the card's, ``Executor()``. A bundle that carries
    phase sharding plans (``prefill_plan``) is refused: the sharded mode
    is serving step 10 of the port.
    """

    def __init__(self, bundle, executor=None, scope=None,
                 params_from=None, start: bool = True):
        cache = getattr(bundle, "cache", None)
        if cache is None or cache.layout != "paged" or not cache.chunked:
            raise ValueError(
                "DisaggregatedPrefillWorker needs a paged bundle built "
                "with CacheConfig(chunk_tokens=C): the phase split is the "
                "chunk-program set")
        if getattr(bundle, "prefill_plan", None) is not None:
            raise NotImplementedError(
                "DisaggregatedPrefillWorker over a bundle with phase "
                "sharding plans: the sharded mode is not ported yet "
                "(serving step 10 of the port: apply_phase_sharding, "
                "place_disaggregated_bundle); use the unsharded "
                "two-scope mode (params_from=)")
        self.bundle = bundle
        self.executor = executor or Executor(CUDAPlace(0))
        self.scope = scope or Scope()
        dev = self.executor.device
        if params_from is not None:
            for name in params_from.local_var_names():
                # the slot state is seeded fresh below
                if name not in bundle._state_specs \
                        and self.scope._get(name) is None:
                    val = params_from._get(name)
                    if torch.is_tensor(val):
                        self.scope._set(name, val.detach().to(dev).clone())
        bundle.init_slot_state(self.scope, dev)
        self._chunk_keys = bundle.chunk_phase_keys
        self._n_chunks = cache.n_chunks(bundle.seq_len)
        prefix = bundle.state["tok_buf"][:-len("tok_buf")]
        pat = re.compile(re.escape(prefix) + r"cross_[kv]\d+"
                         + re.escape(POOL_MARK))
        self._cross_names = sorted(
            n for n in bundle._state_specs if pat.fullmatch(n))
        before = self.executor.prepare_count
        fetches = [bundle.state["step"]]
        self._serves = {
            k: self.executor.prepare(
                bundle.serves[k], feed=bundle.serve_feed_spec(k),
                fetch_list=fetches, scope=self.scope)
            for k in self._chunk_keys}
        self._warmed_compiles = self.executor.prepare_count - before
        self._cv = threading.Condition()
        self._jobs: "collections.deque" = collections.deque()
        self._running = False
        self._closed = False
        self._busy = False
        self._jobs_done = 0
        self._jobs_failed = 0
        self._ticks = 0
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    # --- lifecycle ----------------------------------------------------
    def start(self):
        with self._cv:
            if self._running:
                return
            if self._closed:
                raise ServerClosed("DisaggregatedPrefillWorker closed")
            self._running = True
            self._thread = threading.Thread(
                target=self._loop, name="paddle-tpu-prefill-worker",
                daemon=True)
            self._thread.start()

    def drain(self, timeout: Optional[float] = 60.0) -> bool:
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        with self._cv:
            while self._running and (self._jobs or self._busy):
                if deadline is None:
                    self._cv.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return not (self._jobs or self._busy)

    def close(self, timeout: float = 5.0):
        with self._cv:
            self._running = False
            self._closed = True
            dropped = list(self._jobs)
            self._jobs.clear()
            self._cv.notify_all()
        for req, prompt, entry, _done, fail in dropped:
            fail(req, prompt, entry,
                 ServerClosed("DisaggregatedPrefillWorker closed"))
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --- the job surface the decode server routes to ------------------
    def submit_job(self, req, prompt, entry, on_done, on_fail):
        """Queue one prefill job. ``on_done(req, prompt, entry, rows)`` or
        ``on_fail(req, prompt, entry, exc)`` runs on the worker's thread,
        outside the worker's lock; ``rows`` maps each cross-pool state
        name to the entry's finished [H, S, Dh] row (a tensor on the
        worker's device, written before the callback runs)."""
        with self._cv:
            if not self._running or self._closed:
                raise ServerClosed("DisaggregatedPrefillWorker closed")
            self._jobs.append((req, prompt, entry, on_done, on_fail))
            self._cv.notify_all()

    def _loop(self):
        while True:
            with self._cv:
                while self._running and not self._jobs:
                    self._cv.wait()
                if not self._running:
                    return
                job = self._jobs.popleft()
                self._busy = True
            req, prompt, entry, on_done, on_fail = job
            try:
                rows = self._run_job(req, entry)
            except BaseException as e:
                with self._cv:
                    self._busy = False
                    self._jobs_failed += 1
                    self._cv.notify_all()
                on_fail(req, prompt, entry, e)
            else:
                with self._cv:
                    self._busy = False
                    self._jobs_done += 1
                    self._cv.notify_all()
                on_done(req, prompt, entry, rows)

    def _run_job(self, req, entry):
        """The phase-major walk (every chunk of phase p before phase p+1),
        one dispatch per (phase, chunk), in the decode server's own
        chunk-job order, so the entry is the one its local job writes."""
        C = self.bundle.cache.chunk_tokens
        src = np.asarray(req.src).reshape(-1)
        for key in self._chunk_keys:
            for ci in range(self._n_chunks):
                feed = {"n_steps": np.array([0], np.int64),
                        "min_active": np.array([0], np.int64),
                        "chunk_entry": np.array([entry], np.int64),
                        "chunk_pos": np.array([ci * C], np.int64)}
                if key[1] == 0:
                    toks = np.zeros((1, C), np.int64)
                    seg = src[ci * C: ci * C + C]
                    toks[0, :len(seg)] = seg
                    feed["chunk_toks"] = toks
                self._serves[key].run(feed, return_numpy=False)
                with self._cv:
                    self._ticks += 1
        rows = {name: self.scope._get(name)[entry].clone()
                for name in self._cross_names}
        dev = self.executor.device
        if dev.type == "cuda":
            # the server's thread reads the rows on its own stream: they
            # must be written before the handoff
            torch.cuda.current_stream(dev).synchronize()
        return rows

    def stats(self) -> dict:
        with self._cv:
            return {
                "jobs_done": self._jobs_done,
                "jobs_failed": self._jobs_failed,
                "jobs_queued": len(self._jobs),
                "chunk_ticks": self._ticks,
                "warmed_compiles": self._warmed_compiles,
            }


class PagedBeamDecoder:
    """Beam search where beam branching is copy-on-write block branching
    (``serving.py:3844`` in the JAX package; the reference's beam_search,
    tests/unittests/dist_transformer.py:1523, holds beam_size whole
    dense histories, where the paged pool stores each shared hypothesis
    prefix once).

    It drives the bundle's probe program: one device tick that runs the
    cached decoder over every lane and publishes each lane's
    next-token distribution (``probe_probs``), with ``prefill_until``
    pinned to ``max_out_len`` so the device never emits a token or
    latches a lane. The host owns the tokens, scores, block tables and
    refcounts. At each expansion step:

    * a child shares its parent's full blocks read-only (``incref``);
    * the parent's partial tail block is copied through the bundle's
      COW program into a fresh exclusive block for each diverging
      child, the only write path into branched state;
    * a parent with a single heir hands its tail over without a copy
      (beam_size 1 is greedy decoding with no copy at all).

    The expansion mirrors the ``beam_search`` op
    (``paddle_tpu/ops/decode_ops.py:21``) in numpy: 2*beam candidates,
    accumulated log-probs, EOS freezing, and the lower index first on
    ties. ``cow_blocks`` counts the copied blocks and
    ``shared_block_peak`` the most blocks shared at once.

    It owns the bundle's slot state between calls: do not serve the
    same bundle and scope from a continuous server at the same time.
    """

    def __init__(self, bundle, beam_size, executor=None, scope=None):
        cache = getattr(bundle, "cache", None)
        if cache is None or cache.layout != "paged" \
                or getattr(bundle, "probe", None) is None:
            raise ValueError(
                "PagedBeamDecoder needs a paged bundle without a draft "
                "(its probe and cow programs); build with "
                "CacheConfig(layout='paged') and no DraftConfig")
        if not 1 <= int(beam_size) <= bundle.n_slots:
            raise ValueError(
                f"beam_size {beam_size} must fit the bundle's "
                f"{bundle.n_slots} lanes")
        self.bundle = bundle
        self.beam = int(beam_size)
        self.executor = executor or Executor(CUDAPlace(0))
        self.scope = scope or global_scope()
        self.cache = cache
        self._bs = cache.block_size
        self._pool = HostBlockPool(cache.n_blocks)
        bundle.init_slot_state(self.scope, self.executor.device)
        st = bundle.state
        self._st = st
        self._rows = bundle.n_slots + 1
        self._probe = self.executor.prepare(
            bundle.probe, feed=[],
            fetch_list=[st["probe_probs"], st["step"]], scope=self.scope)
        self._cow = self.executor.prepare(
            bundle.cow, feed=bundle.cow_feed_spec(),
            fetch_list=[st["step"]], scope=self.scope)
        # admission reuses the fused serves at n_steps=0 (prefill and
        # lane reset, no tick): beam 0 encodes the prompt into entry 0
        # (a miss), beams 1.. reset as hits
        buckets = sorted({k[1] for k in bundle.serves
                          if isinstance(k, tuple)})
        mk = ("miss", _bucket_for(1, buckets, "beam admission"))
        self._miss = self.executor.prepare(
            bundle.serves[mk], feed=bundle.serve_feed_spec(mk),
            fetch_list=[st["step"]], scope=self.scope)
        self._miss_A = mk[1]
        self._hit = None
        if self.beam > 1:
            hk = ("hit", _bucket_for(self.beam - 1, buckets,
                                     "beam fan-out"))
            self._hit = self.executor.prepare(
                bundle.serves[hk], feed=bundle.serve_feed_spec(hk),
                fetch_list=[st["step"]], scope=self.scope)
            self._hit_A = hk[1]
        self.cow_blocks = 0
        self.shared_block_peak = 0

    def _set(self, name, val):
        self.scope._set(self._st[name], torch.from_numpy(
            np.ascontiguousarray(val)).to(self.executor.device))

    def _alloc(self):
        b = self._pool.alloc()
        if b is None:
            raise BlockPoolExhausted(
                f"beam branching exhausted the KV block pool "
                f"(n_blocks={self._pool.n_blocks}, beam={self.beam}); "
                f"retryable against a larger pool")
        return b

    def _admit(self, arr, tab, pref):
        self._set("block_tab", tab)
        self._set("prompt_ref", pref)
        zero = np.array([0], np.int64)
        A = self._miss_A
        slots = np.full((A,), self.bundle.dustbin, np.int64)
        pslots = np.full((A,), self.cache.n_prompt_entries, np.int64)
        slots[0] = pslots[0] = 0
        feed = {"src_ids": np.repeat(arr, A, axis=0), "slots": slots,
                "prompt_slots": pslots, "n_steps": zero,
                "min_active": zero}
        # a sampled bundle's admissions take seeds; the probe ticks
        # never sample (the host picks every token)
        if self.bundle.needs_seeds:
            feed["seeds"] = np.zeros((A,), np.int64)
        self._miss.run(feed, return_numpy=True)
        if self._hit is not None:
            slots = np.full((self._hit_A,), self.bundle.dustbin, np.int64)
            slots[:self.beam - 1] = np.arange(1, self.beam)
            feed = {"slots": slots, "n_steps": zero, "min_active": zero}
            if self.bundle.needs_seeds:
                feed["seeds"] = np.zeros((self._hit_A,), np.int64)
            self._hit.run(feed, return_numpy=True)

    def decode(self, src_ids, return_all=False):
        """One prompt row in; the best hypothesis out as ``(tokens
        [max_out_len] sentinel-normalized, score)``, or every hypothesis
        best first with ``return_all=True``."""
        W, maxT, bs = self.beam, self.bundle.max_out_len, self._bs
        end_id = self.bundle.end_id
        arr = np.asarray(src_ids)
        if arr.ndim == 1:
            arr = arr[None]
        if arr.shape != (1, self.bundle.seq_len):
            raise ValueError(
                f"beam decode takes one prompt row of exactly "
                f"seq_len={self.bundle.seq_len} tokens; got "
                f"{tuple(np.asarray(src_ids).shape)}")
        arr = arr.astype(np.int64)
        rows = self._rows
        tab = np.zeros((rows, self.cache.pages(maxT)), np.int32)
        pref = np.full((rows,), self.cache.n_prompt_entries, np.int32)
        pref[:W] = 0
        tables = []
        for b in range(W):
            blk = self._alloc()
            tables.append([blk])
            tab[b, 0] = blk
        self._admit(arr, tab, pref)
        # probe mode, set after the admission (its lane reset clears
        # prefill_until): the device computes KV and distributions but
        # never emits
        until = np.zeros((rows,), np.int64)
        until[:W] = maxT
        self._set("prefill_until", until)
        buf = np.zeros((rows, maxT), np.int64)
        buf[:W, 0] = self.bundle.start_id
        scores = np.full((W,), -1e9, np.float32)
        scores[0] = 0.0  # a single live seed
        act = np.zeros((rows,), np.int64)
        act[:W] = 1
        neg = np.finfo(np.float32).min
        for s in range(maxT - 1):
            self._set("tok_buf", buf)
            self._set("active", act)
            self._set("block_tab", tab)
            probs = np.asarray(self._probe.run({}, return_numpy=True)[0])[:W]
            k2 = min(2 * W, probs.shape[1])
            finished = buf[:W, s] == end_id
            cand_ids = np.empty((W, k2), np.int64)
            cand_tot = np.empty((W, k2), np.float32)
            for b in range(W):
                if finished[b]:
                    # a frozen beam's only candidate is end_id at its
                    # unchanged score
                    cand_ids[b] = end_id
                    cand_tot[b] = neg
                    cand_tot[b, 0] = scores[b]
                else:
                    order = np.argsort(-probs[b], kind="stable")[:k2]
                    cand_ids[b] = order
                    with np.errstate(divide="ignore"):
                        cand_tot[b] = np.log(probs[b, order]) + scores[b]
            flat = cand_tot.reshape(-1)
            top = np.argsort(-flat, kind="stable")[:W]
            parents = top // k2
            toks = cand_ids.reshape(-1)[top]
            scores = flat[top].astype(np.float32)
            # reassignment: sharing, inheritance, COW
            boundary = (s + 1) % bs == 0
            c = s // bs  # the block holding position s (just written)
            heirs = collections.Counter(int(p) for p in parents)
            new_tables, cow_src, cow_dst = [], [], []
            for b in range(W):
                pt = tables[int(parents[b])]
                if boundary:
                    # block c is full: shared read-only; the next write
                    # opens a fresh block either way
                    share, tail = pt[:c + 1], None
                elif heirs[int(parents[b])] == 1:
                    # a sole heir inherits the partial tail
                    share, tail = pt, []
                else:
                    # each diverging child copies the partial block
                    share = pt[:c]
                    tail = [self._alloc()]
                    cow_src.append(pt[c])
                    cow_dst.append(tail[0])
                for blk in share:
                    self._pool.incref(blk)
                if tail is None:
                    tail = [self._alloc()]
                new_tables.append(share + tail)
            if cow_src:
                # the copy runs before the old refs drop: the sources
                # stay pinned while read
                csrc = np.zeros((rows,), np.int64)
                cdst = np.full((rows,), -1, np.int64)
                cgate = np.zeros((rows,), np.float32)
                csrc[:len(cow_src)] = cow_src
                cdst[:len(cow_dst)] = cow_dst
                cgate[:len(cow_src)] = 1.0
                self._cow.run({"cow_src": csrc, "cow_dst": cdst,
                               "cow_gate": cgate}, return_numpy=True)
                self.cow_blocks += len(cow_src)
            for pt in tables:
                for blk in reversed(pt):
                    self._pool.decref(blk)
            tables = new_tables
            tab[:W, :] = 0
            for b in range(W):
                tab[b, :len(tables[b])] = tables[b]
            self.shared_block_peak = max(self.shared_block_peak,
                                         len(self._pool.shared_blocks()))
            newbuf = buf.copy()
            for b in range(W):
                newbuf[b] = buf[int(parents[b])]
                newbuf[b, s + 1] = toks[b]
            buf = newbuf
            if np.all(toks == end_id):
                break  # every hypothesis frozen: later steps change nothing
        order = np.argsort(-scores, kind="stable")
        hyps = [(apply_eos_sentinel(buf[b:b + 1], end_id)[0],
                 float(scores[b])) for b in order]
        for pt in tables:
            for blk in reversed(pt):
                self._pool.decref(blk)
        return hyps if return_all else hyps[0]
