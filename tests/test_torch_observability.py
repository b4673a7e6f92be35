"""The port's observability layer (paddle_tpu_torch/observability,
flags.py, profiler.py) on the CPU: the cases of the JAX package's
tests/test_observability.py that do not need its Router (histograms, the
profiler's capture window, the metrics registry, request traces, the
flight recorder, the schema of stats() and expose()), each against the
JAX package's own classes and servers where both have one:

* ``Histogram`` percentiles and ``cumulative_counts`` equal the JAX
  class's on the same samples, exactly;
* ``expose()`` of a registry fed the same instruments is byte-equal;
* for the same dense and paged traffic the two packages' ``stats()``
  keysets and exposition families are equal, apart from PORT_ONLY_*
  below (each with its reason).

Both packages keep process-global flags, tracers, recorders and
registries; the fixture sets the flags of both and resets both around
every test.
"""
import bisect
import json
import time
import warnings

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprofiler
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.inference import serving as JS
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import profiler
from paddle_tpu_torch.flags import FLAGS, get_flags, set_flags
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.observability.metrics import (Histogram,
                                                    MetricsRegistry,
                                                    default_ms_buckets)

import torch_radix_setup as R
from torch_paged_setup import MODEL, PortModel, paged_cache, prompts

# stats() keys the port has and the JAX package has not
PORT_ONLY_STATS = {
    # the executor's PreparedProgram builds: the port's counterpart of
    # an XLA compile, beside compile_count (its CUDA-graph captures)
    "prepare_count",
}
PORT_ONLY_POOL = {
    # radix admissions by shared depth, cumulative a bucket: the
    # histogram the JAX package exposes only as a metric family
    "prefix_hit_depth",
}
# exposition families the port has and the JAX package has not
PORT_ONLY_FAMILIES = {
    # PreparedProgram builds (see prepare_count)
    "paddle_tpu_executor_prepares_total",
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_hermetic():
    """Both packages' FLAGS_observability restored, and their trace,
    flight and profiler sinks cleared, around every test."""
    saved = (FLAGS._values["observability"],
             JFLAGS._values["observability"])
    for p, o in ((profiler, obs), (jprofiler, jobs)):
        p.reset_profiler()
        o.reset()
    yield
    FLAGS._values["observability"], JFLAGS._values["observability"] = saved
    for p, o in ((profiler, obs), (jprofiler, jobs)):
        p.reset_profiler()
        o.reset()


def _set_level(level):
    FLAGS._values["observability"] = level
    JFLAGS._values["observability"] = level


def _fc_runner(fl, serving, prefix):
    """The fc model of the JAX package's test (16 -> 32 relu -> 8) in one
    package, its weights from seeded numpy, in a ProgramRunner."""
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data(f"{prefix}_x", shape=[16], dtype="float32")
        h = fl.layers.fc(x, 32, act="relu",
                         param_attr=fl.ParamAttr(name=f"{prefix}_w1"),
                         bias_attr=fl.ParamAttr(name=f"{prefix}_b1"))
        out = fl.layers.fc(h, 8, param_attr=fl.ParamAttr(name=f"{prefix}_w2"),
                           bias_attr=fl.ParamAttr(name=f"{prefix}_b2"))
    rng = np.random.RandomState(0)
    scope = fl.Scope()
    for name, shape in ((f"{prefix}_w1", (16, 32)), (f"{prefix}_b1", (32,)),
                        (f"{prefix}_w2", (32, 8)), (f"{prefix}_b2", (8,))):
        val = (0.2 * rng.randn(*shape)).astype(np.float32)
        if fl is pf:
            pf.load_numpy_params(scope, {name: val}, pf.CPUPlace())
        else:
            scope._set(name, val)
    return serving.ProgramRunner(main, [x.name], [out.name],
                                 executor=fl.Executor(fl.CPUPlace()),
                                 scope=scope)


def _fc_server(prefix="obsm", **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("max_wait_ms", 1.0)
    return PS.InferenceServer(_fc_runner(pf, PS, prefix), **kw)


def _submit_n(srv, n, prefix="obsm", rows=1):
    rng = np.random.RandomState(0)
    reps = [srv.submit({f"{prefix}_x": rng.randn(rows, 16).astype(
        np.float32)}) for _ in range(n)]
    return [r.result(120.0) for r in reps]


def _family(line):
    """A metric family from an exposition line (a summary's _count and
    _sum folded back)."""
    name = line.split("{")[0].split(" ")[0]
    for suffix in ("_count", "_sum"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


# --------------------------------------------------------------------
# flags
# --------------------------------------------------------------------
class TestFlags:
    def test_levels_and_spellings(self):
        for given, want in (("trace", "trace"), ("METRICS", "metrics"),
                            ("0", "off"), ("1", "metrics"), ("", "off")):
            set_flags({"FLAGS_observability": given})
            assert get_flags("FLAGS_observability") == {
                "FLAGS_observability": want}
            assert obs.metrics_on() == (want != "off")
            assert obs.trace_on() == (want == "trace")
        with pytest.raises(ValueError):
            set_flags({"FLAGS_observability": "verbose"})
        with pytest.raises(ValueError, match="unknown flag"):
            set_flags({"FLAGS_eager_delete_tensor_gb": 0})

    def test_parser_is_the_jax_packages(self):
        from paddle_tpu.flags import _as_obs_mode as j_mode
        from paddle_tpu_torch.flags import _as_obs_mode as p_mode

        for s in ("off", "metrics", "trace", "0", "false", "no", "",
                  "1", "true", "yes", "on", " Trace "):
            assert p_mode(s) == j_mode(s), s

    def test_cache_capacity_bounds_the_executor(self):
        saved = FLAGS.executor_cache_capacity
        set_flags({"FLAGS_executor_cache_capacity": 2})
        try:
            exe = pf.Executor(pf.CPUPlace())
            scope = pf.Scope()
            progs = []
            for i in range(3):
                main, startup = pf.Program(), pf.Program()
                with pf.program_guard(main, startup):
                    x = pf.layers.data("x", shape=[2], dtype="float32")
                    y = pf.layers.scale(x, scale=float(i + 1))
                progs.append((main, y))
            for main, y in progs:
                exe.run(main, feed={"x": np.ones((1, 2), np.float32)},
                        fetch_list=[y], scope=scope)
            assert len(exe._cache) == 2 and exe.cache_evict_count == 1
            assert exe.prepare_count == 3
        finally:
            set_flags({"FLAGS_executor_cache_capacity": saved})


# --------------------------------------------------------------------
# fixed-bucket histograms
# --------------------------------------------------------------------
class TestHistogram:
    def test_p99_within_one_bucket_of_exact(self):
        rng = np.random.RandomState(7)
        edges = default_ms_buckets()
        for dist in (rng.lognormal(3.0, 1.0, 5000),
                     rng.exponential(120.0, 5000),
                     rng.uniform(0.5, 400.0, 5000)):
            h = Histogram("t")
            for v in dist:
                h.observe(float(v))
            samples = sorted(float(v) for v in dist)
            for p in (0.50, 0.99):
                exact = PS._pct(samples, p)
                est = h.percentile(p)
                idx = bisect.bisect_left(edges, exact)
                lo = edges[idx - 1] if idx > 0 else 0.0
                hi = edges[idx] if idx < len(edges) else samples[-1]
                assert lo <= est <= hi, (p, est, lo, hi)

    @pytest.mark.parametrize("dist", ["lognormal", "exponential",
                                      "uniform", "spikes"])
    def test_equals_the_jax_class(self, dist):
        """The same samples into both classes: every percentile, count,
        sum and cumulative count equal, exactly."""
        rng = np.random.RandomState(11)
        vals = {"lognormal": lambda: rng.lognormal(2.0, 1.5, 3000),
                "exponential": lambda: rng.exponential(50.0, 3000),
                "uniform": lambda: rng.uniform(0.0, 2e6, 3000),
                "spikes": lambda: np.repeat([0.0, 1e-4, 7.5, 1e9], 25)}[
                    dist]()
        ph, jh = Histogram("t"), jmetrics.Histogram("t")
        for v in vals:
            ph.observe(float(v))
            jh.observe(float(v))
        for p in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert ph.percentile(p) == jh.percentile(p), p
        assert ph.cumulative_counts() == jh.cumulative_counts()
        assert (ph.count, ph.sum) == (jh.count, jh.sum)
        assert ph.percentile_dict() == jh.percentile_dict()
        assert ph.buckets == jh.buckets == tuple(
            jmetrics.default_ms_buckets())

    def test_custom_buckets_equal_the_jax_class(self):
        edges = tuple(round(0.1 * i, 1) for i in range(1, 11))
        ph = Histogram("a", buckets=edges)
        jh = jmetrics.Histogram("a", buckets=edges)
        for v in np.random.RandomState(3).uniform(0, 1.2, 200):
            ph.observe(float(v))
            jh.observe(float(v))
        assert ph.cumulative_counts() == jh.cumulative_counts()
        assert ph.percentile(0.5) == jh.percentile(0.5)
        with pytest.raises(ValueError, match="ascending"):
            Histogram("bad", buckets=[2.0, 1.0])

    def test_memory_is_o1_in_sample_count(self):
        h = Histogram("t")
        n_cells = len(h._counts)
        for v in np.random.RandomState(0).exponential(50.0, 20000):
            h.observe(float(v))
        assert len(h._counts) == n_cells
        assert h.count == 20000 == len(h)
        assert not hasattr(h, "maxlen")

    def test_overflow_bucket_reports_tracked_max(self):
        h = Histogram("t", buckets=[1.0, 10.0])
        for v in (0.5, 5.0, 1e9):
            h.observe(v)
        assert h.percentile(0.99) == 1e9

    def test_reset_window(self):
        h = Histogram("t")
        h.observe(5.0)
        assert h.count == 1
        h.reset()
        assert h.count == 0 and h.percentile(0.5) is None and h.sum == 0
        h.observe(2.0)
        assert h.count == 1

    def test_pct_dict_handles_both_shapes(self):
        h = Histogram("t")
        for v in (1.0, 2.0, 3.0):
            h.observe(v)
        d = PS._pct_dict(h)
        assert set(d) == {"p50", "p99"} and d["p50"] is not None
        assert PS._pct_dict([1.0, 2.0, 3.0]) == JS._pct_dict(
            [1.0, 2.0, 3.0]) == {"p50": 2.0, "p99": 3.0}

    def test_empty_histogram(self):
        h = Histogram("t")
        assert h.percentile(0.5) is None
        assert PS._pct_dict(h) == {"p50": None, "p99": None}


# --------------------------------------------------------------------
# the profiler's capture window
# --------------------------------------------------------------------
class TestProfilerWindow:
    def test_pre_window_start_excluded_whole(self, tmp_path, capsys):
        ev = profiler.RecordEvent("pre_window")
        ev.__enter__()
        profiler.start_profiler()
        ev.__exit__(None, None, None)
        profiler.stop_profiler(profile_path=str(tmp_path / "profile"))
        assert "pre_window" not in [e[0] for e in
                                    profiler._snapshot_events()]

    def test_in_window_start_kept_past_stop(self, tmp_path, capsys):
        profiler.start_profiler()
        ev = profiler.RecordEvent("straddles_stop")
        ev.__enter__()
        profiler.stop_profiler(profile_path=str(tmp_path / "profile"))
        ev.__exit__(None, None, None)
        assert "straddles_stop" in [e[0] for e in
                                    profiler._snapshot_events()]

    def test_window_dumps_a_chrome_trace(self, tmp_path, capsys):
        with profiler.profiler(profile_path=str(tmp_path / "p")):
            with profiler.record_event("in_window"):
                time.sleep(0.001)
        with open(str(tmp_path / "p") + ".chrome_trace.json") as f:
            events = json.load(f)["traceEvents"]
        assert [e["name"] for e in events] == ["in_window"]
        assert events[0]["dur"] >= 1000.0 * 0.5
        assert "in_window" in capsys.readouterr().out

    def test_reset_profiler_clears_events(self, tmp_path, capsys):
        profiler.start_profiler()
        with profiler.record_event("to_reset"):
            pass
        profiler.stop_profiler(profile_path=str(tmp_path / "profile"))
        assert profiler._snapshot_events()
        profiler.reset_profiler()
        assert profiler._snapshot_events() == []

    def test_trace_flag_captures_without_profiler_window(self):
        _set_level("trace")
        with profiler.record_event("obs_trace_host_span"):
            pass
        assert "obs_trace_host_span" in [
            e[0] for e in profiler._snapshot_events()]

    def test_event_ring_is_bounded(self):
        assert profiler._events.maxlen == profiler._MAX_EVENTS \
            == jprofiler._MAX_EVENTS

    def test_off_records_nothing(self):
        _set_level("off")
        with profiler.record_event("dropped"):
            pass
        assert profiler._snapshot_events() == []

    def test_cuda_profiler_needs_no_card_for_its_host_side(self, tmp_path):
        """cuda_profiler records with torch.profiler (CUDA activity when
        there is a card) and exports a chrome trace into its directory."""
        d = tmp_path / "cuda_trace"
        with profiler.cuda_profiler(str(d) + ".nvprof"):
            torch.ones(4).sum()
        with open(d / "device.chrome_trace.json") as f:
            assert "traceEvents" in json.load(f)


# --------------------------------------------------------------------
# metrics registry
# --------------------------------------------------------------------
def _feed_registry(reg):
    """The same instruments into either package's registry."""
    reg.counter("reqs_total", help="requests",
                labels={"server": "s1"}).inc(3)
    reg.counter("reqs_total", labels={"server": 's"2\\x\ny'}).inc(0.5)
    reg.gauge("depth", labels={"server": "s1"}).set(7.25)
    reg.gauge("ratio").set(1e-7)
    h = reg.histogram("lat_ms", labels={"server": "s1"})
    for v in np.random.RandomState(5).lognormal(2.0, 1.0, 500):
        h.observe(float(v))
    reg.histogram("empty_ms", labels={"b": "2", "a": "1"})
    e = reg.histogram("edges", buckets=(0.1, 0.5, 1.0))
    for v in (0.05, 0.3, 0.3, 2.0):
        e.observe(v)

    class P:
        def _metrics_samples(self):
            return [("prov_total", {"k": "v"}, 12),
                    ("prov_gauge", {}, 0.125)]

    p = P()
    reg.register_provider(p)
    return p


class TestMetricsRegistry:
    def test_off_exposition_is_empty(self):
        _set_level("off")
        text = obs.metrics.expose()
        assert text.startswith("# observability disabled")
        assert "paddle_tpu" not in text

    def test_expose_is_byte_equal_to_the_jax_registry(self):
        _set_level("metrics")
        preg, jreg = MetricsRegistry(), jmetrics.MetricsRegistry()
        keep = (_feed_registry(preg), _feed_registry(jreg))
        ptext, jtext = preg.expose(), jreg.expose()
        assert ptext == jtext
        assert 'reqs_total{server="s\\"2\\\\x\\ny"} 0.5' in ptext
        assert 'lat_ms_count{server="s1"} 500' in ptext
        _set_level("off")
        assert preg.expose() == jreg.expose()
        del keep

    def test_instruments_dedupe_by_name_and_labels(self):
        reg = MetricsRegistry()
        c1 = reg.counter("c", labels={"a": "1"})
        c2 = reg.counter("c", labels={"a": "1"})
        c3 = reg.counter("c", labels={"a": "2"})
        assert c1 is c2 and c1 is not c3
        c1.inc(2)
        assert c2.value == 2.0 and c3.value == 0.0
        assert reg.histogram("h") is reg.histogram("h")
        assert reg.gauge("g") is reg.gauge("g")

    def test_provider_weakref_pruned(self):
        _set_level("metrics")
        reg = MetricsRegistry()

        class P:
            def _metrics_samples(self):
                return [("ephemeral_metric", {}, 1.0)]

        p = P()
        reg.register_provider(p)
        assert any(n == "ephemeral_metric" for n, _, _ in reg.collect())
        del p
        assert not any(n == "ephemeral_metric"
                       for n, _, _ in reg.collect())

    def test_broken_provider_never_breaks_expose(self):
        _set_level("metrics")
        reg = MetricsRegistry()

        class Broken:
            def _metrics_samples(self):
                raise RuntimeError("boom")

        b = Broken()
        reg.register_provider(b)
        reg.counter("survives").inc()
        assert "survives 1" in reg.expose()

    def test_histogram_exposition_shape(self):
        _set_level("metrics")
        reg = MetricsRegistry()
        h = reg.histogram("lat_ms", labels={"server": "s1"})
        for v in (1.0, 5.0, 9.0):
            h.observe(v)
        text = reg.expose()
        assert 'lat_ms{quantile="0.5",server="s1"}' in text
        assert 'lat_ms_count{server="s1"} 3' in text
        assert 'lat_ms_sum{server="s1"} 15' in text

    def test_no_duplicate_series_across_instances(self):
        """Every server and executor labels its samples with its own id:
        two co-resident servers never emit one (name, labels) twice."""
        _set_level("metrics")
        servers = [_fc_server(f"dup{i}", start=False) for i in range(2)]
        try:
            keys = [(n, tuple(sorted(l.items())))
                    for n, l, _ in obs.metrics.REGISTRY.collect()]
            dupes = sorted({k for k in keys if keys.count(k) > 1})
            assert not dupes, dupes
            ids = {s._obs_id for s in servers}
            assert len(ids) == 2 and all(
                i.startswith("InferenceServer-") for i in ids)
        finally:
            for s in servers:
                s.close()

    def test_label_values_are_escaped(self):
        _set_level("metrics")
        reg = MetricsRegistry()
        reg.counter("hits", labels={"tenant": 'team"a\\b\nc'}).inc()
        assert 'hits{tenant="team\\"a\\\\b\\nc"} 1' in reg.expose()

    def test_module_surface(self):
        _set_level("metrics")
        c = obs.metrics.counter("paddle_tpu_test_module_total",
                                labels={"t": "x"})
        c.inc()
        obs.metrics.gauge("paddle_tpu_test_module_gauge").set(2)
        obs.metrics.histogram("paddle_tpu_test_module_ms").observe(1.0)
        text = obs.metrics.expose()
        assert 'paddle_tpu_test_module_total{t="x"} 1' in text
        assert "paddle_tpu_test_module_gauge 2" in text
        assert "paddle_tpu_test_module_ms_count 1" in text


# --------------------------------------------------------------------
# request traces through a standalone server
# --------------------------------------------------------------------
_CHAIN = {"request", "server.queue", "server.dispatch", "execute",
          "readback"}


class TestTracePropagation:
    def test_span_tree_connected_per_request(self, tmp_path):
        """Every traced request's chrome events form one tree rooted at
        its request span, holding queue, dispatch, execute and readback;
        aot_warmup's PreparedProgram builds are global compile events,
        and none comes once the buckets are warm."""
        _set_level("trace")
        srv = _fc_server("obst1")
        try:
            assert srv.aot_warmup() == len(srv.batch_buckets)
            with obs.TRACER._lock:
                compiles = [dict(s.attrs) for s in obs.TRACER.global_events
                            if s.name == "compile"]
            assert compiles and all(
                a["tier"] == "cold" and len(a["fingerprint"]) == 16
                for a in compiles), compiles
            obs.reset()
            _submit_n(srv, 12, "obst1")
            trace = obs.dump_trace(str(tmp_path / "trace"))
        finally:
            srv.close()
        with open(tmp_path / "trace.json") as f:
            assert json.load(f) == json.loads(json.dumps(trace))
        reqs = {}
        for e in trace["traceEvents"]:
            if e.get("cat") == "request":
                reqs.setdefault(e["args"]["request_id"], []).append(e)
            assert e.get("cat") != "compile", e
        assert len(reqs) == 12
        for rid, events in reqs.items():
            assert _CHAIN <= {e["name"] for e in events}, rid
            ids = {e["args"]["span"] for e in events}
            roots = [e for e in events if e["args"]["parent"] is None]
            assert len(roots) == 1 and roots[0]["name"] == "request"
            assert all(e["args"]["parent"] in ids for e in events
                       if e["args"]["parent"] is not None)
            by_name = {e["name"]: e for e in events}
            assert by_name["execute"]["args"]["cache"] == "memory"
            assert by_name["server.dispatch"]["args"]["cache"] == "memory"
            assert by_name["request"]["args"]["server"] == srv._obs_id
            # the cost model's snapshot rides on the execute span
            assert by_name["execute"]["args"]["flops"] > 0

    def test_off_emits_nothing(self, tmp_path):
        _set_level("off")
        srv = _fc_server("obst2")
        try:
            _submit_n(srv, 4, "obst2")
            trace = obs.dump_trace(str(tmp_path / "trace_off"))
        finally:
            srv.close()
        assert [e for e in trace["traceEvents"] if e.get("ph") != "M"] \
            == []
        assert obs.RECORDER.recorded_total == 0
        assert obs.start_request() is None
        assert obs.metrics.expose().startswith("# observability disabled")

    def test_host_spans_merge_into_one_dump(self, tmp_path):
        _set_level("trace")
        with profiler.record_event("host_side_work"):
            time.sleep(0.001)
        trace = obs.dump_trace(str(tmp_path / "merged"))
        host = [e for e in trace["traceEvents"] if e.get("cat") == "host"]
        assert any(e["name"] == "host_side_work" for e in host)
        assert all(e["pid"] == 0 for e in host)

    def test_cache_tier_cold_then_memory(self):
        """The first request of an unwarmed bucket builds its
        PreparedProgram (cold), the repeat finds it (memory)."""
        _set_level("trace")
        srv = _fc_server("obst3")
        feed = {"obst3_x": np.random.RandomState(0).randn(1, 16).astype(
            np.float32)}
        try:
            srv.submit(dict(feed)).result(120.0)
            srv.submit(dict(feed)).result(120.0)
        finally:
            srv.close()
        with obs.TRACER._lock:
            cold_t, warm_t = list(obs.TRACER.completed)[-2:]

        def tiers(tr):
            return {s.attrs.get("cache") for s in tr.spans
                    if s.name in ("execute", "server.dispatch")}

        assert tiers(cold_t) == {"cold"} and tiers(warm_t) == {"memory"}

    def test_request_context_adopts_a_callers_trace(self):
        """A trace parked by the caller (a router's) is adopted, and the
        server leaves finishing it to its owner."""
        _set_level("trace")
        srv = _fc_server("obst4")
        outer = obs.TRACER.start_request(owner="router")
        try:
            with obs.tracing.request_context(outer):
                rep = srv.submit({"obst4_x": np.zeros((1, 16), np.float32)})
            rep.result(120.0)
        finally:
            srv.close()
        assert outer.t_end is None  # not finished by the server
        names = {s.name for s in outer.spans}
        assert {"server.queue", "server.dispatch", "execute",
                "readback"} <= names
        outer.finish()
        assert obs.TRACER.completed[-1] is outer

    def test_error_path_keeps_server_queue_span(self):
        _set_level("trace")
        srv = _fc_server("obst5")

        def boom(feed):
            raise RuntimeError("injected dispatch failure")

        srv._runner.run_batch = boom
        try:
            with pytest.raises(RuntimeError, match="injected"):
                srv.infer({"obst5_x": np.zeros((1, 16), np.float32)},
                          timeout=30.0)
        finally:
            srv.close()
        inc = obs.incident_report()["incidents"][-1]
        assert inc["status"] == "error" and "injected" in inc["error"]
        assert "server.queue" in {s["name"] for s in inc["spans"]}


# --------------------------------------------------------------------
# the flight recorder
# --------------------------------------------------------------------
class TestFlightRecorder:
    def test_error_is_an_incident(self):
        _set_level("trace")
        srv = _fc_server("obsf1")
        try:
            rep = srv.submit({"obsf1_x": np.zeros((1, 7), np.float32)})
            with pytest.raises(Exception):
                rep.result(120.0)
        finally:
            srv.close()
        report = obs.incident_report()
        assert report["incidents_total"] >= 1
        inc = report["incidents"][-1]
        assert inc["status"] == "error" and "error" in inc
        json.dumps(report)

    def test_ring_bounds(self):
        _set_level("metrics")
        rec = obs.flight.FlightRecorder(max_recent=4, max_incidents=2)
        for i in range(10):
            rec.record({"request_id": f"r{i}"}, incident=(i % 2 == 0))
        assert len(rec.recent) == 4 and len(rec.incidents) == 2
        assert rec.recorded_total == 10 and rec.incidents_total == 5
        assert rec.incident_report(max_incidents=1)[
            "incidents_retained"] == 1

    def test_off_records_nothing(self):
        _set_level("off")
        rec = obs.flight.FlightRecorder()
        rec.record({"request_id": "x"}, incident=True)
        assert rec.recorded_total == 0 and not rec.incidents

    def test_private_rings_are_not_providers(self):
        _set_level("metrics")
        scratch = obs.flight.FlightRecorder(max_recent=4)
        for i in range(7):
            scratch.record({"request_id": f"s{i}"})
        lines = [ln for ln in obs.metrics.expose().splitlines()
                 if ln.startswith("paddle_tpu_flight_recorded_total")]
        assert len(lines) == 1, lines
        assert lines[0].endswith(f" {obs.RECORDER.recorded_total}")


# --------------------------------------------------------------------
# schema: the port's stats() and expose() against the JAX package's
# --------------------------------------------------------------------
def _jax_dense_bundle(n_slots):
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        return JT.build_decode_step_program(n_slots=n_slots, **MODEL)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The same dense and paged traffic through both packages' servers
    at FLAGS_observability=metrics (5 prompts, one of them a cancelled
    request), driven on this thread; returns each server's stats(), its
    samples' families and its executor's."""
    saved = (FLAGS._values["observability"],
             JFLAGS._values["observability"])
    _set_level("metrics")
    m = PortModel()
    srcs = prompts(5, 5)
    jexe = R.jax_executor()
    out = {}
    try:
        for kind in ("dense", "paged"):
            if kind == "dense":
                pb, jb = m.bundle(4), _jax_dense_bundle(4)
                ps = PS.ContinuousGenerationServer(
                    pb, executor=m.exe, scope=m.scope, start=False)
                js = JS.ContinuousGenerationServer(
                    jb, executor=jexe, scope=R.jax_scope(m.params),
                    start=False)
            else:
                ps = PS.PagedContinuousGenerationServer(
                    R.port_bundle(m), executor=m.exe, scope=m.scope,
                    start=False)
                js = JS.PagedContinuousGenerationServer(
                    R.jax_bundle(), executor=jexe,
                    scope=R.jax_scope(m.params), start=False)
            for srv in (ps, js):
                reps = [srv.submit(s) for s in srcs]
                reps[-1].cancel()
                R.drive(srv)
                for r in reps[:-1]:
                    r.result(timeout=0)
            out[kind] = {
                tag: dict(stats=srv.stats(),
                          families={n for n, _, _ in
                                    srv._metrics_samples()},
                          exe_families={n for n, _, _ in
                                        srv.executor._metrics_samples()})
                for tag, srv in (("port", ps), ("jax", js))}
            for srv in (ps, js):
                srv.close()
        exe = jf.Executor(jf.CPUPlace())
        out["jax_cache_families"] = {
            n for n, _, _ in exe._cache._metrics_samples()} \
            if hasattr(exe, "_cache") and hasattr(
                exe._cache, "_metrics_samples") else set()
    finally:
        FLAGS._values["observability"], \
            JFLAGS._values["observability"] = saved
    return out


class TestSchemaStability:
    @pytest.mark.parametrize("kind", ["dense", "paged"])
    def test_stats_keysets_equal_the_jax_servers(self, served, kind):
        p, j = served[kind]["port"]["stats"], served[kind]["jax"]["stats"]
        assert set(p) - set(j) == PORT_ONLY_STATS
        assert set(j) <= set(p)
        for key in ("latency_ms", "ttft_ms", "per_token_ms"):
            assert set(p[key]) == set(j[key]) == {"p50", "p99"}
        assert set(p["device_telemetry"]) == set(j["device_telemetry"])
        assert (p["requests"], p["completed"], p["cancelled"],
                p["tokens"]) == (j["requests"], j["completed"],
                                 j["cancelled"], j["tokens"])
        if kind == "paged":
            pp, jp = p["block_pool"], j["block_pool"]
            assert set(pp) - set(jp) == PORT_ONLY_POOL
            assert set(jp) <= set(pp)

    @pytest.mark.parametrize("kind", ["dense", "paged"])
    def test_server_families_equal_the_jax_servers(self, served, kind):
        assert served[kind]["port"]["families"] \
            == served[kind]["jax"]["families"]

    def test_executor_families(self, served):
        p = served["dense"]["port"]["exe_families"]
        j = served["dense"]["jax"]["exe_families"] \
            | served["jax_cache_families"]
        assert p - j == PORT_ONLY_FAMILIES
        assert {f for f in j if f.startswith(("paddle_tpu_executor_",
                                              "paddle_tpu_executable_"))} \
            <= p

    def test_inference_server_stats_keyset(self):
        """The port's InferenceServer stats() against the JAX package's
        golden model keys (its MODEL_KEYS less the registry's)."""
        want = set(TestSchemaStabilityGolden.MODEL_KEYS) - {
            "fingerprint", "kind", "max_inflight", "inflight"}
        srv = _fc_server("obsk")
        try:
            _submit_n(srv, 4, "obsk")
            st = srv.stats()
        finally:
            srv.close()
        assert set(st) - want == PORT_ONLY_STATS
        assert want <= set(st)

    def test_expose_golden_families(self):
        """The families the JAX package's golden set holds for a server,
        its executor and the flight recorder (the registry's, routers'
        and tenants' belong to the Router, not ported) are all exposed
        by a port server."""
        _set_level("metrics")
        srv = _fc_server("obsg")
        try:
            _submit_n(srv, 4, "obsg")
            text = obs.metrics.expose()
        finally:
            srv.close()
        families = {_family(ln) for ln in text.splitlines()
                    if ln and not ln.startswith("#")}
        want = {f for f in TestSchemaStabilityGolden.EXPOSE_FAMILIES
                if not f.startswith(("paddle_tpu_registry_",
                                     "paddle_tpu_tenant_"))}
        assert want <= families, sorted(want - families)


# the JAX package's golden sets, read off its test module
class TestSchemaStabilityGolden:
    from test_observability import TestSchemaStability as _J

    MODEL_KEYS = _J.MODEL_KEYS
    EXPOSE_FAMILIES = _J.EXPOSE_FAMILIES
    del _J

    def test_golden_sets_are_the_jax_tests(self):
        assert "compile_count" in self.MODEL_KEYS
        assert "paddle_tpu_flight_incidents_total" in self.EXPOSE_FAMILIES


def test_no_warning_at_import_or_off():
    """A server at off creates no trace and warns nothing."""
    _set_level("off")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        srv = _fc_server("obsw")
        try:
            _submit_n(srv, 2, "obsw")
        finally:
            srv.close()
    assert len(obs.TRACER.completed) == 0
