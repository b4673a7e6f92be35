"""The port's front door on the CPU (the counterpart of the JAX package's
tests/test_frontdoor.py): streamed replies, their teardown, the
admit_select hook and expected_service_ms, each held against the JAX
package's servers on the same seeded weights (tests/torch_paged_setup.py
and the chat sessions of tests/torch_radix_setup.py), both packages'
servers driven on the calling thread so that they admit alike:

* streamed tokens equal the JAX server's token for token, in four forms:
  dense ``stream=True``, ``stream_cb``, paged with a radix chat session,
  and the n-gram speculative bundle; each stream is also the generated
  region of its own whole-response row (the byte-parity contract);
* a cancel after the first burst and an expired deadline end with the
  JAX server's typed errors and finish reasons, release every block, and
  appear in ``incident_report()``;
* ``admit_select`` gives the JAX server's admission order and replies; a
  raising hook warns once and falls back to FIFO;
* ``expected_service_ms`` and ``expected_ms`` equal the JAX package's
  when both cost models get the same samples and snapshot flops.
"""
import time
import warnings

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.inference import serving as JS
from paddle_tpu.observability import costmodel as jcm
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.observability import costmodel as pcm

import torch_radix_setup as R
from torch_paged_setup import LONG_ROWS, MODEL, PortModel, prompts

N_SLOTS = 4      # the dense servers'
SMALL_SLOTS = 2  # the paged and n-gram servers' (fewer serve programs)
END = MODEL["end_id"]
NGRAM = dict(kind="ngram", k=2, ngram=2)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_hermetic():
    """Both packages' FLAGS_observability restored, and their trace and
    flight sinks and cost models cleared, around every test."""
    saved = (FLAGS._values["observability"],
             JFLAGS._values["observability"])
    for o in (obs, jobs):
        o.reset()
    yield
    FLAGS._values["observability"], JFLAGS._values["observability"] = saved
    for o in (obs, jobs):
        o.reset()
    pcm.MODEL.reset()
    jcm.MODEL.reset()


def _set_level(level):
    FLAGS._values["observability"] = level
    JFLAGS._values["observability"] = level


def _jax_dense(prefix, n_slots=N_SLOTS, **kw):
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    if "draft" in kw:
        kw["draft"] = JD.DraftConfig(**kw["draft"])
    with j_unique_name.guard():
        return JT.build_decode_step_program(
            n_slots=n_slots, state_prefix=prefix, **kw, **MODEL)


@pytest.fixture(scope="module")
def world():
    m = PortModel()
    srcs = prompts(5, 12)
    return dict(
        m=m, srcs=srcs, want=m.decode(srcs), jexe=R.jax_executor(),
        dense=(m.bundle(N_SLOTS, state_prefix="@fd/"),
               _jax_dense("@fd/")),
        paged=(R.port_bundle(m, n_slots=SMALL_SLOTS, n_blocks=8),
               R.jax_bundle(n_slots=SMALL_SLOTS, n_blocks=8)),
        ngram=(m.bundle(SMALL_SLOTS, state_prefix="@fn/",
                        draft=PD.DraftConfig(**NGRAM)),
               _jax_dense("@fn/", SMALL_SLOTS, draft=NGRAM)))


def _servers(world, kind, **kw):
    """(port server, JAX server) over the kind's bundles, start=False."""
    pb, jb = world[kind]
    m = world["m"]
    pcls, jcls = (PS.PagedContinuousGenerationServer,
                  JS.PagedContinuousGenerationServer) if kind == "paged" \
        else (PS.ContinuousGenerationServer, JS.ContinuousGenerationServer)
    kw.setdefault("steps_per_tick", 3)
    kw.setdefault("drain_steps", 3)
    return (pcls(pb, executor=m.exe, scope=m.scope, start=False, **kw),
            jcls(jb, executor=world["jexe"], scope=R.jax_scope(m.params),
                 start=False, **kw))


def _drain(reply):
    """A StreamingReply iterated to its end: (seqs, tokens)."""
    seqs, toks = [], []
    for seq, tok in reply:
        seqs.append(seq)
        toks.append(tok)
    return seqs, toks


def _parity(reply, seqs, toks, row):
    """The byte-parity contract: the streamed tokens are the generated
    region row[1:1+n] of the sentinel-normalized whole-response row, the
    sequence numbers run from 0, the finish reason agrees with the row."""
    row = np.asarray(row)
    n = int(PS.count_generated_tokens(row[None], END)[0])
    assert seqs == list(range(len(seqs)))
    assert toks == [int(t) for t in row[1:1 + n]], (toks, row)
    assert reply.finish_reason == ("eos" if n < row.shape[0]
                                   and row[n] == END else "length")


def _step(srv):
    """One scheduler pass on the calling thread (shed, plan, fail,
    cycle), expiring deadlines against the clock."""
    with srv._cv:
        failures = []
        cancels = srv._shed_cancelled_locked(time.monotonic())
        admits = srv._plan_admissions_locked(failures)
        n, m, run = srv._plan_burst_locked(admits, not srv._queue,
                                           failures)
    srv._finalize_cancelled(cancels)
    srv._fail_requests(failures)
    if run:
        srv._cycle(admits, n, m)


def _streamed(srv, srcs, **kw):
    """Every prompt streamed, the server driven to its end; returns
    [(reply, seqs, tokens, row)]."""
    reps = [srv.submit(s, stream=True, **kw) for s in srcs]
    R.drive(srv)
    return [(r, *_drain(r), np.asarray(r.result(timeout=0))) for r in reps]


# --------------------------------------------------------------------
# streamed tokens, against the JAX servers'
# --------------------------------------------------------------------
def test_dense_streams_equal_the_jax_servers(world):
    srcs = world["srcs"][:8]
    ps, js = _servers(world, "dense")
    try:
        got = _streamed(ps, srcs)
        want = _streamed(js, srcs)
    finally:
        ps.close()
        js.close()
    for i, ((pr, ps_, pt, prow), (jr, js_, jt, jrow)) in enumerate(
            zip(got, want)):
        assert (ps_, pt) == (js_, jt), i
        np.testing.assert_array_equal(prow, world["want"][i])
        np.testing.assert_array_equal(prow, jrow)
        _parity(pr, ps_, pt, prow)
        assert pr.finish_reason == jr.finish_reason
        assert pr.ttft_s is not None and pr.ttft_s >= 0 and pr.done()
    # the rows' mixed lengths: some end on end_id, some fill the buffer
    assert {r.finish_reason for r, *_ in got} == {"eos", "length"}


def test_stream_cb_calls_equal_the_jax_servers(world):
    """The callback form: chunks a burst (the same bursts as the JAX
    server's), sequence numbers tiling from 0, a last empty call with the
    finish reason; the whole-response reply is returned as without it."""
    srcs = world["srcs"][:4]
    calls = {}
    for tag, srv in zip(("port", "jax"), _servers(world, "dense")):
        got = [[] for _ in srcs]
        futs = []
        for i, s in enumerate(srcs):
            futs.append(srv.submit(s, stream_cb=lambda c, q, f, g=got[i]:
                                   g.append(([int(t) for t in c], q, f))))
        R.drive(srv)
        rows = [np.asarray(f.result(timeout=0)) for f in futs]
        srv.close()
        calls[tag] = got
        for i, (g, row) in enumerate(zip(got, rows)):
            *chunks, (tail, tail_seq, fin) = g
            n = int(PS.count_generated_tokens(row[None], END)[0])
            assert tail == [] and tail_seq == n
            assert fin == ("eos" if row[n] == END else "length")
            seq, toks = 0, []
            for chunk, first_seq, cfin in chunks:
                assert cfin is None and first_seq == seq and chunk
                seq += len(chunk)
                toks += chunk
            assert toks == [int(t) for t in row[1:1 + n]]
        assert isinstance(futs[0], (PS.GenerationReply, JS.GenerationReply))
    assert calls["port"] == calls["jax"]
    # more than one chunk a request: delivery is a burst at a time
    assert max(len(g) for g in calls["port"]) > 2


def test_paged_radix_session_streams_equal_the_jax_servers(world):
    """Plain paged prompts, then every chat session's three turns, all
    streamed: each turn's stream is its own row's generated region (the
    radix turn's row holds its history) and equals the JAX server's."""
    srcs = world["srcs"]
    out = {}
    for tag, srv in zip(("port", "jax"), _servers(world, "paged")):
        res = _streamed(srv, srcs[:4])
        for t in range(3):
            for sid, (row, exts) in R.SESSIONS.items():
                res += _streamed(srv, [srcs[row]], session_id=sid,
                                 extend_tokens=None if t == 0
                                 else exts[t - 1])
        out[tag] = (res, srv._radix.hit_blocks, srv.pool_stats())
        srv.close()
    (pres, phits, ppool), (jres, jhits, jpool) = out["port"], out["jax"]
    assert len(pres) == 4 + 3 * len(R.SESSIONS)
    for (pr, ps_, pt, prow), (jr, js_, jt, jrow) in zip(pres, jres):
        assert (ps_, pt) == (js_, jt)
        np.testing.assert_array_equal(prow, jrow)
        _parity(pr, ps_, pt, prow)
    assert phits == jhits > 0   # later turns reused the sessions' chains
    assert ppool["radix_admissions"] == jpool["radix_admissions"] > 0


def test_ngram_streams_equal_the_jax_servers(world):
    """Speculative streaming: a verify emits 1..k+1 tokens a tick and
    the burst delivers them all; the stream stays monotone and equals
    the JAX server's and the plain decode's generated region."""
    srcs = world["srcs"][:6]
    ps, js = _servers(world, "ngram", steps_per_tick=2, drain_steps=2)
    try:
        got = _streamed(ps, srcs)
        want = _streamed(js, srcs)
        assert ps.stats()["speculative"]["proposed"] > 0
    finally:
        ps.close()
        js.close()
    for i, ((pr, ps_, pt, prow), (_, js_, jt, jrow)) in enumerate(
            zip(got, want)):
        assert (ps_, pt) == (js_, jt), i
        np.testing.assert_array_equal(prow, world["want"][i])
        np.testing.assert_array_equal(prow, jrow)
        _parity(pr, ps_, pt, prow)


def test_streaming_builds_no_program(world):
    ps, _ = _servers(world, "dense")
    try:
        built = ps.executor.prepare_count
        ps.submit(world["srcs"][0])
        R.drive(ps)
        _streamed(ps, world["srcs"][1:6])
        assert ps.executor.prepare_count == built
    finally:
        ps.close()


def test_stream_refusals_and_close(world):
    ps, js = _servers(world, "paged")
    try:
        for srv in (ps, js):
            with pytest.raises(ValueError, match="n_best"):
                srv.submit(world["srcs"][0], n_best=2, stream=True)
        reps = [srv.submit(world["srcs"][0], stream=True)
                for srv in (ps, js)]
    finally:
        ps.close()
        js.close()
    for rep, closed in zip(reps, (PS.ServerClosed, JS.ServerClosed)):
        assert _drain(rep) == ([], [])
        assert rep.finish_reason == "error"
        with pytest.raises(closed):
            rep.result(timeout=0)


# --------------------------------------------------------------------
# teardown: cancel and deadline
# --------------------------------------------------------------------
def _teardown(srv, prompt, how):
    """One streamed request torn down: "cancel" after its first burst, or
    "deadline" of a microsecond (expired at its first burst boundary).
    Returns (reply, seqs, tokens, the error's type name)."""
    if how == "cancel":
        rep = srv.submit(prompt, stream=True)
        _step(srv)          # admitted, one burst streamed: the lane is live
        assert rep.cancel()
    else:
        rep = srv.submit(prompt, stream=True, deadline_ms=1e-3)
    R.drive(srv)
    assert not rep.cancel()  # decided
    seqs, toks = _drain(rep)
    with pytest.raises(Exception) as err:
        rep.result(timeout=0)
    return rep, seqs, toks, type(err.value).__name__


@pytest.mark.parametrize("level", ["metrics", "trace"])
@pytest.mark.parametrize("how", ["cancel", "deadline"])
def test_teardown_matches_the_jax_server(world, how, level):
    _set_level(level)
    prompt = world["srcs"][LONG_ROWS[0]]
    out = {}
    for tag, srv in zip(("port", "jax"),
                        _servers(world, "paged", radix_reuse=False)):
        rep, seqs, toks, err = _teardown(srv, prompt, how)
        pool = srv.pool_stats()
        st = srv.stats()
        srv.close()
        out[tag] = (rep.finish_reason, seqs, toks, err,
                    pool["blocks_in_use"], pool["prompt_entries_in_use"],
                    st["cancelled"], st["deadline_expired"])
    assert out["port"] == out["jax"]
    fin, seqs, toks, err, blocks, entries, n_c, n_d = out["port"]
    reason = "cancelled" if how == "cancel" else "deadline"
    assert fin == reason and blocks == entries == 0
    assert err == ("RequestCancelled" if how == "cancel"
                   else "DeadlineExceeded")
    assert (n_c, n_d) == ((1, 0) if how == "cancel" else (0, 1))
    if how == "cancel":
        assert 0 < len(toks) < MODEL["max_out_len"] - 1
    for o in (obs, jobs):
        inc = o.incident_report()["incidents"]
        assert [e["reason"] for e in inc] == [reason]
        assert inc[0]["status"] == "cancelled"
        assert ("spans" in inc[0]) == (level == "trace")


def test_queued_deadline_is_shed_before_a_slot(world):
    """A request whose deadline passes while it waits is shed at the
    next planning pass: it never takes a lane."""
    out = {}
    for tag, srv in zip(("port", "jax"), _servers(world, "dense")):
        rep = srv.submit(world["srcs"][0], stream=True, deadline_ms=1e-3)
        time.sleep(0.002)
        _step(srv)
        assert all(lane is None for lane in srv._lanes)
        out[tag] = (_drain(rep), rep.finish_reason,
                    srv.stats()["deadline_expired"])
        with pytest.raises(Exception, match="deadline"):
            rep.result(timeout=0)
        srv.close()
    assert out["port"] == out["jax"] == (([], []), "deadline", 1)


def test_off_keeps_no_incident(world):
    _set_level("off")
    ps, _ = _servers(world, "dense")
    try:
        rep = ps.submit(world["srcs"][0], deadline_ms=1e-3)
        R.drive(ps)
        with pytest.raises(PS.DeadlineExceeded):
            rep.result(timeout=0)
    finally:
        ps.close()
    assert obs.incident_report()["incidents_total"] == 0


# --------------------------------------------------------------------
# admit_select
# --------------------------------------------------------------------
def _by_length():
    """8 prompts of prompts(5, 12) with end_id past their lengths."""
    srcs = prompts(5, 12)[:8].copy()
    lengths = [5, 12, 3, 9, 7, 11, 4, 8]
    for s, n in zip(srcs, lengths):
        s[n:] = END
    return srcs, lengths


def _longest_first(queue):
    return max(range(len(queue)),
               key=lambda i: int((np.asarray(queue[i].src) != END).sum()))


def _admission_order(srv, srcs, lengths):
    """Queue every prompt, drive the server at trace: (the lengths in the
    order the requests took their admissions, the rows)."""
    reps = [srv.submit(s) for s in srcs]
    R.drive(srv)
    rows = [np.asarray(r.result(timeout=0)) for r in reps]
    admitted = []
    for n, r in zip(lengths, reps):
        span = next(s for s in r._gen_req.trace.spans
                    if s.name == "slotpool.queue")
        admitted.append((span.t1, span.attrs["slot"], n))
    return [n for _, _, n in sorted(admitted)], rows


def test_admit_select_order_and_replies_match_the_jax_server(world):
    _set_level("trace")
    srcs, lengths = _by_length()
    out = {}
    for tag, srv in zip(("port", "jax"), _servers(
            world, "dense", admit_select=_longest_first)):
        out[tag] = _admission_order(srv, srcs, lengths)
        srv.close()
    (porder, prows), (jorder, jrows) = out["port"], out["jax"]
    assert porder == jorder
    # the first cycle's four slots: the four longest, longest first
    assert porder[:N_SLOTS] == sorted(lengths, reverse=True)[:N_SLOTS]
    for p, j in zip(prows, jrows):
        np.testing.assert_array_equal(p, j)
    # and the replies are the FIFO server's
    fifo, _ = _servers(world, "dense")
    try:
        _, frows = _admission_order(fifo, srcs, lengths)
    finally:
        fifo.close()
    for p, f in zip(prows, frows):
        np.testing.assert_array_equal(p, f)


def test_a_failing_hook_warns_once_then_fifo(world):
    _set_level("trace")
    srcs, lengths = _by_length()

    def broken(queue):
        raise RuntimeError("hook bug")

    orders = []
    for srv in _servers(world, "dense", admit_select=broken):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            order, _ = _admission_order(srv, srcs, lengths)
        srv.close()
        msgs = [str(w.message) for w in caught
                if "admit_select hook failed" in str(w.message)]
        assert len(msgs) == 1, msgs
        orders.append(order)
    assert orders[0] == orders[1] == lengths  # FIFO
    # an index out of range declines silently
    ps, _ = _servers(world, "dense", admit_select=lambda q: 99)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        order, _ = _admission_order(ps, srcs, lengths)
    ps.close()
    assert order == lengths


def test_paged_server_refuses_admit_select(world):
    pb, jb = world["paged"]
    for cls, b in ((PS.PagedContinuousGenerationServer, pb),
                   (JS.PagedContinuousGenerationServer, jb)):
        with pytest.raises(ValueError, match="admit_select"):
            cls(b, executor=world["m"].exe if cls is
                PS.PagedContinuousGenerationServer else world["jexe"],
                scope=world["m"].scope if cls is
                PS.PagedContinuousGenerationServer
                else R.jax_scope(world["m"].params),
                admit_select=_longest_first, start=False)


# --------------------------------------------------------------------
# expected_service_ms and the burst annotation
# --------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["dense", "ngram"])
def test_expected_service_ms_equals_the_jax_package(world, kind,
                                                    monkeypatch):
    """Both cost models fed the same snapshot flops and the same
    achieved-rate samples: the same expected_ms and, for every token
    count, the same expected_service_ms (a speculative bundle's ticks
    carry k + 1 tokens)."""
    flops = 123456.0
    for mod in (pcm, jcm):
        monkeypatch.setattr(mod, "lookup",
                            lambda program, feed_arrays=None:
                            {"flops": flops})
    ps, js = _servers(world, kind)
    try:
        assert ps.expected_service_ms() is js.expected_service_ms() is None
        for f, s in ((2e6, 0.5), (7e6, 1.0), (1e6, 2.0), (5e5, 0.1)):
            pcm.observe(f, s)
            jcm.observe(f, s)
        assert pcm.expected_ms(flops) == jcm.expected_ms(flops)
        for n in (None, 1, 2, 3, 7, 31):
            got = ps.expected_service_ms(n)
            assert got is not None and got == js.expected_service_ms(n), n
        assert ps._toks_per_tick == js._toks_per_tick
    finally:
        ps.close()
        js.close()


def test_burst_annotation_matches_the_jax_server(world):
    """At trace each dispatch span carries the burst's ticks, exit
    reason and occupancy integral, the same as the JAX server's; after
    the calibrated bursts the span carries expected and actual tick
    times, and the server can estimate a service time."""
    _set_level("trace")
    spans = {}
    for tag, srv in zip(("port", "jax"), _servers(world, "dense")):
        reps = [srv.submit(s) for s in world["srcs"][:6]]
        R.drive(srv)
        attrs = [[(s.attrs.get("ticks"), s.attrs.get("exit_reason"),
                   s.attrs.get("occupancy_integral"), s.attrs["admits"])
                  for s in r._gen_req.trace.spans
                  if s.name == "slotpool.dispatch"] for r in reps]
        spans[tag] = attrs
        if tag == "port":
            dispatches = [s for r in reps for s in r._gen_req.trace.spans
                          if s.name == "slotpool.dispatch"]
            assert all(s.attrs["cache"] == "memory" for s in dispatches)
            assert any("tick_time_ratio" in s.attrs and
                       s.attrs["expected_tick_ms"] > 0 and
                       s.attrs["actual_tick_ms"] > 0 for s in dispatches)
            assert srv.expected_service_ms() is not None
            assert pcm.flops_per_s() > 0
        srv.close()
    assert spans["port"] == spans["jax"]
    assert {a[1] for req in spans["port"] for a in req} >= {"n_steps"}


def test_metrics_samples_of_a_speculative_server(world):
    """The speculative families, per rung and all: the JAX server's
    names and labels."""
    _set_level("metrics")
    fams = {}
    for tag, srv in zip(("port", "jax"), _servers(world, "ngram")):
        srv.submit(world["srcs"][0])
        R.drive(srv)
        fams[tag] = sorted(
            (n, tuple(sorted(k for k in lab if k != "server")))
            for n, lab, _ in srv._metrics_samples()
            if n.startswith("paddle_tpu_spec_"))
        srv.close()
    assert fams["port"] == fams["jax"]
    assert ("paddle_tpu_spec_proposed_total", ()) in fams["port"]
