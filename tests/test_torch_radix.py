"""The port's radix tier on the CPU: ``RadixBlockTree`` against the JAX
package's on seeded random operation sequences, ``session_feasibility``
against the JAX package's on a grid, the bundle's COW program against
the JAX package's, and the paged server's chat sessions,
``radix_reuse=False``, ``close_session``, plain-prompt reuse and
``n_best`` against the JAX package's PagedContinuousGenerationServer on
the same weights and prompts (tests/torch_radix_setup.py): tokens,
session histories and the radix counters equal.

The JAX package's own radix tests (tests/test_radix_reuse.py) pick their
session prompt by decoding a trained model, and under jax 0.9 that pick
fails; here the prompts and weights are fixed up front and the JAX
server is run on them as the oracle. Both servers are driven on the
calling thread, so they take the same admission decisions.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch.analysis import liveness as PL
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD

from torch_radix_setup import (BS, HIST_LENGTHS, MODEL, N_BLOCKS,
                               N_ENTRIES, PLAIN_ROWS, SESSIONS, PortModel,
                               drive, jax_bundle, jax_executor, jax_scope,
                               port_bundle, prompts, radix_counters,
                               run_sessions)

NBEST_ROW, N_BEST = 9, 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    m = PortModel()
    srcs = prompts(5, 12)
    return dict(m=m, srcs=srcs, bundle=port_bundle(m), want=m.decode(srcs))


def _port(world, **kw):
    return PS.PagedContinuousGenerationServer(
        world["bundle"], executor=world["m"].exe, scope=world["m"].scope,
        start=False, **kw)


def _drain(srv, sessions=SESSIONS):
    """close_session on every session, then evict the whole tree."""
    for sid in sessions:
        srv.close_session(sid)
    with srv._cv:
        srv._radix.evict(N_BLOCKS)
    return radix_counters(srv)


def _plain_twice(srv, srcs):
    rows = []
    for _ in range(2):
        replies = [srv.submit(srcs[r]) for r in PLAIN_ROWS]
        drive(srv)
        rows.append(np.stack([np.asarray(x.result(timeout=0))
                              for x in replies]))
    return rows, radix_counters(srv)


def _n_best(srv, srcs):
    srv.stats(reset=True)
    replies = srv.submit(srcs[NBEST_ROW], n_best=N_BEST)
    drive(srv)
    return [np.asarray(x.result(timeout=0)) for x in replies], \
        srv.stats()["device_telemetry"], radix_counters(srv)


@pytest.fixture(scope="module")
def jax_b():
    return jax_bundle()


@pytest.fixture(scope="module")
def jax_runs(world, jax_b):
    """The JAX package's server on the same weights: the sessions with
    and without reuse, the drain, the plain prompts twice and n_best,
    each with its counters."""
    from paddle_tpu.inference import serving as JS

    exe = jax_executor()
    out = {}
    for reuse in (True, False):
        srv = JS.PagedContinuousGenerationServer(
            jax_b, executor=exe, scope=jax_scope(world["m"].params),
            start=False, radix_reuse=reuse)
        try:
            runs = run_sessions(srv, world["srcs"])
            out[reuse] = dict(sessions=runs, counters=radix_counters(srv),
                              drained=_drain(srv))
            if reuse:
                out["plain"] = _plain_twice(srv, world["srcs"])
                out["n_best"] = _n_best(srv, world["srcs"])
        finally:
            srv.close()
    return out


# ---------------------------------------------------------------------------
# host structures against the JAX package's
# ---------------------------------------------------------------------------
def test_radix_tree_matches_jax():
    """Seeded random sequences of lanes that acquire a shared prefix,
    allocate their tail, insert their chain and release it, with probes
    (match) and evictions between: the same return values, pool
    refcounts, tree blocks and counters."""
    from paddle_tpu.models import decode_engine as JD

    nb, bs = 24, 2
    for seed in range(4):
        rng = np.random.RandomState(seed)
        jp, pp = JD.HostBlockPool(nb), PD.HostBlockPool(nb)
        jt, pt = JD.RadixBlockTree(jp, bs), PD.RadixBlockTree(pp, bs)
        held = []  # (prompt, tokens, shared, own) of live lanes
        for _ in range(120):
            prompt = (int(rng.randint(2)),)
            toks = tuple(int(x) for x in rng.randint(0, 2, rng.randint(
                0, 9)))
            op = rng.choice(["lane", "retire", "match", "evict"],
                            p=[0.35, 0.3, 0.15, 0.2])
            if op == "lane":
                cap = int(rng.randint(0, 4))
                shared = jt.acquire(prompt, toks, max_blocks=cap)
                assert pt.acquire(prompt, toks, max_blocks=cap) == shared
                need = max(0, len(toks) // bs - len(shared))
                own = []
                for _ in range(need):
                    b = jp.alloc()
                    assert pp.alloc() == b
                    if b is None:
                        break
                    own.append(b)
                held.append((prompt, toks, shared, own))
            elif op == "retire" and held:
                prompt, toks, shared, own = held.pop(
                    rng.randint(len(held)))
                chain = shared + own
                if len(chain) >= len(toks) // bs:
                    assert jt.insert(prompt, toks, chain) == \
                        pt.insert(prompt, toks, chain)
                else:
                    for t in (jt, pt):
                        with pytest.raises(Exception, match="radix insert"):
                            t.insert(prompt, toks, chain)
                jt.release(shared)
                pt.release(shared)
                for p in (jp, pp):
                    for b in reversed(own):
                        p.decref(b)
            elif op == "match":
                assert jt.match(prompt, toks) == pt.match(prompt, toks)
            else:
                need = int(rng.randint(1, 6))
                assert jt.evict(need) == pt.evict(need)
            assert [jp.refcount(b) for b in range(nb)] == \
                [pp.refcount(b) for b in range(nb)]
            assert jt.tree_blocks() == pt.tree_blocks()
            assert jt.n_nodes == pt.n_nodes
            assert (jt.inserts, jt.adoptions, jt.hit_blocks,
                    jt.evicted_blocks) == (pt.inserts, pt.adoptions,
                                           pt.hit_blocks, pt.evicted_blocks)
        assert pt.tree_blocks() or pt.inserts, "the sequence never inserted"


def test_session_feasibility_matches_jax():
    from paddle_tpu.analysis import liveness as JL

    for entries in range(0, 5):
        for distinct in range(0, 7):
            for close in (False, True):
                for cold in (False, True):
                    j = JL.session_feasibility(entries, distinct, close, cold)
                    p = PL.session_feasibility(entries, distinct, close, cold)
                    assert (p.resource, p.demand, p.supply, p.feasible) == \
                        (j.resource, j.demand, j.supply, j.feasible)
                    assert (p.witness is None) == (j.witness is None)
                    assert p.describe() == j.describe()
                    if not p.feasible:
                        assert "session-pinning" in p.witness


def test_cow_program_copies_gated_rows_and_drops_padding(world, jax_b):
    """Gated rows copy their source block into their destination in every
    layer's K and V pool; gate-0 rows aimed at the trash row (-1) write
    nothing; the telemetry counts the copies. The JAX package's COW
    program gives the same pools."""
    import paddle_tpu as jf

    b, jb = world["bundle"], jax_b
    scope = pf.Scope()
    b.init_slot_state(scope, "cpu")
    rng = np.random.RandomState(3)
    pools = [n for n in b._state_specs if n.endswith(PD.POOL_MARK)
             and "/self_" in n]
    vals = {n: rng.randn(*b._state_specs[n][0]).astype("float32")
            for n in pools}
    for n, v in vals.items():
        scope._set(n, torch.from_numpy(v.copy()))
    rows = b.n_slots + 1
    src = np.zeros(rows, np.int64)
    dst = np.full(rows, -1, np.int64)
    gate = np.zeros(rows, np.float32)
    src[:2], dst[:2], gate[:2] = [3, 5], [7, 1], 1.0
    src[2], dst[2] = 4, 9  # gate 0: copies nothing
    feed = {"cow_src": src, "cow_dst": dst, "cow_gate": gate}
    world["m"].exe.run(b.cow, feed=feed, scope=scope)
    jscope = jf.Scope()
    for n, v in vals.items():
        jscope._set(n, v.copy())
    for n, (shape, dt) in jb._state_specs.items():
        if n not in vals:
            jscope._set(n, np.zeros(shape, dt))
    jax_executor().run(jb.cow, feed=feed, scope=jscope)
    for n, v in vals.items():
        want = v.copy()
        want[7], want[1] = v[3], v[5]
        got = scope._get(n).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(jscope._get(n)))
    assert int(scope._get(b.state["tel_cow_blocks"])[0]) == 2


# ---------------------------------------------------------------------------
# the paged server's radix tier against the JAX package's server
# ---------------------------------------------------------------------------
def test_sessions_match_jax_server(world, jax_runs):
    """Three sessions of three turns (two on one prompt): each turn's
    row, history and the radix counters equal the JAX server's; turn 1
    is the whole-loop decode; every later turn admits through the radix
    tier over at least one shared block."""
    srv = _port(world)
    try:
        runs = run_sessions(srv, world["srcs"])
        counters = radix_counters(srv)
        tel = srv.stats()["device_telemetry"]
        depth = srv.pool_stats()["prefix_hit_depth"]
    finally:
        srv.close()
    for sid, (row, _exts) in SESSIONS.items():
        assert [len(h) for _, h in runs[sid]] == HIST_LENGTHS[sid], \
            "the fixed session data moved"
        np.testing.assert_array_equal(runs[sid][0][0], world["want"][row])
        for (got, hist), (want, jhist) in zip(runs[sid],
                                              jax_runs[True]["sessions"][sid]):
            np.testing.assert_array_equal(got, np.asarray(want, np.int64))
            assert hist == jhist
            # the reply row is the history, end_id, then the sentinel
            assert list(got[:len(hist)]) == hist
            assert got[len(hist)] == MODEL["end_id"]
    assert counters == jax_runs[True]["counters"]
    n_radix = 2 * len(SESSIONS)
    assert counters["radix_admissions"] == n_radix
    assert tel["admitted_radix"] == n_radix
    assert depth["0"] == 0 and depth["+Inf"] == n_radix
    assert counters["radix_hit_blocks"] >= n_radix


def test_radix_reuse_false_replays_the_same_tokens(world, jax_runs):
    """radix_reuse=False keeps the session API but replays each turn's
    whole history into fresh blocks: the same tokens as with reuse, no
    shared block, no tree node; the JAX server's counters likewise."""
    srv = _port(world, radix_reuse=False)
    try:
        runs = run_sessions(srv, world["srcs"])
        counters = radix_counters(srv)
        depth = srv.pool_stats()["prefix_hit_depth"]
        drained = _drain(srv)
    finally:
        srv.close()
    for sid in SESSIONS:
        for (got, hist), (want, jhist) in zip(
                runs[sid], jax_runs[True]["sessions"][sid]):
            np.testing.assert_array_equal(got, np.asarray(want, np.int64))
            assert hist == jhist
    assert counters == jax_runs[False]["counters"]
    assert counters["radix_hit_blocks"] == 0 and counters["radix_nodes"] == 0
    assert counters["radix_admissions"] == 2 * len(SESSIONS)
    assert depth["0"] == 2 * len(SESSIONS)
    assert drained == jax_runs[False]["drained"]
    assert drained["blocks_in_use"] == 0


def test_close_session_releases_and_evict_drains_the_pool(world, jax_runs):
    """close_session drops the sessions' entry pins and histories; the
    tree's blocks stay as cache until evicted; evicting the whole tree
    frees every block. Counters equal the JAX server's at each point."""
    srv = _port(world)
    try:
        run_sessions(srv, world["srcs"])
        before = radix_counters(srv)
        assert before["sessions_open"] == len(SESSIONS)
        assert before["blocks_in_use"] == before["radix_nodes"] > 0
        srv.close_session("a")
        srv.close_session("a")  # idempotent
        assert srv.session_history("a") is None
        assert srv.session_history("b") == list(
            srv.session_history("b"))
        drained = _drain(srv)
    finally:
        srv.close()
    assert drained == jax_runs[True]["drained"]
    assert drained["blocks_in_use"] == drained["prompt_entries_in_use"] == 0
    assert drained["radix_nodes"] == 0 and drained["sessions_open"] == 0
    assert drained["radix_evicted_blocks"] == before["radix_nodes"]


def test_plain_prompt_reuse_matches_jax(world, jax_runs):
    """After the sessions drained, plain prompts sent twice: the first
    submit decodes (and its full blocks join the tree), the second
    admits through the radix tier over the harvested chain, replaying
    its own output. Both equal the whole-loop decode; the counters equal
    the JAX server's, tree evictions under pool pressure included."""
    srv = _port(world)
    try:
        run_sessions(srv, world["srcs"])
        _drain(srv)
        rows, counters = _plain_twice(srv, world["srcs"])
    finally:
        srv.close()
    for r in rows:
        np.testing.assert_array_equal(r, world["want"][PLAIN_ROWS])
    assert counters == jax_runs["plain"][1]
    for a, b in zip(rows, jax_runs["plain"][0]):
        np.testing.assert_array_equal(a, np.asarray(b, np.int64))
    assert counters["plain_radix_admissions"] == len(PLAIN_ROWS)
    assert counters["radix_evicted_blocks"] > 0


def test_n_best_shares_one_prompt_entry(world, jax_runs):
    """n_best fans one prompt out to n requests on one prompt entry:
    greedy replies are identical and equal the whole-loop decode; a
    branch never extends anything (harvest off); the counters equal the
    JAX server's."""
    srv = _port(world)
    try:
        run_sessions(srv, world["srcs"])
        _drain(srv)
        _plain_twice(srv, world["srcs"])
        outs, tel, counters = _n_best(srv, world["srcs"])
    finally:
        srv.close()
    assert len(outs) == N_BEST
    for o in outs:
        np.testing.assert_array_equal(o, world["want"][NBEST_ROW])
    assert tel["prompt_entries_hwm"] == 1
    jouts, jtel, jcounters = jax_runs["n_best"]
    assert counters == jcounters
    assert jtel["prompt_entries_hwm"] == 1
    for o, j in zip(outs, jouts):
        np.testing.assert_array_equal(o, np.asarray(j, np.int64))


def test_session_api_checks(world):
    """The named refusals: extend_tokens without a session, before the
    first turn retired, past the buffer; a session reopened with another
    prompt; n_best < 1; a session past the prompt-entry pool
    (AdmissionInfeasible, until close_session frees a pin); a bundle
    whose declared session workload cannot fit."""
    srcs = world["srcs"]
    srv = _port(world)
    try:
        with pytest.raises(ValueError, match="pass session_id"):
            srv.submit(srcs[1], extend_tokens=[5])
        with pytest.raises(ValueError, match="no retired turn"):
            srv.submit(srcs[1], session_id="x", extend_tokens=[5])
        with pytest.raises(ValueError, match="n_best"):
            srv.submit(srcs[1], n_best=0)
        srv.submit(srcs[1], session_id="x")
        with pytest.raises(ValueError, match="has not retired"):
            srv.submit(srcs[1], session_id="x", extend_tokens=[5])
        drive(srv)
        with pytest.raises(ValueError, match="different prompt"):
            srv.submit(srcs[2], session_id="x")
        with pytest.raises(ValueError, match="exceeds the decode buffer"):
            srv.submit(srcs[1], session_id="x",
                       extend_tokens=[5] * MODEL["max_out_len"])
        # one session a distinct prompt: the entry pool holds N_ENTRIES
        for i in range(1, N_ENTRIES):
            srv.submit(srcs[2 + i], session_id=f"y{i}")
        with pytest.raises(PD.AdmissionInfeasible, match="close_session"):
            srv.submit(srcs[9], session_id="z")
        srv.close_session("x")
        srv.submit(srcs[9], session_id="z")
        drive(srv)
    finally:
        srv.close()
    bundle = world["bundle"]
    bundle.workload = {"distinct_session_prompts": N_ENTRIES + 1}
    try:
        with pytest.raises(PD.AdmissionInfeasible, match="session-pinning"):
            _port(world)
        bundle.workload["sessions_close"] = True
        _port(world).close()
    finally:
        del bundle.workload


def test_cancelled_turn_leaves_the_history(world):
    """A session turn torn down mid-flight is not harvested: the history
    stays what the submit made it (the last retired turn and the
    extension), and the next turn resumes from there."""
    srcs = world["srcs"]
    srv = _port(world, steps_per_tick=2, drain_steps=2)
    try:
        srv.submit(srcs[1], session_id="s")
        drive(srv)
        hist = srv.session_history("s")
        ext = SESSIONS["a"][1][0]
        rep = srv.submit(srcs[1], session_id="s", extend_tokens=ext)
        failures = []
        with srv._cv:
            admits = srv._plan_admissions_locked(failures)
            n, m, _ = srv._plan_burst_locked(admits, False, failures)
        srv._cycle(admits, n, m)  # admitted, two ticks run
        assert rep.cancel()
        drive(srv)  # torn down at the next burst boundary
        with pytest.raises(PS.RequestCancelled):
            rep.result(timeout=0)
        assert srv.session_history("s") == hist + ext
        again = srv.submit(srcs[1], session_id="s")
        drive(srv)
        assert len(srv.session_history("s")) == HIST_LENGTHS["a"][1]
        assert list(again.result(timeout=0)[:HIST_LENGTHS["a"][1]]) == \
            srv.session_history("s")
        assert srv.pool_stats()["paused_lanes"] == 0
    finally:
        srv.close()


def test_bundle_builds_the_radix_tier(world):
    """Every admission bucket has a ("radix", A) serve whose feeds are the
    history, the resume steps, the teacher-forcing horizons and the
    slots; the COW and probe programs are built; the dense bundle has
    none of them."""
    b = world["bundle"]
    buckets = sorted(k[1] for k in b.serves
                     if isinstance(k, tuple) and k[0] == "miss")
    assert buckets == sorted(k[1] for k in b.serves
                             if isinstance(k, tuple) and k[0] == "radix")
    A = buckets[-1]
    assert [n for n, _, _ in b.serve_feed_spec(("radix", A))] == [
        "hist_toks", "resume_steps", "prefill_until", "slots", "n_steps",
        "min_active"]
    assert b.serve_feed_spec(("radix", A))[0][1] == (A, MODEL["max_out_len"])
    assert b.cow in b.programs() and b.probe in b.programs()
    ops = [op.type for op in b.probe.global_block.ops]
    assert "softmax" in ops and "paged_decode_attention" in ops
    dense = world["m"].bundle(2)
    assert dense.cow is None and dense.probe is None
    assert not any(isinstance(k, tuple) for k in dense.serves)
    assert BS == world["bundle"].cache.block_size
