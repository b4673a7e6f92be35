"""The port's chunked prefill on the CPU, against the JAX package
(tests/test_chunked_prefill.py's shapes: V 16, D 32, 2 heads, 2 layers,
prompts of S 10 in chunks of C 4, so the last chunk is ragged):

* ``CacheConfig.n_chunks`` and ``suggest_chunk_tokens`` equal the JAX
  package's; the chunked bundle's serve keys, feeds and state equal the
  JAX chunked bundle's;
* walking a prompt through the ``("chunked", p)`` phase programs writes
  cross-KV rows bit-identical to the port's monolithic miss admission,
  and within 1e-5 of the JAX package's;
* the chunked server's tokens equal the JAX package's monolithic paged
  server's, with ``jobs x n_chunks x phases`` chunk dispatches on the
  host and on the device counter; requests behind a long cold prompt
  finish while it prefills; a second wave prepares nothing new; a
  cancelled or failed job releases and invalidates its entry;
* a ``DisaggregatedPrefillWorker`` on a second scope feeds the server
  token for token, and the constructor contracts of the JAX package's
  ``TestDisaggUnsharded`` hold.

Weights and prompts come from seeded numpy. Both packages' servers are
driven on the calling thread (tests/torch_radix_setup.py ``drive``), so
they take the same decisions; the worker runs its own thread.
"""
import types

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.models import transformer as PT

from torch_paged_setup import jax_scope, weights
from torch_radix_setup import drive

V, D, H, L, S, MAXT = 16, 32, 2, 2, 10, 32
BS, NB, E, C = 8, 24, 3, 4
N_SLOTS = 4
NC = (S + C - 1) // C      # chunk cursors a phase (the last is ragged)
NPH = 2 * L + 2            # embed, (K/V + attention) a layer, cross K/V
PREFIX = "@cp/"
MODEL = dict(seq_len=S, max_out_len=MAXT, d_model=D, n_heads=H,
             n_layers=L, d_inner=64, vocab=V, start_id=2, end_id=1)
ORDER = [0, 1, 0, 2, 1, 3, 2, 0]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cache(chunk=C):
    return PD.CacheConfig(layout="paged", block_size=BS, n_blocks=NB,
                          n_prompt_entries=E, chunk_tokens=chunk)


def _port_bundle(chunk=C):
    with unique_name.guard():
        return PD.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[1, 4], state_prefix=PREFIX,
            cache=_cache(chunk), **MODEL)


@pytest.fixture(scope="module")
def jax_chunked():
    """The JAX package's chunked bundle of the same geometry."""
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        return JT.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[1, 4], state_prefix=PREFIX,
            cache=JD.CacheConfig(layout="paged", block_size=BS,
                                 n_blocks=NB, n_prompt_entries=E,
                                 chunk_tokens=C), **MODEL)


@pytest.fixture(scope="module")
def world():
    with unique_name.guard():
        _, startup, _ = PT.build_program(
            seq_len=S, d_model=D, n_heads=H, n_layers=L, d_inner=64,
            vocab=V, with_optimizer=False, dropout_rate=0.0)
    params = weights(startup, seed=5)
    scope = pf.Scope()
    pf.load_numpy_params(scope, params, pf.CPUPlace())
    rng = np.random.RandomState(7)
    srcs = [rng.randint(3, V, (1, S)).astype(np.int64) for _ in range(4)]
    return dict(params=params, scope=scope, exe=pf.Executor(pf.CPUPlace()),
                bundle=_port_bundle(), srcs=srcs)


def _port_server(world, **kw):
    kw.setdefault("steps_per_tick", 4)
    return PS.PagedContinuousGenerationServer(
        world["bundle"], executor=world["exe"], scope=world["scope"],
        start=False, **kw)


def _wave(srv, srcs, order=ORDER):
    replies = [srv.submit(srcs[i]) for i in order]
    drive(srv)
    return np.stack([np.asarray(r.result(timeout=0)) for r in replies])


def _device_chunks(srv):
    return int(srv.scope._get(f"{PREFIX}tel_chunks@TEL").reshape(-1)[0])


@pytest.fixture(scope="module")
def jax_mono(world):
    """The JAX package's monolithic paged server on the same weights
    (an unchunked bundle of the same geometry): the wave's tokens."""
    from paddle_tpu.inference import serving as JS
    from paddle_tpu.models import decode_engine as JD

    import paddle_tpu as jf
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        jb = JT.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[1, 4], state_prefix=PREFIX,
            cache=JD.CacheConfig(layout="paged", block_size=BS,
                                 n_blocks=NB, n_prompt_entries=E),
            **MODEL)
    srv = JS.PagedContinuousGenerationServer(
        jb, executor=jf.Executor(jf.CPUPlace()),
        scope=jax_scope(world["params"]), start=False, steps_per_tick=4)
    try:
        return _wave(srv, world["srcs"])
    finally:
        srv.close()


def test_n_chunks_and_suggest_chunk_tokens_match_jax():
    from paddle_tpu.models import decode_engine as JD

    for chunk in (0, 2, 3, 4, 7, 64):
        for seq in (1, 10, 63, 64, 2048):
            pc = PD.CacheConfig("paged", 8, 8, 2, chunk)
            jc = JD.CacheConfig("paged", 8, 8, 2, chunk)
            assert pc.n_chunks(seq) == jc.n_chunks(seq), (chunk, seq)
    for seq, layers_, budget, pre in ((2048, 1, 5.0, 150.0),
                                      (2048, 6, 5.0, 150.0),
                                      (256, 6, 0.5, 40.0),
                                      (10, 2, 100.0, 150.0),
                                      (4096, 2, 1e-3, 150.0)):
        b = types.SimpleNamespace(
            seq_len=seq, _state_specs={f"@x/cross_k{i}@POOL": None
                                       for i in range(layers_)})
        assert PD.CacheConfig.suggest_chunk_tokens(b, budget, pre) \
            == JD.CacheConfig.suggest_chunk_tokens(b, budget, pre)
    b = types.SimpleNamespace(seq_len=2048,
                              _state_specs={"@x/cross_k0@POOL": None})
    assert PD.CacheConfig.suggest_chunk_tokens(b, 5.0) == 256
    with pytest.raises(ValueError, match="tick_budget_ms"):
        PD.CacheConfig.suggest_chunk_tokens(b, 0.0)


def test_chunked_bundle_matches_jax_bundle(world, jax_chunked):
    pb, jb = world["bundle"], jax_chunked
    assert pb.chunk_phase_keys == jb.chunk_phase_keys \
        == [("chunked", p) for p in range(NPH)]
    assert set(map(str, pb.serves)) == set(map(str, jb.serves))
    for key in jb.serves:
        assert pb.serve_feed_spec(key) == jb.serve_feed_spec(key), key
    assert pb.state == jb.state
    assert {n: (tuple(s), d) for n, (s, d) in pb._state_specs.items()} \
        == {n: (tuple(s), d) for n, (s, d) in jb._state_specs.items()}
    assert pb.cache_token() == jb.cache_token()
    assert pb.cache.n_chunks(S) == NC


def _walk_rows(bundle, exe, scope, src, entry):
    """Stream `src` through every phase at every chunk cursor into
    `entry`."""
    for key in bundle.chunk_phase_keys:
        for ci in range(NC):
            feed = {"chunk_entry": np.array([entry], np.int64),
                    "chunk_pos": np.array([ci * C], np.int64),
                    "n_steps": np.array([0], np.int64),
                    "min_active": np.array([0], np.int64)}
            if key[1] == 0:
                pad = np.zeros((1, C), np.int64)
                seg = src[0, ci * C: ci * C + C]
                pad[0, :len(seg)] = seg
                feed["chunk_toks"] = pad
            exe.run(bundle.serves[key], feed=feed,
                    fetch_list=[bundle.state["active"]], scope=scope)


def _miss_feed(src, entry):
    return {"src_ids": src, "slots": np.array([0], np.int64),
            "prompt_slots": np.array([entry], np.int64),
            "n_steps": np.array([0], np.int64),
            "min_active": np.array([0], np.int64)}


def test_phase_walk_writes_the_monolithic_rows(world, jax_chunked):
    """Entry 0 by the monolithic miss admission, entry 1 by the phase
    walk (ragged last chunk zero-padded): the cross-KV rows are
    bit-identical, and within 1e-5 of the JAX package's admission."""
    import paddle_tpu as jf

    b, exe = world["bundle"], world["exe"]
    scope = pf.Scope()
    pf.load_numpy_params(scope, world["params"], pf.CPUPlace())
    b.init_slot_state(scope, "cpu")
    src = np.random.RandomState(3).randint(3, V, (1, S)).astype(np.int64)
    exe.run(b.serves[("miss", 1)], feed=_miss_feed(src, 0),
            fetch_list=[b.state["active"]], scope=scope)
    _walk_rows(b, exe, scope, src, 1)
    names = [f"{PREFIX}cross_{kind}{li}{PD.POOL_MARK}"
             for kind in ("k", "v") for li in range(L)]
    jb = jax_chunked
    jscope = jax_scope(world["params"])
    jb.init_slot_state(jscope)
    jexe = jf.Executor(jf.CPUPlace())
    jexe.run(jb.serves[("miss", 1)], feed=_miss_feed(src, 0),
             fetch_list=[jb.state["active"]], scope=jscope)
    for n in names:
        mono = scope._get(n)[0].numpy()
        walked = scope._get(n)[1].numpy()
        assert np.abs(mono).max() > 0.1, n
        np.testing.assert_array_equal(walked, mono, err_msg=n)
        np.testing.assert_allclose(walked, np.asarray(jscope._get(n))[0],
                                   rtol=0, atol=1e-5, err_msg=n)


def test_chunked_wave_matches_jax_monolithic(world, jax_mono):
    srv = _port_server(world)
    try:
        got = _wave(srv, world["srcs"])
        ps = srv.pool_stats()
        dev = _device_chunks(srv)
    finally:
        srv.close()
    np.testing.assert_array_equal(got, jax_mono)
    assert ps["chunked_prefill"] is True and not ps["disaggregated"]
    # 4 distinct prompts, 3 entries: at least 4 jobs, each every phase
    # at every cursor once
    assert ps["chunk_jobs"] >= 4
    assert ps["chunk_ticks"] == ps["chunk_jobs"] * NC * NPH
    assert dev == ps["chunk_ticks"]
    mono = _port_server(world, chunked_prefill=False)
    try:
        np.testing.assert_array_equal(_wave(mono, world["srcs"]), jax_mono)
        ms = mono.pool_stats()
    finally:
        mono.close()
    assert ms["chunk_jobs"] == ms["chunk_ticks"] == 0
    assert not ms["chunked_prefill"]


def test_shorts_complete_while_a_long_prompt_chunks_in(world, jax_mono):
    done = []
    srv = _port_server(world)
    try:
        warm = world["srcs"][0]
        srv.submit(warm)
        drive(srv)                       # warm's entry is now cached
        f_cold = srv.submit(world["srcs"][3])
        f_hits = [srv.submit(warm) for _ in range(2)]
        f_cold.add_done_callback(lambda f: done.append("cold"))
        for i, f in enumerate(f_hits):
            f.add_done_callback(lambda f, i=i: done.append(i))
        drive(srv)
        ps = srv.pool_stats()
        rows = [np.asarray(f.result(timeout=0)) for f in [f_cold] + f_hits]
    finally:
        srv.close()
    assert ps["chunk_jobs"] == 2         # warm once, cold once
    assert done[-1] == "cold" and sorted(done[:2]) == [0, 1]
    np.testing.assert_array_equal(rows[0], jax_mono[ORDER.index(3)])
    for r in rows[1:]:
        np.testing.assert_array_equal(r, jax_mono[0])


def test_second_wave_prepares_nothing(world):
    exe = world["exe"]
    srv = _port_server(world)
    try:
        first = _wave(srv, world["srcs"])
        prepared = len(exe._cache)
        captured = exe.compile_count
        second = _wave(srv, world["srcs"])
        assert len(exe._cache) == prepared
        assert exe.compile_count == captured
    finally:
        srv.close()
    np.testing.assert_array_equal(second, first)


def _start_job(srv, src):
    """Queue `src` and run cycles until its chunk job is mid-walk."""
    reply = srv.submit(src)
    for _ in range(3):
        with srv._cv:
            failures = []
            admits = srv._plan_admissions_locked(failures)
            n, m, run = srv._plan_burst_locked(admits, True, failures)
        assert run and not admits and not failures
        srv._cycle(admits, n, m)
    job = srv._prefill_job
    assert job is not None and (job["phase"], job["ci"]) == (1, 0)
    return reply, job["entry"]


def test_abort_invalidates_a_part_written_entry(world):
    src = np.random.RandomState(19).randint(3, V, (1, S)).astype(np.int64)
    prompt = tuple(int(x) for x in src.reshape(-1))
    srv = _port_server(world)
    try:
        # a cancel lands between two chunk dispatches
        reply, entry = _start_job(srv, src)
        assert srv._prefix.lookup(prompt)[0] == "hit"
        assert reply.cancel()
        drive(srv)
        with pytest.raises(PS.RequestCancelled):
            reply.result(timeout=0)
        assert srv._prefill_job is None
        assert srv._prefix.lookup(prompt) == ("miss", None)
        assert srv._prefix.refcount(entry) == 0
        assert srv.pool_stats()["prompt_entries_in_use"] == 0
        # a dispatch fails mid-walk: the request fails with the error
        reply, entry = _start_job(srv, src)
        key = srv._chunk_keys[1]
        real = srv._serves[key]

        class Boom:
            def run(self, *a, **k):
                raise RuntimeError("chunk dispatch failed")

        srv._serves[key] = Boom()
        drive(srv)
        srv._serves[key] = real
        with pytest.raises(RuntimeError, match="chunk dispatch failed"):
            reply.result(timeout=0)
        assert srv._prefix.lookup(prompt) == ("miss", None)
        assert srv._prefix.refcount(entry) == 0
        # the prompt prefills afresh afterwards
        reply = srv.submit(src)
        drive(srv)
        assert np.asarray(reply.result(timeout=0)).shape == (MAXT,)
    finally:
        srv.close()


def test_worker_fed_server_matches(world, jax_mono):
    worker = PS.DisaggregatedPrefillWorker(
        world["bundle"], executor=pf.Executor(pf.CPUPlace()),
        scope=pf.Scope(), params_from=world["scope"])
    srv = _port_server(world, prefill_worker=worker)
    try:
        got = _wave(srv, world["srcs"])
        ps = srv.pool_stats()
    finally:
        srv.close()
        worker.close()
    np.testing.assert_array_equal(got, jax_mono)
    assert ps["disaggregated"] is True and ps["chunked_prefill"] is True
    assert ps["chunk_jobs"] >= 4
    assert ps["disagg_handoffs"] == ps["chunk_jobs"]
    assert ps["disagg_outstanding"] == 0 and ps["chunk_ticks"] == 0
    ws = worker.stats()
    assert ws["jobs_done"] == ps["chunk_jobs"] and ws["jobs_failed"] == 0
    assert ws["chunk_ticks"] == ws["jobs_done"] * NC * NPH
    # the server prepared no chunk program: the worker runs them
    assert not any(isinstance(k, tuple) and k[0] == "chunked"
                   for k in srv._serves)


def test_worker_fed_threaded_server_matches(world, jax_mono):
    """The server's own scheduler thread with the worker's: queued
    requests whose prompt is out at the worker wait for its handoff."""
    worker = PS.DisaggregatedPrefillWorker(
        world["bundle"], executor=pf.Executor(pf.CPUPlace()),
        scope=pf.Scope(), params_from=world["scope"])
    srv = PS.PagedContinuousGenerationServer(
        world["bundle"], executor=world["exe"], scope=world["scope"],
        steps_per_tick=4, prefill_worker=worker)
    try:
        replies = [srv.submit(world["srcs"][i]) for i in ORDER]
        got = np.stack([np.asarray(r.result(timeout=120))
                        for r in replies])
        assert srv.drain(timeout=60)
        ps = srv.pool_stats()
    finally:
        srv.close()
        worker.close()
    np.testing.assert_array_equal(got, jax_mono)
    assert ps["disagg_handoffs"] == ps["chunk_jobs"] >= 4
    assert ps["disagg_outstanding"] == 0


@pytest.mark.parametrize("case", ["unchunked_scheduling", "same_bundle",
                                  "chunked_bundle"])
def test_disagg_constructor_contracts(world, case):
    """The three contracts of the JAX package's TestDisaggUnsharded."""
    if case == "unchunked_scheduling":
        fake = types.SimpleNamespace(bundle=world["bundle"])
        with pytest.raises(ValueError, match="implies chunked"):
            _port_server(world, prefill_worker=fake,
                         chunked_prefill=False)
    elif case == "same_bundle":
        fake = types.SimpleNamespace(bundle=object())
        with pytest.raises(ValueError, match="SAME bundle"):
            _port_server(world, prefill_worker=fake)
    else:
        with unique_name.guard():
            plain = PD.build_decode_step_program(
                n_slots=2, admit_buckets=[1], state_prefix="@cpu/",
                cache=PD.CacheConfig(layout="paged", block_size=BS,
                                     n_blocks=8, n_prompt_entries=2),
                **dict(MODEL, n_layers=1))
        with pytest.raises(ValueError, match="chunk"):
            PS.DisaggregatedPrefillWorker(plain, executor=world["exe"],
                                          scope=pf.Scope(), start=False)


def test_worker_refuses_phase_plans_and_needs_chunk_programs(world):
    b = world["bundle"]
    b.prefill_plan = object()
    try:
        with pytest.raises(NotImplementedError, match="step 10"):
            PS.DisaggregatedPrefillWorker(b, executor=world["exe"],
                                          scope=pf.Scope(), start=False)
    finally:
        del b.prefill_plan
    with unique_name.guard():
        plain = PD.build_decode_step_program(
            n_slots=2, admit_buckets=[1], state_prefix="@cpv/",
            cache=PD.CacheConfig(layout="paged", block_size=BS,
                                 n_blocks=8, n_prompt_entries=2),
            **dict(MODEL, n_layers=1))
    with pytest.raises(ValueError, match="chunk_tokens"):
        PS.PagedContinuousGenerationServer(
            plain, executor=world["exe"], scope=pf.Scope(), start=False,
            chunked_prefill=True)
