"""The port's continuous-batching servers on the CPU, mirroring
tests/test_paged_decode.py: the paged server's tokens against the JAX
package's PagedContinuousGenerationServer on the same weights and
prompts, and every slot-pool run of the port against its own
whole-loop decode (build_incremental_decode_program), through slot
reuse, admission orders, burst lengths and the prefix-cache tiers; the
dense ContinuousGenerationServer likewise; cancellation, deadlines,
device counters and the lifecycle. Greedy decode over the same fp32
math: tokens are held exactly, and every test checks that the pools
drained.
"""
import time

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD

from torch_paged_setup import (BS, LENGTHS, MODEL, PortModel, jax_scope,
                               paged_cache, prompts)

N_SLOTS = 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    m = PortModel()
    # NB = n_slots * pages: no pool pressure in these tests (the
    # pressure tests are in tests/test_torch_paged.py)
    paged = m.bundle(N_SLOTS, paged_cache(N_SLOTS * 4, 3),
                     state_prefix="@pg/")
    dense = m.bundle(N_SLOTS)
    srcs = prompts(5, 12)
    want = m.decode(srcs)
    got_lengths = PS.count_generated_tokens(want, MODEL["end_id"])
    assert list(got_lengths) == LENGTHS, "the seeded workload moved"
    return dict(m=m, paged=paged, dense=dense, srcs=srcs, want=want)


def _paged(world, **kw):
    # radix_reuse=False, as tests/test_paged_decode.py serves: these
    # tests pin the hit/miss tiers and the pool's drain, and a retired
    # plain request's blocks would otherwise stay in the radix tree as
    # cache (tests/test_torch_radix.py holds the radix tier)
    kw.setdefault("radix_reuse", False)
    return PS.PagedContinuousGenerationServer(
        world["paged"], executor=world["m"].exe, scope=world["m"].scope,
        **kw)


def _drained(srv):
    bp = srv.pool_stats()
    assert bp["blocks_in_use"] == 0 and bp["prompt_entries_in_use"] == 0
    assert bp["paused_lanes"] == 0
    return bp


def test_paged_tokens_match_jax_server_and_whole_loop(world):
    """12 mixed-length requests through 4 slots (3x slot reuse) on the
    port's paged server, and through the JAX package's paged server
    (radix_reuse=False) on the same weights: both equal the port's
    whole-loop decode, -1 sentinel tails included."""
    import paddle_tpu as jf
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.inference import \
        PagedContinuousGenerationServer as JPaged
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    srcs, want = world["srcs"], world["want"]
    with _paged(world) as srv:
        got = np.stack([r.result(timeout=120)
                        for r in [srv.submit(s) for s in srcs]])
        st = srv.stats()
        bp = _drained(srv)
    np.testing.assert_array_equal(got, want)
    assert st["completed"] == 12 and bp["prefix_misses"] == 12

    with j_unique_name.guard():
        jb = JT.build_decode_step_program(
            n_slots=2, state_prefix="@jpg/",
            cache=JD.CacheConfig(layout="paged", block_size=BS,
                                 n_blocks=8, n_prompt_entries=3),
            **MODEL)
    jsrv = JPaged(jb, executor=jf.Executor(jf.CPUPlace()),
                  scope=jax_scope(world["m"].params), radix_reuse=False)
    try:
        jgot = np.stack([r.result(timeout=300)
                         for r in [jsrv.submit(s) for s in srcs]])
    finally:
        jsrv.close()
    np.testing.assert_array_equal(jgot.astype(np.int64), want)


def test_dense_server_matches_whole_loop(world):
    srv = PS.ContinuousGenerationServer(
        world["dense"], executor=world["m"].exe, scope=world["m"].scope)
    with srv:
        got = np.stack([r.result(timeout=120)
                        for r in [srv.submit(s) for s in world["srcs"]]])
        st = srv.stats()
    np.testing.assert_array_equal(got, world["want"])
    tel = st["device_telemetry"]
    assert tel["admitted_miss"] == 12 and "admitted_hit" not in tel


def test_independent_of_admission_order(world):
    srcs, want = world["srcs"][:8], world["want"][:8]
    with _paged(world) as srv:
        replies = {i: srv.submit(srcs[i]) for i in reversed(range(8))}
        got = np.stack([replies[i].result(timeout=120) for i in range(8)])
        _drained(srv)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(steps_per_tick=1, drain_steps=1),
                                dict(steps_per_tick=5),
                                dict(exit_on_retire=True)])
def test_burst_length_does_not_move_tokens(world, kw):
    srcs, want = world["srcs"][:6], world["want"][:6]
    with _paged(world, **kw) as srv:
        got = np.stack([r.result(timeout=120)
                        for r in [srv.submit(s) for s in srcs]])
        _drained(srv)
    np.testing.assert_array_equal(got, want)


def test_prefix_hit_byte_identical_to_cold(world):
    """The same prompt served cold (encoder prefill into a pool entry)
    and again as a prefix hit (encoder-free admission reading the cached
    entry): byte-identical rows, and the hit took the hit path."""
    src, want = world["srcs"][1], world["want"][1]
    with _paged(world) as srv:
        cold = srv.submit(src).result(timeout=120)
        h0 = srv.pool_stats()["prefix_hits"]
        hot = srv.submit(src).result(timeout=120)
        tel = srv.stats()["device_telemetry"]
        bp = _drained(srv)
    np.testing.assert_array_equal(cold, want)
    np.testing.assert_array_equal(hot, want)
    assert bp["prefix_hits"] == h0 + 1
    assert tel["admitted_hit"] == 1 and tel["admitted_miss"] == 1


def test_partial_prefix_is_a_copy_not_reuse(world):
    """A prompt sharing only its first block of tokens with a cached one
    is the partial tier: encoded anew (the encoder is bidirectional) and
    counted as a copy; tokens still exact."""
    a = world["srcs"][3]
    b = a.copy()
    b[BS:] = (b[BS:] % (MODEL["vocab"] - 4)) + 3
    want = world["m"].decode(np.stack([a, b]))
    with _paged(world) as srv:
        got = [srv.submit(x).result(timeout=120) for x in (a, b)]
        bp = _drained(srv)
    np.testing.assert_array_equal(np.stack(got), want)
    assert bp["cow_copies"] == 1 and bp["prefix_misses"] == 1


def _one_cycle(srv):
    """One pass of the scheduler loop on the calling thread."""
    failures = []
    with srv._cv:
        cancels = srv._shed_cancelled_locked(time.monotonic())
        admits = srv._plan_admissions_locked(failures)
        n, m, run = srv._plan_burst_locked(admits, not srv._queue,
                                           failures)
    srv._finalize_cancelled(cancels)
    srv._fail_requests(failures)
    if run:
        srv._cycle(admits, n, m)


def test_cancel_and_deadline_release_the_lane(world):
    """A cancelled queued request and one whose deadline passed in the
    queue never take a slot; a live lane cancelled mid-generation is
    torn down at the next burst boundary; every block and entry comes
    back."""
    srcs, want = world["srcs"], world["want"]
    srv = _paged(world, start=False, steps_per_tick=2, drain_steps=2)
    try:
        queued = srv.submit(srcs[0])
        assert queued.cancel()
        late = srv.submit(srcs[2], deadline_ms=1.0)
        live = srv.submit(srcs[5])
        time.sleep(0.01)  # the deadline passes in the queue
        _one_cycle(srv)   # sheds two, admits `live`, runs 2 ticks
        with pytest.raises(PS.RequestCancelled):
            queued.result(timeout=0)
        with pytest.raises(PS.DeadlineExceeded):
            late.result(timeout=0)
        assert not queued.cancel()  # decided already
        assert srv.pool_stats()["blocks_in_use"] == 1
        assert live.cancel()
        _one_cycle(srv)
        with pytest.raises(PS.RequestCancelled):
            live.result(timeout=0)
        st = srv.stats()
        assert st["cancelled"] == 2 and st["deadline_expired"] == 1
        _drained(srv)
        srv.start()  # the pool serves on
        np.testing.assert_array_equal(
            srv.submit(srcs[4]).result(timeout=60), want[4])
    finally:
        srv.close()


def test_device_telemetry_counts_exactly(world):
    """Three requests (one per prompt entry) queued before the scheduler
    starts are admitted in one miss dispatch that drains the pool; the
    device counters then agree with the host."""
    srv = _paged(world, start=False, steps_per_tick=4)
    try:
        replies = [srv.submit(s) for s in world["srcs"][:3]]
        srv.start()
        got = [r.result(timeout=120) for r in replies]
        st = srv.stats()
    finally:
        srv.close()
    np.testing.assert_array_equal(np.stack(got), world["want"][:3])
    tel = st["device_telemetry"]
    assert st["ticks"] == 1  # one dispatch
    assert tel["admitted_miss"] == 3 and tel["admitted_hit"] == 0
    assert (tel["exit_n_steps"], tel["exit_all_idle"],
            tel["exit_min_active"]) == (0, 1, 0)
    # a lane is live from its admission to its last token
    assert tel["ticks"] == max(LENGTHS[:3])
    assert tel["occupancy_integral"] == sum(LENGTHS[:3])
    assert tel["blocks_hwm"] == 3 * 4 and tel["prompt_entries_hwm"] == 3


def test_lifecycle_and_what_is_not_ported(world):
    m = world["m"]
    with pytest.raises(ValueError, match="DENSE"):
        PS.ContinuousGenerationServer(world["paged"], executor=m.exe,
                                      scope=m.scope, start=False)
    with pytest.raises(ValueError, match="paged"):
        PS.PagedContinuousGenerationServer(world["dense"], executor=m.exe,
                                           scope=m.scope, start=False)
    # chunked prefill needs a bundle built with chunk_tokens > 0
    with pytest.raises(ValueError, match="chunk_tokens"):
        _paged(world, chunked_prefill=True, start=False)
    srv = _paged(world)
    try:
        with pytest.raises(ValueError, match="seq_len"):
            srv.submit(world["srcs"][0][:5])
        # a paged server takes a chat session's first turn
        np.testing.assert_array_equal(
            srv.submit(world["srcs"][1], session_id="chat").result(
                timeout=60), world["want"][1])
        # a streamed reply: its tokens are the whole-response row's
        # generated region, and result() is that row
        rep = srv.submit(world["srcs"][0], stream=True)
        toks = [t for _, t in rep]
        row = rep.result(timeout=60)
        n = int(PS.count_generated_tokens(row[None], MODEL["end_id"])[0])
        np.testing.assert_array_equal(row, world["want"][0])
        assert toks == [int(t) for t in row[1:1 + n]]
        assert rep.finish_reason in ("eos", "length")
        srv.quiesce()
        with pytest.raises(PS.ServerQuiesced):
            srv.submit(world["srcs"][0])
        assert srv.drain(timeout=5)
    finally:
        srv.close()
    with pytest.raises(PS.ServerClosed):
        srv.submit(world["srcs"][0])
    # the dense server's bundle has no radix serves: it refuses sessions
    # and n-best fan-out, as the JAX package's does
    dense = PS.ContinuousGenerationServer(world["dense"], executor=m.exe,
                                          scope=m.scope, start=False)
    with pytest.raises(ValueError, match="radix"):
        dense.submit(world["srcs"][0], session_id="chat")
    with pytest.raises(ValueError, match="radix"):
        dense.submit(world["srcs"][0], n_best=2)
    dense.close()
    assert issubclass(PD.BlockPoolExhausted, PS.ServingUnavailable)
    assert PD.BlockPoolExhausted.retryable
