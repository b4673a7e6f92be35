"""Shared set-up of the port's radix-tier and beam tests
(tests/test_torch_radix.py, tests/test_torch_beam.py): the small
Transformer of tests/torch_paged_setup.py with its seeded weights, and
chat sessions fixed up front.

With those weights, prompt rows 1 and 3 of ``prompts(5, 12)`` stop on
end_id after 16 and 12 tokens, so a session's first turn fills two and
one full blocks of 8. ``SESSIONS`` gives each session its prompt row
and the extension tokens of turns 2 and 3; ``HIST_LENGTHS`` is each
turn's history length (the GO token and the tokens before end_id). Turn
2 of every session ends on end_id with room for turn 3's extension in
the 32-token buffer, and sessions "a" and "c" share their prompt and
turn-2 extension, so their chains share blocks across sessions. The
tests check these lengths before they rely on them.
"""
import numpy as np

from torch_paged_setup import (BS, MODEL, PortModel, jax_scope,  # noqa: F401
                               paged_cache, prompts)

N_SLOTS = 4
N_BLOCKS = N_SLOTS * 4      # every lane can hold a whole buffer
N_ENTRIES = 4
PREFIX = "@rx/"
# session id -> (prompt row of prompts(5, 12), turn-2 and turn-3
# extension tokens)
SESSIONS = {
    "a": (1, ([15, 16, 17, 18], [5, 6, 7, 8])),
    "b": (3, ([3, 4, 13, 14], [5, 6, 7, 8])),
    "c": (1, ([15, 16, 17, 18], [20, 21, 22, 23])),
}
HIST_LENGTHS = {"a": [17, 21, 29], "b": [13, 20, 26], "c": [17, 21, 27]}
# rows whose greedy decode stops on end_id (rows 4 and 6 after 7
# tokens, inside the first block) or runs to the end of the buffer
# (row 0): plain-prompt reuse over 0 and 3 shared blocks
PLAIN_ROWS = [1, 3, 4, 0]


def port_bundle(model, n_slots=N_SLOTS, n_blocks=N_BLOCKS,
                n_entries=N_ENTRIES):
    return model.bundle(n_slots, paged_cache(n_blocks, n_entries),
                        state_prefix=PREFIX)


def jax_bundle(n_slots=N_SLOTS, n_blocks=N_BLOCKS, n_entries=N_ENTRIES):
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        return JT.build_decode_step_program(
            n_slots=n_slots, state_prefix=PREFIX,
            cache=JD.CacheConfig(layout="paged", block_size=BS,
                                 n_blocks=n_blocks,
                                 n_prompt_entries=n_entries),
            **MODEL)


def jax_executor():
    import paddle_tpu as jf

    return jf.Executor(jf.CPUPlace())


def drive(srv):
    """Run a server built with start=False on the calling thread (shed,
    plan, fail, cycle) until nothing is queued, live, prefilling or out at
    a prefill worker, so both packages' servers take the same admission
    decisions; a pass with nothing to run while a worker's job is out
    waits for its handoff. Works for the port's server and the JAX
    package's."""
    for _ in range(2000):
        with srv._cv:
            if not (srv._queue or srv._has_background_work_locked()
                    or srv._has_pending_external_locked()
                    or any(l is not None for l in srv._lanes)):
                return
            failures = []
            cancels = srv._shed_cancelled_locked(0.0)
            admits = srv._plan_admissions_locked(failures)
            n, m, run = srv._plan_burst_locked(admits, not srv._queue,
                                               failures)
            if not (run or cancels or failures):
                assert srv._has_pending_external_locked(), "stalled"
                srv._cv.wait(10.0)
        srv._finalize_cancelled(cancels)
        srv._fail_requests(failures)
        if run:
            srv._cycle(admits, n, m)
    raise AssertionError("the scheduler failed to converge")


def run_sessions(srv, srcs, sessions=SESSIONS):
    """Every session's three turns, turn by turn (each turn a wave of
    every session's submit, driven synchronously). Returns
    {sid: [(row, history) per turn]}."""
    out = {sid: [] for sid in sessions}
    for t in range(3):
        replies = {}
        for sid, (row, exts) in sessions.items():
            replies[sid] = srv.submit(
                srcs[row], session_id=sid,
                extend_tokens=None if t == 0 else exts[t - 1])
        drive(srv)
        for sid, rep in replies.items():
            out[sid].append((np.asarray(rep.result(timeout=0)),
                             srv.session_history(sid)))
    return out


RADIX_COUNTERS = ("prefix_hits", "prefix_misses", "shared_blocks",
                  "radix_nodes", "radix_hit_blocks", "radix_inserts",
                  "radix_adoptions", "radix_evicted_blocks",
                  "radix_admissions", "plain_radix_admissions",
                  "sessions_open", "blocks_in_use",
                  "prompt_entries_in_use")


def radix_counters(srv):
    ps = srv.pool_stats()
    return {k: ps[k] for k in RADIX_COUNTERS}
