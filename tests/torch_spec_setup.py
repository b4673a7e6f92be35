"""Shared set-up of the port's speculative-decoding tests
(tests/test_torch_speculative.py, tests/test_torch_adaptive_spec.py), at
the JAX package's test size (tests/test_speculative_decode.py:36-66).

A target (d 32, 1 layer) and a draft (d 16, 1 layer, parameters under
``draft_``) learn the same fixed pool of 8 memorizable prompts, each with
end_id planted at its own position, so the two agree well above chance
and the greedy decodes have mixed lengths. They are trained once a module
in the JAX package, as its own tests train them, and copied as numpy
arrays into a port scope: every comparison then runs both packages on
the same weights.
"""
import numpy as np

V, D, H, L, S, MAXT = 16, 32, 2, 1, 10, 32
DD = 16          # the draft's width
K = 2            # proposals a lane a step
END_ID = 1
START_ID = 2
N_SLOTS = 4
# paged geometry: coverage in (k+1)-position ticks never runs out, and
# prompt entries outlive the workload
BS, NB, E = 8, 20, 12
KW = dict(seq_len=S, max_out_len=MAXT, d_model=D, n_heads=H, n_layers=L,
          d_inner=64, vocab=V, start_id=START_ID, end_id=END_ID)
DRAFT = dict(d_model=DD, n_heads=H, n_layers=L, d_inner=32)

_POOL_RNG = np.random.RandomState(5)
PROMPT_POOL = []
for _p in (1, 2, 3, 4, 6, 8, 10, 10):
    _src = _POOL_RNG.randint(3, V, (S,)).astype(np.int64)
    if _p < S:
        _src[_p:] = END_ID
    PROMPT_POOL.append(_src)
PROMPT_POOL = np.stack(PROMPT_POOL)


def pool_rows(rng, n):
    """The pool indices of n draws from the fixed pool."""
    return rng.randint(0, len(PROMPT_POOL), n)


def mixed_prompts(rng, n):
    return PROMPT_POOL[pool_rows(rng, n)]


def train_pair():
    """The JAX package's recipe: 150 Adam steps of both models on batches
    of 8 pool prompts. Returns {name: numpy array} of every parameter."""
    import paddle_tpu as jf
    from paddle_tpu import unique_name
    from paddle_tpu.core.scope import Scope
    from paddle_tpu.models import transformer as JT

    jf.seed(0)
    scope = Scope()
    exe = jf.Executor(jf.CPUPlace())
    with unique_name.guard():
        t_main, t_st, t_loss = JT.build_program(
            seq_len=S, d_model=D, n_heads=H, n_layers=L, d_inner=64,
            vocab=V, with_optimizer=False, dropout_rate=0.0)
        with jf.program_guard(t_main, t_st):
            jf.optimizer.Adam(learning_rate=0.02).minimize(t_loss)
        d_main, d_st, d_loss = JT.build_program(
            seq_len=S, d_model=DD, n_heads=H, n_layers=L, d_inner=32,
            vocab=V, with_optimizer=False, dropout_rate=0.0,
            name_prefix="draft_")
        with jf.program_guard(d_main, d_st):
            jf.optimizer.Adam(learning_rate=0.02).minimize(d_loss)
    exe.run(t_st, scope=scope)
    exe.run(d_st, scope=scope)
    rng = np.random.RandomState(7)
    for _ in range(150):
        src = mixed_prompts(rng, 8)
        tgt_in = np.concatenate(
            [np.full((8, 1), START_ID, np.int64), src[:, :-1]], 1)
        feed = {"src_ids": src, "tgt_ids": tgt_in, "label": src}
        exe.run(t_main, feed=feed, fetch_list=[t_loss], scope=scope)
        exe.run(d_main, feed=feed, fetch_list=[d_loss], scope=scope)
    names = [p.name for prog in (t_main, d_main)
             for p in prog.all_parameters()]
    return {n: np.asarray(scope._get(n)).copy() for n in names}


def jax_scope(params):
    import paddle_tpu as jf

    scope = jf.Scope()
    for name, arr in params.items():
        scope._set(name, arr)
    return scope


def port_scope(params):
    import paddle_tpu_torch as pf

    scope = pf.Scope()
    pf.load_numpy_params(scope, params, pf.CPUPlace())
    return scope


def jax_pool_oracle(params):
    """The JAX package's whole-loop greedy decode of every pool prompt,
    sentinel-normalized: [len(PROMPT_POOL), MAXT] (one compile; a wave's
    oracle rows are indexed by pool row)."""
    import paddle_tpu as jf
    from paddle_tpu import unique_name
    from paddle_tpu.inference import apply_eos_sentinel
    from paddle_tpu.models import transformer as JT

    with unique_name.guard():
        main, _, _, buf = JT.build_incremental_decode_program(**KW)
    out, = jf.Executor(jf.CPUPlace()).run(
        main, feed={"src_ids": PROMPT_POOL}, fetch_list=[buf],
        scope=jax_scope(params))
    return apply_eos_sentinel(np.asarray(out), end_id=END_ID)


def serve(srv, srcs, seeds=None, order=None):
    """Submit `srcs` (in `order`) to a server built with start=False,
    drive it on this thread, close it. Returns (rows in request order,
    stats)."""
    from torch_radix_setup import drive

    order = range(len(srcs)) if order is None else order
    try:
        replies = {i: srv.submit(srcs[i], **(
            {} if seeds is None else {"seed": seeds[i]})) for i in order}
        drive(srv)
        got = np.stack([np.asarray(replies[i].result(timeout=0))
                        for i in range(len(srcs))])
        st = srv.stats()
    finally:
        srv.close()
    return got, st
