"""The port's speculative decoding on the CPU, against the JAX package:

* ``spec_accept`` and ``span_scatter`` equal the JAX ops on random
  stacks (greedy and sampled; k 0, 1 and 3; ties; an all-rejected run;
  end_id inside the run; a room clip): every output, and the acceptance
  uniforms bit for bit, unclamped at 0 where a planted draw of 0 bits
  tells them from the tiny-floored uniform;
* greedy speculative tokens (dense and paged, admission order and burst
  length varied) equal the JAX package's whole-loop decode and its
  speculative server's, with the same counters over a wave of several
  bursts (the draft's cache-fill step keeps acceptance up after the
  first burst); the k = 0 bundle is the plain step;
* sampled speculative tokens equal the JAX package's at the same seeds;
* counter units, cache tokens, the build-time refusal of a draft prefix
  that collides with the target's, and a paged run that never writes
  through an unallocated table row into a block it does not own.

Weights: tests/torch_spec_setup.py (trained once a module in the JAX
package).
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.ops import spec_ops as SO

from torch_spec_setup import (BS, DRAFT, END_ID, E, K, KW, MAXT, N_SLOTS,
                              NB, PROMPT_POOL, jax_pool_oracle, jax_scope,
                              pool_rows, port_scope, serve, train_pair)

SAMPLING = dict(temperature=1.0, top_k=8, base_seed=3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- the ops ------------------------------------------------------------
def _accept_program(pkg, r, k, v, **attrs):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        L = pkg.layers

        def data(name, shape, dtype):
            return L.data(name, shape=shape, dtype=dtype,
                          append_batch_size=False)

        outs = L.spec_accept(
            data("props", [r, k], "int64"),
            data("dprobs", [r, k, v], "float32"),
            data("tprobs", [r, k + 1, v], "float32"),
            data("seed", [r], "int64"), data("pos", [r], "int64"), k=k,
            **attrs)
    return main, list(outs)


class _Ctx:
    """The slice of an op context a kernel reads: inputs by slot and
    attrs."""

    def __init__(self, inputs, attrs):
        self._inputs, self._attrs = inputs, attrs

    def input(self, slot, idx=0):
        return self._inputs.get(slot)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


_SLOTS = dict(props="Proposals", dprobs="DraftProbs", tprobs="TargetProbs",
              seed="Seed", pos="Pos")
_OUTS = ("Advance", "Tokens", "Accepted", "Fin")


def _run_accept(feed, k, **attrs):
    """Both packages' spec_accept kernels on the same stacks (called
    directly: the JAX kernel runs op by op, without a program's jit)."""
    from paddle_tpu.core import registry as JR
    from paddle_tpu_torch.core import registry as PR

    attrs = dict(attrs, k=k)
    got = PR.get_op_info("spec_accept").kernel(_Ctx(
        {_SLOTS[n]: torch.from_numpy(a) for n, a in feed.items()}, attrs))
    want = JR.get_op_info("spec_accept").kernel(_Ctx(
        {_SLOTS[n]: jnp.asarray(a) for n, a in feed.items()}, attrs))
    return ([got[n].numpy() for n in _OUTS],
            [np.asarray(want[n]).astype(np.int64) for n in _OUTS])


def _stack(rng, r, k, v, case):
    """Random target and draft distributions with proposals; `case`
    plants ties, an all-rejected run, end_id inside the run or a lane
    near the end of the buffer."""
    tp = rng.dirichlet(np.full(v, 0.4), (r, k + 1)).astype(np.float32)
    dp = rng.dirichlet(np.full(v, 0.4), (r, max(k, 1))).astype(
        np.float32)[:, :k]
    props = rng.randint(0, v, (r, k)).astype(np.int64)
    pos = rng.randint(0, MAXT - 8, r).astype(np.int64)
    if k:
        # lane 0 proposes the target's argmax everywhere (accepted under
        # greedy); lane 1 a zero-probability token (rejected under both)
        props[0] = tp[0, :k].argmax(-1)
        props[1] = tp[1, :k].argmin(-1)
        tp[1, np.arange(k), props[1]] = 0.0
        tp[1] /= tp[1].sum(-1, keepdims=True)
    if case == "ties":
        tp = np.round(tp * 4) / 4 + 1e-3
        tp /= tp.sum(-1, keepdims=True)
        dp = np.round(dp * 4) / 4 + 1e-3
        dp /= dp.sum(-1, keepdims=True)
    elif case == "rejected":
        for j in range(k):
            tp[:, j, props[:, j]] = 0.0
        tp /= tp.sum(-1, keepdims=True)
    elif case == "eos" and k:
        props[:, k // 2] = END_ID
        tp[:, :, END_ID] += 0.5
        tp /= tp.sum(-1, keepdims=True)
    elif case == "room":
        pos[:] = MAXT - 1 - np.arange(r) % (k + 2)
    return dict(props=props, dprobs=dp.reshape(r, k, v), tprobs=tp,
                seed=np.array([7, 2 ** 31 + 5, 2 ** 32 - 1, 123456789, 0,
                               99][:r], np.int64), pos=pos)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("k,case", [(0, "random"), (1, "random"),
                                    (3, "random"), (3, "ties"),
                                    (3, "rejected"), (3, "eos"),
                                    (3, "room")])
def test_spec_accept_matches_jax(k, case, greedy):
    rng = np.random.RandomState(k * 31 + len(case))
    feed = _stack(rng, 6, k, 12, case)
    got, want = _run_accept(feed, k, end_id=END_ID, max_len=MAXT,
                            greedy=greedy, base_seed=11, noise_tag=8)
    for name, g, w in zip(("Advance", "Tokens", "Accepted", "Fin"), got,
                          want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    adv, acc = got[0], got[2]
    assert (adv >= 0).all() and (adv <= k + 1).all()
    assert (acc <= adv).all()
    if case == "rejected" or k == 0:
        assert (acc == 0).all()
    if case == "room":
        assert (adv <= np.clip(MAXT - 1 - feed["pos"], 0, None)).all()
    if case == "eos":
        assert got[3].any()


def test_spec_accept_layer_through_a_program():
    """The port's layer and op through a program give the JAX kernel's
    outputs."""
    k = 3
    feed = _stack(np.random.RandomState(5), 6, k, 12, "random")
    attrs = dict(end_id=END_ID, max_len=MAXT, greedy=False, base_seed=4,
                 noise_tag=8)
    with unique_name.guard():
        pm, po = _accept_program(pf, 6, k, 12, **attrs)
    got = pf.Executor(pf.CPUPlace()).run(pm, feed=feed, fetch_list=po)
    _, want = _run_accept(feed, k, **attrs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_acceptance_uniforms_are_jax_bits():
    """The scalar acceptance uniforms of jax.random.uniform(key) over
    [R, k] keys, bit for bit (minval 0: no tiny floor)."""
    seeds = np.array([7, 2 ** 31 + 5, 2 ** 32 - 1, 123456789, 0],
                     np.int64)
    pos = np.array([[1, 2, 3], [40, 41, 42], [0, 5, 255], [9, 10, 11],
                    [2 ** 31 + 1, 3, 4]], np.int64)
    base = jax.random.fold_in(jax.random.PRNGKey(11), 8 + 101)
    keys = jax.vmap(lambda s, ps: jax.vmap(
        lambda p: jax.random.fold_in(jax.random.fold_in(base, s), p))(ps))(
        jnp.asarray(seeds.astype(np.uint32)),
        jnp.asarray(pos.astype(np.uint32)))
    want = np.asarray(jax.vmap(jax.vmap(jax.random.uniform))(keys))
    got = SO.uniform_scalar(SO.lane_keys(
        SO.base_key(11, 8 + SO._TAG_ACCEPT), torch.from_numpy(seeds),
        torch.from_numpy(pos))).numpy()
    np.testing.assert_array_equal(got, want)


def test_zero_bits_give_an_unclamped_zero(monkeypatch):
    """Planted draws of 0 bits: the scalar uniform is exactly 0 (the
    sampling uniform floors at tiny), and spec_accept accepts a proposal
    whose target probability is a denormal below tiny * q, which a
    tiny-floored uniform would reject."""
    monkeypatch.setattr(SO, "random_bits",
                        lambda key, n: torch.zeros(
                            key[0].shape + (n,), dtype=torch.int64))
    key = SO.lane_keys(SO.base_key(0, 101), torch.tensor([5]),
                       torch.tensor([3]))
    assert SO.uniform_scalar(key).item() == 0.0
    assert SO.uniform(key, 1).item() == torch.finfo(torch.float32).tiny
    v = 4
    tprobs = np.zeros((1, 2, v), np.float32)
    tprobs[0, 0, 2] = np.float32(1e-44)      # a denormal
    tprobs[0, 0, 1] = 1.0 - tprobs[0, 0, 2]
    tprobs[0, 1, 3] = 1.0
    dprobs = np.zeros((1, 1, v), np.float32)
    dprobs[0, 0, 2] = 1.0
    with unique_name.guard():
        pm, po = _accept_program(pf, 1, 1, v, end_id=0, max_len=MAXT,
                                 greedy=False)
    got = pf.Executor(pf.CPUPlace()).run(pm, feed=dict(
        props=np.array([[2]]), dprobs=dprobs, tprobs=tprobs,
        seed=np.array([5]), pos=np.array([3])), fetch_list=po)
    assert got[2][0] == 1 and got[1][0, 0] == 2


def test_span_scatter_matches_jax():
    import paddle_tpu as jf

    rng = np.random.RandomState(3)
    r, t, w = 5, 12, 4
    feed = dict(buf=rng.randint(0, 50, (r, t)).astype(np.int64),
                vals=rng.randint(50, 99, (r, w)).astype(np.int64),
                start=np.array([0, 3, 9, 11, 12], np.int64),
                count=np.array([4, 0, 3, 4, 2], np.int64))

    def prog(pkg):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            L = pkg.layers
            d = {n: L.data(n, shape=list(a.shape), dtype="int64",
                           append_batch_size=False)
                 for n, a in feed.items()}
            out = L.span_scatter(d["buf"], d["vals"], d["start"],
                                 d["count"])
        return main, out

    with unique_name.guard():
        pm, po = prog(pf)
    jm, jo = prog(jf)
    got = pf.Executor(pf.CPUPlace()).run(pm, feed=feed, fetch_list=[po])[0]
    want = jf.Executor(jf.CPUPlace()).run(jm, feed=feed, fetch_list=[jo])[0]
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got[1] == feed["buf"][1]).all()
    np.testing.assert_array_equal(got[0, :4], feed["vals"][0])


# --- the servers ----------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    params = train_pair()
    oracle = jax_pool_oracle(params)
    draft = PD.DraftConfig(k=K, **DRAFT)
    built = {}
    for name, kw in (
            ("spec", dict(draft=draft)),
            ("pspec", dict(draft=draft, cache=PD.CacheConfig(
                "paged", BS, NB, E))),
            ("sampled", dict(draft=draft,
                             sampling=PD.SamplingConfig(**SAMPLING))),
            ("k0", dict(draft=PD.DraftConfig(k=0, **DRAFT)))):
        with unique_name.guard():
            built[name] = PD.build_decode_step_program(
                n_slots=N_SLOTS, admit_buckets=[1, N_SLOTS],
                state_prefix=f"@{name}/", **kw, **KW)
    return dict(params=params, oracle=oracle, draft=draft,
                scope=port_scope(params),
                exe=pf.Executor(pf.CPUPlace()), **built)


def _port(world, name, **kw):
    b = world[name]
    cls = PS.PagedContinuousGenerationServer \
        if b.cache.layout == "paged" else PS.ContinuousGenerationServer
    return cls(b, executor=world["exe"], scope=world["scope"],
               start=False, **kw)


def _jax_server(world, draft_kw, sampling=None, paged=False, **kw):
    import paddle_tpu as jf
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.inference import serving as JS
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        jb = JT.build_decode_step_program(
            n_slots=N_SLOTS, admit_buckets=[N_SLOTS], state_prefix="@js/",
            draft=JD.DraftConfig(**draft_kw),
            sampling=None if sampling is None
            else JD.SamplingConfig(**sampling),
            cache=JD.CacheConfig("paged", BS, NB, E) if paged else None,
            **KW)
    cls = JS.PagedContinuousGenerationServer if paged \
        else JS.ContinuousGenerationServer
    return jb, cls(jb, executor=jf.Executor(jf.CPUPlace()),
                   scope=jax_scope(world["params"]), start=False, **kw)


SPEC_KEYS = ("proposed", "accepted", "emitted", "draft_steps",
             "target_steps")


def test_greedy_dense_matches_jax_server_and_whole_loop(world):
    """A 12-request wave through 4 slots at 4 ticks a burst: the port's
    rows equal the JAX whole loop's and the JAX speculative server's, and
    so do the counters of every burst (acceptance after the first burst
    included), with the trained draft accepting well above chance."""
    rows = pool_rows(np.random.RandomState(11), 12)
    srcs = PROMPT_POOL[rows]
    want = world["oracle"][rows]
    assert len({int((w != -1).sum()) for w in want}) > 1
    kw = dict(steps_per_tick=4, drain_steps=4)
    got, st = serve(_port(world, "spec", **kw), srcs)
    np.testing.assert_array_equal(got, want)
    jb, jsrv = _jax_server(world, dict(k=K, **DRAFT), **kw)
    assert jb.cache_token() == world["spec"].cache_token()
    jgot, jst = serve(jsrv, srcs)
    np.testing.assert_array_equal(jgot, want)
    sp, jsp = st["speculative"], jst["speculative"]
    assert {k: sp[k] for k in SPEC_KEYS} == {k: jsp[k] for k in SPEC_KEYS}
    assert sp["acceptance_rate"] == jsp["acceptance_rate"] > 0.3, sp
    assert st["device_telemetry"]["ticks"] > 2 * len(rows) // N_SLOTS


def test_greedy_paged_matches_jax_server_and_whole_loop(world):
    """The paged server: multi-position verify writes through the block
    tables; hit and miss admissions both carry the draft state. Rows and
    counters equal the JAX package's paged speculative server's."""
    rows = pool_rows(np.random.RandomState(19), 10)
    rows[5] = rows[0]  # a prefix hit mid-stream
    srcs = PROMPT_POOL[rows]
    got, st = serve(_port(world, "pspec"), srcs)
    np.testing.assert_array_equal(got, world["oracle"][rows])
    assert st["block_pool"]["prefix_hits"] >= 1
    assert st["block_pool"]["blocks_in_use"] == 0
    _, jsrv = _jax_server(world, dict(k=K, **DRAFT), paged=True)
    jgot, jst = serve(jsrv, srcs)
    np.testing.assert_array_equal(got, jgot)
    assert {k: st["speculative"][k] for k in SPEC_KEYS} \
        == {k: jst["speculative"][k] for k in SPEC_KEYS}


@pytest.mark.parametrize("kind", ["spec", "pspec"])
def test_order_and_burst_length_move_no_token(world, kind):
    rows = pool_rows(np.random.RandomState(13), 8)
    want = world["oracle"][rows]
    srcs = PROMPT_POOL[rows]
    got, _ = serve(_port(world, kind), srcs, order=range(7, -1, -1))
    np.testing.assert_array_equal(got, want)
    got1, _ = serve(_port(world, kind, steps_per_tick=1, drain_steps=1),
                    srcs)
    np.testing.assert_array_equal(got1, want)
    got6, st = serve(_port(world, kind, steps_per_tick=6), srcs)
    np.testing.assert_array_equal(got6, want)
    # fewer target steps than tokens: the multi-token lever is real
    assert st["speculative"]["target_steps"] < st["speculative"]["emitted"]


def test_k0_is_the_plain_step(world):
    rows = pool_rows(np.random.RandomState(23), 6)
    got, st = serve(_port(world, "k0"), PROMPT_POOL[rows])
    np.testing.assert_array_equal(got, world["oracle"][rows])
    assert "speculative" not in st
    b = world["k0"]
    assert b.spec_k == 0 and b.tokens_per_tick == 1 and b.needs_seeds
    assert not any(n.startswith("spec_") for n in b.state)


def test_counter_units(world):
    rows = pool_rows(np.random.RandomState(29), 8)
    got, st = serve(_port(world, "spec"), PROMPT_POOL[rows])
    sp = st["speculative"]
    assert sp["draft_steps"] == K * sp["target_steps"]
    assert 0 <= sp["accepted"] <= sp["proposed"]
    assert sp["emitted"] == int(
        PS.count_generated_tokens(got, END_ID).sum()) == st["tokens"]
    assert sp["accepted"] <= sp["emitted"]
    assert 1.0 <= sp["mean_accepted_len"] <= K + 1


def test_sampled_spec_matches_jax_at_the_same_seeds(world):
    """Sampled speculation (temperature 1, top-k 8): the draft's draws
    under tag 1, the acceptance uniforms under 8 + 101 and the residual
    or bonus draws under 8 + 102 give the JAX server's tokens; the
    admission order moves none, and other seeds move the stream."""
    rows = pool_rows(np.random.RandomState(37), 8)
    srcs = PROMPT_POOL[rows]
    seeds = [7, 2 ** 31 + 5, 2 ** 32 - 1, 123456789, 0, 11, 12, 13]
    got, st = serve(_port(world, "sampled"), srcs, seeds=seeds)
    _, jsrv = _jax_server(world, dict(k=K, **DRAFT), sampling=SAMPLING)
    want, jst = serve(jsrv, srcs, seeds=seeds)
    np.testing.assert_array_equal(got, want)
    assert {k: st["speculative"][k] for k in SPEC_KEYS} \
        == {k: jst["speculative"][k] for k in SPEC_KEYS}
    back, _ = serve(_port(world, "sampled"), srcs, seeds=seeds,
                    order=range(7, -1, -1))
    np.testing.assert_array_equal(back, got)
    other, _ = serve(_port(world, "sampled"), srcs,
                     seeds=[s + 1000 for s in seeds])
    assert (other != got).any()


def test_cache_tokens_and_colliding_prefix(world):
    toks = {world[n].cache_token()
            for n in ("spec", "pspec", "sampled", "k0")}
    with unique_name.guard():
        plain = PD.build_decode_step_program(n_slots=2, admit_buckets=[2],
                                             **KW)
    toks.add(plain.cache_token())
    assert len(toks) == 5
    with pytest.raises(ValueError, match="PTA100"):
        PD.build_decode_step_program(
            n_slots=2, state_prefix="@bad/",
            draft=PD.DraftConfig(d_model=32, n_heads=2, n_layers=1,
                                 d_inner=64, k=1, prefix=""), **KW)
    for bad in (dict(k=-1), dict(kind="tree"), dict(ngram=0, kind="ngram"),
                dict(k_options=(3, 2)), dict(k=2, k_options=(0, 3)),
                dict(k=0, k_options=(0, 2))):
        with pytest.raises(ValueError):
            PD.DraftConfig(**dict(DRAFT, **bad)).validate(MAXT)
    assert PD.DraftConfig(sharded=True, **DRAFT).token() \
        != PD.DraftConfig(**DRAFT).token()


def test_paged_verify_never_writes_a_block_it_does_not_own(world):
    """Block 0 is taken out of the allocator and filled with sentinels: a
    lane's table rows past its grant read 0, so a verify write sized by
    one position a tick (the plain step's coverage) would land in it.
    Coverage sized by tokens_per_tick, and the gate on positions past
    the buffer, keep it untouched through a wave of full-buffer rows."""
    b = world["pspec"]
    srv = _port(world, "pspec", steps_per_tick=3)
    with srv._cv:
        srv._blocks._free.remove(0)
        srv._blocks._state[0] = "exclusive"
        srv._blocks._refs[0] = 1
    names = [n for n in b._state_specs if n.startswith("@pspec/self_")]
    for n in names:
        world["scope"]._get(n)[0].fill_(123.0)
    rows = np.array([6, 7, 0, 6, 7, 1, 6, 7])  # the no-EOS rows first
    got, st = serve(srv, PROMPT_POOL[rows])
    np.testing.assert_array_equal(got, world["oracle"][rows])
    for n in names:
        assert (world["scope"]._get(n)[0] == 123.0).all(), n
    assert b.tokens_per_tick == K + 1
