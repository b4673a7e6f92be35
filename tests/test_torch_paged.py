"""The paged decode path of the port against the JAX package, on the CPU:
the gather / expand / masked_pool_write ops, the plain version of the
paged decode-attention kernel (#9) against the reference's
``paged_decode_attention_reference``, the paged slot-pool bundle's
structure, its step program over several ticks, and the host
allocators; then the port's paged server under pool pressure (pausing,
recompute-preemption, exhaustion) and on the unrouted composition,
held to its whole-loop decode.

Tolerances: the ops move values and are held exactly; the attention
plain version within 1e-6 (fp32, summation order); pools after several
ticks within 1e-5 (a layer of fp32 products in another order). The
Pallas kernel itself cannot run here (it calls ``pl.load``, gone in
jax 0.9), so its reference function is the oracle.
"""
import time
import types
from collections import Counter

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.core import registry as p_registry
from paddle_tpu_torch.inference import serving as PS
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.ops.kernels import paged_attention as KPA

from torch_paged_setup import (BS, LENGTHS, LONG_ROWS, MODEL, PortModel,
                               jax_scope, paged_cache, prompts, sync_drive,
                               weights)

N_SLOTS, NB, E = 2, 8, 3
NP = MODEL["max_out_len"] // BS
ROWS = N_SLOTS + 1
PREFIX = "@pg/"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ops: the port's kernels against the JAX package's, called directly
# ---------------------------------------------------------------------------
def _run_both(op_type, inputs, attrs):
    """(port, jax) outputs of one op's kernel on the same numpy inputs."""
    import jax.numpy as jnp

    from paddle_tpu.core import registry as j_registry

    op = types.SimpleNamespace(type=op_type, attrs=attrs, outputs={})
    p_ins = {k: [None if v is None else torch.from_numpy(np.array(v))]
             for k, v in inputs.items()}
    j_ins = {k: [None if v is None else jnp.asarray(v)]
             for k, v in inputs.items()}
    p = p_registry.get_op_info(op_type).kernel(
        p_registry.OpContext(op, p_ins, torch.device("cpu")))
    j = j_registry.get_op_info(op_type).kernel(
        j_registry.OpContext(op, j_ins))
    return np.asarray(p), np.asarray(j)


@pytest.mark.parametrize("shape,idx", [
    ((6, 5), [4, 0, 0, 2]), ((3, 2, 4), [2, 1]),
    ((5, 3), [[1], [4], [0], [1]]),    # Index [4, 1] -> [4, 1, 3]
    ((5, 3), [-1, 0, 7]),              # wraps -1; 7 reads NaN
    ((5, 2, 2), [[-5, 5], [3, -6]]),   # both edges, 2-D Index
])
def test_gather_matches_jax(shape, idx):
    """Out is Index.shape + X.shape[1:]; an index in [-N, 0) counts from
    the end and any other outside [0, N) reads jnp.take's fill value
    (NaN for float X: assert_array_equal matches NaN with NaN)."""
    x = np.random.RandomState(0).randn(*shape).astype("float32")
    p, j = _run_both("gather", {"X": x,
                                "Index": np.array(idx, np.int32)}, {})
    assert p.shape == j.shape == np.array(idx).shape + shape[1:]
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("times", [[1, 1, 4], [2, 3, 1]])
def test_expand_matches_jax(times):
    x = np.random.RandomState(1).randn(3, 2, 1).astype("float32")
    p, j = _run_both("expand", {"X": x}, {"expand_times": times})
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("lead,idx,gate", [
    (2, [5, 0, 17], [1.0, 0.0, 1.0]),     # a gated row aims at cell 0
    (2, [3, -1, 40, 9], [1.0, 1.0, 1.0, 1.0]),   # out of range both ways
    (2, [0, 6], [0.0, 0.0]),              # nothing kept
    (1, [2, 0, 3], None),                 # prompt entries, no gate
    (1, [1, 3, 3], None),                 # padded rows on the dustbin
])
def test_masked_pool_write_matches_jax(lead, idx, gate):
    rng = np.random.RandomState(len(idx))
    pool = rng.randn(4, 8, 2, 3).astype("float32")
    rows = len(idx)
    tail = pool.shape[lead:]
    new = rng.randn(rows, *tail).astype("float32")
    if lead == 1 and idx[-1] == idx[-2]:
        new[-1] = new[-2]  # replicated padded rows carry one value
    ins = {"Pool": pool, "New": new, "Index": np.array(idx, np.int32),
           "Gate": None if gate is None else np.array(gate, np.float32)}
    attrs = {"leading_dims": lead, "exclusive_via": "host_indices"}
    p, j = _run_both("masked_pool_write", ins, attrs)
    np.testing.assert_array_equal(p, j)
    # gated-off and out-of-range rows wrote nothing
    n = int(np.prod(pool.shape[:lead]))
    written = {i for k, i in enumerate(idx)
               if 0 <= i < n and (gate is None or gate[k] > 0)}
    for cell in set(range(n)) - written:
        np.testing.assert_array_equal(p.reshape(n, -1)[cell],
                                      pool.reshape(n, -1)[cell])


def test_masked_pool_write_writes_in_place():
    pool = torch.zeros(4, 2, 3)
    op = types.SimpleNamespace(attrs={"leading_dims": 1}, outputs={})
    ins = {"Pool": [pool], "New": [torch.ones(1, 2, 3)],
           "Index": [torch.tensor([2])], "Gate": [None]}
    out = p_registry.get_op_info("masked_pool_write").kernel(
        p_registry.OpContext(op, ins, torch.device("cpu")))
    assert out is pool and float(pool[2].sum()) == 6.0


# ---------------------------------------------------------------------------
# kernel #9's plain version against the reference function
# ---------------------------------------------------------------------------
def _paged_case(r, h, d, bs, np_pages, nb, steps, seed):
    """Pools of random (stale) values; lane i owns blocks that no other
    lane owns, pages past its step point at block 0 (unallocated), and
    the last lane shares block 0 as its first page."""
    rng = np.random.RandomState(seed)
    q = rng.randn(r, h, d).astype("float32")
    pk = rng.randn(nb, bs, h, d).astype("float32")
    pv = rng.randn(nb, bs, h, d).astype("float32")
    tab = np.zeros((r, np_pages), np.int32)
    nxt = 1
    for i, st in enumerate(steps):
        used = np_pages if st < 0 else min(np_pages, st // bs + 1)
        for p in range(used):
            if i == r - 1 and p == 0:
                continue  # shares block 0
            tab[i, p] = nxt
            nxt += 1
    assert nxt <= nb
    return q, pk, pv, tab, np.array(steps, np.int64)


@pytest.mark.parametrize("steps", [
    [0, 7, 8, 31],            # first cell, page boundaries, the last cell
    [15, 16, -1, 23],         # a lane that sees no position
    [5, 30, 1, 12],
])
def test_paged_attention_plain_matches_reference(steps):
    from paddle_tpu.ops.pallas import paged_attention as jpa

    q, pk, pv, tab, st = _paged_case(4, 2, 16, BS, NP, 20, steps,
                                     seed=sum(steps) + 40)
    want = jpa.paged_decode_attention_reference(
        q, pk, pv, tab, st.astype(np.int32), scale=0.25)
    got = KPA.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv),
        torch.from_numpy(tab), torch.from_numpy(st), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    if -1 in steps:  # the reference's uniform average over all cells
        r = steps.index(-1)
        cells = pv[tab[r]].reshape(-1, 2, 16).mean(0)
        np.testing.assert_allclose(got[r].numpy(), cells, atol=1e-6)


def _chunked_paged(q, pk, pv, tab, steps, scale, chunk):
    """Kernel #9's algorithm (csrc/paged_attention.cu) in plain torch: each
    lane's visible positions (all NP*BS at a negative step, scored 0)
    walked a chunk at a time through the block table, the softmax state
    (m, l, acc) rescaled once a chunk."""
    r, h, d = q.shape
    bs = pk.shape[1]
    t = tab.shape[1] * bs
    flat_k, flat_v = pk.reshape(-1, h, d), pv.reshape(-1, h, d)
    out = torch.empty_like(q)
    for i in range(r):
        st = int(steps[i])
        n = t if st < 0 or st + 1 >= t else st + 1
        m = torch.full((h,), -float("inf"))
        l, acc = torch.zeros(h), torch.zeros(h, d)
        for c0 in range(0, n, chunk):
            pos = torch.arange(c0, min(c0 + chunk, n))
            cells = tab[i, pos // bs].long() * bs + pos % bs
            k, v = flat_k[cells], flat_v[cells]           # [c, h, d]
            sc = (torch.zeros(h, len(pos)) if st < 0 else
                  torch.einsum("hd,chd->hc", q[i], k) * scale)
            m_new = torch.maximum(m, sc.max(-1).values)
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[:, None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[:, None] + torch.einsum("hc,chd->hd", p, v)
            m = m_new
        out[i] = acc / l[:, None]
    return out


@pytest.mark.parametrize("chunk", [BS, 4 * BS, 64])
def test_chunked_paged_formulation_matches_reference(chunk):
    """The kernel's chunked online softmax (64 positions a chunk at this
    head dim) gives the reference function's output, and the port's
    plain version that the wrapper runs on the CPU, within 1e-6 at steps
    -1, 0, BS - 1, BS and T - 1."""
    from paddle_tpu.ops.pallas import paged_attention as jpa

    t = NP * BS
    steps = [-1, 0, BS - 1, BS, t - 1]
    q, pk, pv, tab, st = _paged_case(5, 2, 16, BS, NP, 16, steps, seed=7)
    want = np.asarray(jpa.paged_decode_attention_reference(
        q, pk, pv, tab, st.astype(np.int32), scale=0.25))
    args = [torch.from_numpy(a) for a in (q, pk, pv, tab)]
    got = _chunked_paged(*args, st, 0.25, chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    plain = KPA.paged_decode_attention(*args, torch.from_numpy(st), 0.25)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-6)


def test_paged_attention_wrapper_dispatch():
    q, pk, pv, tab, st = _paged_case(3, 2, 16, BS, NP, 16, [3, 9, 20],
                                     seed=1)
    args = [torch.from_numpy(a) for a in (q, pk, pv, tab, st)]
    before = KPA.paged_decode_attention.launches
    got = KPA.paged_decode_attention(*args, 0.5)
    torch.testing.assert_close(
        got, KPA.paged_decode_attention_plain(*args, 0.5), rtol=0, atol=0)
    meta = KPA.paged_decode_attention(*[a.to("meta") for a in args], 0.5)
    assert meta.shape == (3, 2, 16) and meta.device.type == "meta"
    assert KPA.paged_decode_attention.launches == before  # CPU: plain
    shp = types.SimpleNamespace
    assert KPA.usable(shp(shape=(3, 2, 1, 16)), shp(shape=(16, 8, 2, 16)),
                      shp(shape=(3, 4)))
    for qs, ps, ts in [((3, 2, 12), (16, 8, 2, 12), (3, 4)),   # Dh % 8
                       ((3, 2, 16), (16, 4, 2, 16), (3, 4)),   # BS % 8
                       ((3, 2, 264), (16, 8, 2, 264), (3, 4)),  # Dh max
                       ((3, 2, 16), (16, 8, 4, 16), (3, 4)),   # heads
                       ((3, 2, 16), (16, 8, 2, 16), (2, 4))]:  # rows
        assert not KPA.usable(shp(shape=qs), shp(shape=ps), shp(shape=ts))


# ---------------------------------------------------------------------------
# the paged bundle against the JAX package's
# ---------------------------------------------------------------------------
def _cache(pkg):
    return pkg.CacheConfig(layout="paged", block_size=BS, n_blocks=NB,
                           n_prompt_entries=E)


@pytest.fixture(scope="module")
def bundles():
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import decode_engine as JD
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        jb = JT.build_decode_step_program(
            n_slots=N_SLOTS, state_prefix=PREFIX, cache=_cache(JD),
            **MODEL)
    with p_unique_name.guard():
        pb = PD.build_decode_step_program(
            n_slots=N_SLOTS, state_prefix=PREFIX, cache=_cache(PD),
            **MODEL)
    with p_unique_name.guard():
        _, startup, _, _ = PD.build_incremental_decode_program(**MODEL)
    return jb, pb, weights(startup)


def test_bundle_state_feeds_and_serve_keys_match(bundles):
    jb, pb, _ = bundles
    assert pb._state_specs == {
        n: (tuple(s), d) for n, (s, d) in jb._state_specs.items()}
    assert pb.kv_state_bytes() == jb.kv_state_bytes()
    # the whole serve-key set, ("radix", A) included
    assert set(pb.serves) == set(jb.serves)
    assert any(isinstance(k, tuple) and k[0] == "radix" for k in pb.serves)
    for key in pb.serves:
        assert pb.serve_feed_spec(key) == jb.serve_feed_spec(key), key
    assert pb.cow_feed_spec() == jb.cow_feed_spec()
    assert pb.cow is not None and pb.probe is not None
    assert len(pb.programs()) == len(jb.programs())
    # the whole state map, probe_probs included
    assert jb.state == pb.state and "probe_probs" in pb.state
    assert pb.cache_token() == jb.cache_token()


def _op_types(prog):
    return Counter(op.type for blk in prog.blocks for op in blk.ops)


def test_op_types_differ_by_the_paged_attention_substitution(bundles):
    """Per layer, one paged_decode_attention op takes the place of the
    reference's two gather views (reshape, gather, reshape, transpose
    each) and its scores, bias, softmax and context ops; per step body
    the cell addresses of the views (scale, unsqueeze, expand, add,
    reshape, cast) and the validity bias (three casts, greater_than,
    scale, reshape) are not built, since nothing reads them."""
    jb, pb, _ = bundles
    L = MODEL["n_layers"]
    per_layer = Counter({"reshape2": 4, "gather": 2, "transpose2": 2,
                         "matmul": 2, "scale": 1, "elementwise_add": 1,
                         "softmax": 1})
    per_body = Counter({"scale": 2, "unsqueeze2": 1, "expand": 1,
                        "elementwise_add": 1, "reshape2": 2, "cast": 4,
                        "greater_than": 1})
    dropped = Counter({k: v * L for k, v in per_layer.items()})
    dropped.update(per_body)
    for key in (0, ("miss", 2), ("hit", 1)):
        j, p = _op_types(jb.serves[key]), _op_types(pb.serves[key])
        assert p["paged_decode_attention"] == L
        p.pop("paged_decode_attention")
        assert j - p == dropped and p - j == Counter(), key
    j, p = _op_types(jb.step), _op_types(pb.step)
    p.pop("paged_decode_attention")
    assert j - p == dropped and p - j == Counter()


def test_init_slot_state_places_state_on_the_given_device(bundles):
    """The pool state lands on the device the caller names, and by
    default on the card, as ``Executor()`` runs on ``CUDAPlace(0)``
    (meta stands in for a second device here: it needs no card)."""
    import inspect

    _, pb, _ = bundles
    default = inspect.signature(pb.init_slot_state).parameters["device"]
    assert torch.device(default.default).type == "cuda"
    for device in ("cpu", "meta"):
        scope = pf.Scope()
        pb.init_slot_state(scope, device)
        for name, (shape, _) in pb._state_specs.items():
            t = scope._get(name)
            assert t.device.type == device and tuple(t.shape) == shape


def test_step_program_ticks_match_jax(bundles):
    """One miss admission of two prompts, then 10 ticks of the step
    program in both packages from the same state: token buffers, steps
    and active flags equal; the pools within 1e-5."""
    import paddle_tpu as jf

    jb, pb, params = bundles
    jscope = jax_scope(params)
    jexe = jf.Executor(jf.CPUPlace())
    jb.init_slot_state(jscope)
    pscope = pf.Scope()
    pf.load_numpy_params(pscope, params, pf.CPUPlace())
    pexe = pf.Executor(pf.CPUPlace())
    pb.init_slot_state(pscope, "cpu")
    tab = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 0, 0, 0]], np.int32)
    pref = np.array([1, 0, E], np.int32)
    jscope._set(PREFIX + "block_tab", tab)
    jscope._set(PREFIX + "prompt_ref", pref)
    pscope._set(PREFIX + "block_tab", torch.from_numpy(tab))
    pscope._set(PREFIX + "prompt_ref", torch.from_numpy(pref))
    feed = {"src_ids": prompts(3, 2), "slots": np.array([0, 1]),
            "prompt_slots": np.array([1, 0])}
    jexe.run(jb.prefills[2], feed=feed, scope=jscope)
    pexe.run(pb.prefills[2], feed=feed, scope=pscope)
    for _ in range(10):
        jexe.run(jb.step, scope=jscope)
        pexe.run(pb.step, scope=pscope)
    for name in ("tok_buf", "step", "active", "finished"):
        var = pb.state[name]
        np.testing.assert_array_equal(
            pscope._get(var).numpy(),
            np.asarray(jscope._get(var)).astype(np.int64), err_msg=name)
    assert (pscope._get(pb.state["step"]).numpy()[:2] == 10).all()
    for name in pb._state_specs:
        if "@POOL" in name:
            np.testing.assert_allclose(
                pscope._get(name).numpy(), np.asarray(jscope._get(name)),
                rtol=0, atol=1e-5, err_msg=name)


def test_builder_refuses_what_is_not_ported():
    # drafts are ported (serving step 9; tests/test_torch_speculative.py)
    # and validated at build; sharding and the head-interleaved qkv
    # weight are serving step 10 of the port
    with pytest.raises(ValueError, match="draft k"):
        PD.build_decode_step_program(draft=PD.DraftConfig(k=-1), **MODEL)
    with pytest.raises(NotImplementedError, match="step 10"):
        PD.build_decode_step_program(sharding=object(), **MODEL)
    with pytest.raises(NotImplementedError, match="step 10"):
        PD.cached_decoder_step(None, [], [], None, 32, 2, 64,
                               qkv_interleaved=True)
    # chunked prefill is ported: CacheConfig still rejects a chunk of 1
    with pytest.raises(ValueError, match="chunk_tokens == 1"):
        PD.CacheConfig(layout="paged", block_size=BS, n_blocks=NB,
                       n_prompt_entries=E, chunk_tokens=1).validate(32)
    with pytest.raises(ValueError, match="must divide"):
        PD.CacheConfig(layout="paged", block_size=5, n_blocks=4,
                       n_prompt_entries=1).validate(32)


# ---------------------------------------------------------------------------
# the host allocators against the JAX package's, on the same sequences
# ---------------------------------------------------------------------------
def _both(jobj, pobj, method, *args):
    """Call `method` on both; both raise BlockLifetimeError or both
    return the same value."""
    from paddle_tpu.models import decode_engine as JD

    outs = []
    for obj, err in ((jobj, JD.BlockLifetimeError),
                     (pobj, PD.BlockLifetimeError)):
        try:
            outs.append(("ok", getattr(obj, method)(*args)))
        except err:
            outs.append(("error", None))
    assert outs[0] == outs[1], (method, args, outs)
    return outs[1][1]


def test_host_block_pool_matches_jax():
    from paddle_tpu.models import decode_engine as JD

    j, p = JD.HostBlockPool(5), PD.HostBlockPool(5)
    rng = np.random.RandomState(0)
    for _ in range(300):
        op = rng.choice(["alloc", "free", "incref", "decref"])
        if op == "alloc":
            _both(j, p, "alloc")
        elif op == "free":
            blocks = list(rng.randint(-1, 6, size=rng.randint(1, 3)))
            _both(j, p, "free", blocks)
        else:
            _both(j, p, op, int(rng.randint(-1, 6)))
        for b in range(5):
            assert j.typestate(b) == p.typestate(b)
            assert j.refcount(b) == p.refcount(b)
            assert j.writable(b) == p.writable(b)
        assert (j.free_count, j.in_use, j.live_blocks(),
                j.shared_blocks()) == (p.free_count, p.in_use,
                                       p.live_blocks(), p.shared_blocks())


def test_prompt_prefix_cache_matches_jax():
    from paddle_tpu.models import decode_engine as JD

    j, p = JD.PromptPrefixCache(3, 2), PD.PromptPrefixCache(3, 2)
    rng = np.random.RandomState(1)
    held = []
    for _ in range(300):
        prompt = tuple(int(x) for x in rng.randint(0, 3, size=4))
        op = rng.choice(["acquire", "release", "invalidate"])
        if op == "acquire":
            tier, _ = _both(j, p, "lookup", prompt)
            if tier == "hit":
                held.append(_both(j, p, "acquire_hit", prompt))
            else:
                e = _both(j, p, "acquire_fresh", prompt, tier == "partial")
                if e is not None:
                    held.append(e)
        elif op == "release":
            e = held.pop(rng.randint(len(held))) if held and \
                rng.rand() < 0.8 else int(rng.randint(0, 3))
            _both(j, p, "release", e)
        else:
            _both(j, p, "invalidate", int(rng.randint(0, 3)))
        for e in range(3):
            assert (j.refcount(e), j.typestate(e), j.writable(e),
                    j.is_shared(e)) == (p.refcount(e), p.typestate(e),
                                        p.writable(e), p.is_shared(e))
        assert (j.hits, j.misses, j.partials, j.evictions, j.in_use) == \
            (p.hits, p.misses, p.partials, p.evictions, p.in_use)


# ---------------------------------------------------------------------------
# the paged server under pool pressure (the port against its whole-loop
# decode; tests/test_paged_decode.py holds the JAX package the same way)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    m = PortModel()
    srcs = prompts(5, 12)
    want = m.decode(srcs)
    assert list(PS.count_generated_tokens(want, MODEL["end_id"])) \
        == LENGTHS, "the seeded workload moved"
    return m, srcs, want


def _tight(m, n_slots, n_blocks, n_entries, prefix):
    # radix_reuse=False, as tests/test_paged_decode.py serves: these
    # tests pin the pool's own contracts, and a retired plain request's
    # blocks would otherwise stay in the radix tree as cache
    return PS.PagedContinuousGenerationServer(
        m.bundle(n_slots, paged_cache(n_blocks, n_entries),
                 state_prefix=prefix, admit_buckets=[1, n_slots]),
        executor=m.exe, scope=m.scope, start=False, radix_reuse=False)


def test_parity_under_block_pressure_with_pausing(model):
    """Six lanes over 8 blocks for 12 requests, six of which need all 4
    pages: lanes pause at block boundaries (their active flag masked, no
    pool writes) and resume as retirements free blocks. Tokens stay
    exact through pause and resume."""
    m, srcs, want = model
    srv = _tight(m, 6, 8, 4, "@press/")
    try:
        got = np.stack([r.result(0) for r in sync_drive(srv, srcs)])
        ps = srv.pool_stats()
    finally:
        srv.close()
    np.testing.assert_array_equal(got, want)
    assert ps["pause_events"] > 0, "the geometry must pause a lane"
    assert ps["paused_lanes"] == 0 and ps["blocks_in_use"] == 0
    assert ps["prompt_entries_in_use"] == 0


def test_parity_under_lockstep_preemption(model):
    """Four full-buffer generations in lockstep on 4 blocks cross their
    first block boundary together: the youngest lanes are
    recompute-preempted (re-queued, not failed) and re-decode
    byte-identically."""
    m, srcs, want = model
    longs = LONG_ROWS[:4]
    srv = _tight(m, 4, 4, 4, "@lock/")
    try:
        got = np.stack([r.result(0) for r in sync_drive(srv, srcs[longs])])
        ps = srv.pool_stats()
        st = srv.stats()
    finally:
        srv.close()
    np.testing.assert_array_equal(got, want[longs])
    assert st["completed"] == 4 and ps["preemptions"] > 0
    assert ps["blocks_in_use"] == 0


def test_block_exhaustion_named_retryable_error_not_hang(model):
    """A 1-block pool cannot hold a full-buffer generation: the request
    fails with the named retryable BlockPoolExhausted (not a hang), and
    the server keeps serving requests that fit one block."""
    m, srcs, want = model
    long_row, short_row = LONG_ROWS[0], LENGTHS.index(8)
    srv = PS.PagedContinuousGenerationServer(
        m.bundle(2, paged_cache(1, 2), state_prefix="@tiny/"),
        executor=m.exe, scope=m.scope, radix_reuse=False)
    try:
        t0 = time.monotonic()
        with pytest.raises(PS.BlockPoolExhausted) as ei:
            srv.submit(srcs[long_row]).result(timeout=60)
        assert time.monotonic() - t0 < 60 and ei.value.retryable
        got = srv.submit(srcs[short_row]).result(timeout=60)
        ps = srv.pool_stats()
    finally:
        srv.close()
    np.testing.assert_array_equal(got, want[short_row])
    assert ps["blocks_in_use"] == 0 and ps["prompt_entries_in_use"] == 0


def test_unrouted_paged_path_matches(model):
    """At block_size 4 the kernel's gate refuses the pool (BS % 8), so
    the step takes the JAX package's composition (gather views through
    expand-built cell addresses, biased softmax): same tokens."""
    m, srcs, want = model
    b = m.bundle(2, paged_cache(16, 3, block_size=4), state_prefix="@bs4/")
    types_ = _op_types(b.step)
    assert types_["paged_decode_attention"] == 0
    assert types_["expand"] == 1 and types_["gather"] == 2 * (
        MODEL["n_layers"] + 1)
    with PS.PagedContinuousGenerationServer(b, executor=m.exe,
                                            scope=m.scope,
                                            radix_reuse=False) as srv:
        got = np.stack([r.result(timeout=120)
                        for r in [srv.submit(s) for s in srcs[:4]]])
        assert srv.pool_stats()["blocks_in_use"] == 0
    np.testing.assert_array_equal(got, want[:4])
