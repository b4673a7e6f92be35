"""``Executor.run_steps``, ``prepare(steps=K)``, the program cache, the
last-use plan and the step key of the port, against K ``run`` calls and
against the JAX package.

The model is test_torch_train.py's Transformer: d_model 64, 2 heads, 1+1
layers, d_inner 128, vocab 256, seq 16, batch 4, dropout 0, Adam under
noam decay with warmup_steps=100.

Tolerances:
- ``run_steps`` against K ``run`` calls of the port on the CPU: bit for
  bit (the same ops on the same values in the same order).
- the port's ``run_steps`` against the JAX package's: losses 1e-5
  relative (fp32, sums in another order); parameters 1e-5 + 2·Σlr
  absolute, test_torch_train.py's bound (Adam's m/√v turns a grad that
  is ±tiny in one package and 0 in the other into a full ±lr step); the
  optimizer state 1e-5 norm-wise.
- on the card (marked ``gpu``): K steps through the captured graph
  against K eager steps, losses and every persistable 1e-6 relative
  (the JAX package's own ``run_steps`` pin, tests/test_run_steps.py),
  on feeds whose ids are distinct within a batch (chosen when the
  embedding grads summed by ``index_add_``'s atomics, in any order on
  repeated ids; they now sum each row's ids in a fixed order, which
  `test_embedding_grad_same_bits_on_repeated_ids` holds). Launches: the
  wrappers'
  counters exactly (a capturing call: step 1 eager and the capture's
  record of each launch; a replay runs no wrapper); a replayed call's
  profiler trace holds every kernel of K eager steps' and none more
  often (the profiler loses some records of a replay).
- uniform draws: in [min, max), the mean within 4 standard errors of
  (min + max) / 2.

Run the card's case there with
``python -m pytest --noconftest -m gpu tests/test_torch_run_steps.py``;
the JAX package is imported only inside the tests that compare with it,
as the card's machine has no JAX.
"""
import re
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.core import executor as p_executor
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops.kernels import build
from paddle_tpu_torch.ops.kernels import layer_norm as KL
from paddle_tpu_torch.ops.kernels import xent as KX

CFG = dict(seq_len=16, d_model=64, n_heads=2, n_layers=1, d_inner=128,
           vocab=256, dropout_rate=0.0, warmup_steps=100)
BATCH = 4
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch's CPU thread pool small beside the suite's other
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _feed(seed=7):
    rs = np.random.RandomState(seed)
    return {k: rs.randint(0, CFG["vocab"], (BATCH, CFG["seq_len"])).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}


@pytest.fixture(scope="module")
def pair():
    """Both packages' training programs, the JAX package's initial state
    and the port's program ready to take it."""
    import paddle_tpu as jf
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import transformer as JT

    with j_unique_name.guard():
        jmain, jstart, jcost = JT.build_program(**CFG)
    with p_unique_name.guard():
        pmain, pstart, pcost = PT.build_program(**CFG)
    jscope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(jstart, scope=jscope)
    names = [n for n, v in jstart.global_block.vars.items() if v.persistable]
    state = {n: np.asarray(jscope.find_var(n).get_tensor()) for n in names}
    return dict(jmain=jmain, jcost=jcost, pmain=pmain,
                pcost=pcost, names=names, state=state)


def _scope(pair, device="cpu"):
    sc = pf.Scope()
    pf.load_numpy_params(sc, pair["state"], torch.device(device))
    return sc


def _state(scope, names):
    return pf.scope_to_numpy(scope, names)


# ---------------------------------------------------------------------------
# run_steps against K run calls, and against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["one_dict", "list_of_dicts"])
def test_run_steps_equals_k_runs(pair, form):
    """Losses and every persistable after K steps: the same bits as K
    ``run`` calls, the step key advanced K times."""
    feeds = [_feed()] * STEPS if form == "one_dict" else \
        [_feed(s) for s in range(STEPS)]
    exe = pf.Executor(pf.CPUPlace())
    runs = _scope(pair)
    want = [exe.run(pair["pmain"], feed=f, fetch_list=[pair["pcost"]],
                    scope=runs)[0] for f in feeds]
    stepped = _scope(pair)
    if form == "one_dict":
        got = exe.run_steps(pair["pmain"], feed=feeds[0],
                            fetch_list=[pair["pcost"]], steps=STEPS,
                            scope=stepped)
    else:
        got = exe.run_steps(pair["pmain"], feed=feeds,
                            fetch_list=[pair["pcost"]], scope=stepped)
    assert exe.last_run_steps_fallback is None
    assert got[0].shape == (STEPS,) + want[0].shape
    np.testing.assert_array_equal(got[0], np.stack(want))
    if form == "one_dict":
        assert want[-1].item() < want[0].item()  # the steps train
    names = pair["names"] + [p_executor.RNG_VAR]
    a, b = _state(runs, names), _state(stepped, names)
    for n in names:
        np.testing.assert_array_equal(b[n], a[n], err_msg=n)


def test_run_steps_matches_reference(pair):
    """The port's run_steps against the JAX package's on the same
    weights and feed: losses, parameters, optimizer state."""
    import paddle_tpu as jf

    feed = _feed()
    jexe = jf.Executor(jf.CPUPlace())
    jscope = jf.Scope()
    for n, arr in pair["state"].items():
        jscope.var(n).get_tensor().set(arr)
    jl = jexe.run_steps(pair["jmain"], feed=feed, fetch_list=[pair["jcost"]],
                        steps=STEPS, scope=jscope)[0]
    assert jexe.last_run_steps_fallback is None
    pscope = _scope(pair)
    pl = pf.Executor(pf.CPUPlace()).run_steps(
        pair["pmain"], feed=feed, fetch_list=[pair["pcost"]], steps=STEPS,
        scope=pscope)[0]
    np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-5, atol=0)
    d = CFG["d_model"]
    sum_lr = sum(d ** -0.5 * min(s ** -0.5, s * CFG["warmup_steps"] ** -1.5)
                 for s in range(1, STEPS + 1))
    params = {v.name for v in pair["pmain"].all_parameters()}
    got = _state(pscope, pair["names"])
    for n in pair["names"]:
        want = np.asarray(jscope.find_var(n).get_tensor())
        if n in params:
            np.testing.assert_allclose(got[n], want, rtol=0,
                                       atol=1e-5 + 2 * sum_lr, err_msg=n)
            assert not np.array_equal(got[n], pair["state"][n]), n
        else:
            assert np.linalg.norm(got[n] - want) <= \
                1e-5 * np.linalg.norm(want), n


def test_prepare_with_steps_runs_as_run_steps(pair):
    feed = _feed()
    exe = pf.Executor(pf.CPUPlace())
    want_scope, got_scope = _scope(pair), _scope(pair)
    want = exe.run_steps(pair["pmain"], feed=feed,
                         fetch_list=[pair["pcost"]], steps=STEPS,
                         scope=want_scope)
    handle = exe.prepare(pair["pmain"], feed=feed,
                         fetch_list=[pair["pcost"]], scope=got_scope,
                         steps=STEPS)
    assert handle.fallback_reason is None
    got = handle.run(feed)
    np.testing.assert_array_equal(got[0], want[0])
    a, b = (_state(s, pair["names"]) for s in (want_scope, got_scope))
    for n in pair["names"]:
        np.testing.assert_array_equal(b[n], a[n], err_msg=n)
    with pytest.raises(ValueError, match="steps must be >= 1"):
        exe.prepare(pair["pmain"], feed=feed, steps=0)


# ---------------------------------------------------------------------------
# the contract (tests/test_run_steps.py TestRunStepsContract)
# ---------------------------------------------------------------------------
def _scale_program(scale=3.0):
    main, startup = pf.Program(), pf.Program()
    with pf.program_guard(main, startup):
        x = pf.layers.data("x", shape=[4], dtype="float32")
        out = pf.layers.scale(x, scale=scale)
    return main, out


ONES = {"x": np.ones((2, 4), np.float32)}


@pytest.mark.parametrize("feed,steps,match", [
    (ONES, None, "steps=K is required"),
    ([], None, "empty feed list"),
    (ONES, 0, "steps must be >= 1"),
    ([ONES, ONES], 3, "steps=3 but 2 feed dicts"),
    ([ONES, {"y": ONES["x"]}], None, "same variable names"),
])
def test_run_steps_contract_errors(feed, steps, match):
    main, out = _scale_program()
    with pytest.raises(ValueError, match=match):
        pf.Executor(pf.CPUPlace()).run_steps(
            main, feed=feed, fetch_list=[out], steps=steps, scope=pf.Scope())


def test_run_steps_stacked_fetch_shape_and_tensors():
    main, out = _scale_program()
    exe = pf.Executor(pf.CPUPlace())
    res = exe.run_steps(main, feed=ONES, fetch_list=[out], steps=4,
                        scope=pf.Scope())
    assert exe.last_run_steps_fallback is None
    np.testing.assert_array_equal(res[0], np.full((4, 2, 4), 3.0))
    per_step = [{"x": np.full((2, 4), k, np.float32)} for k in range(3)]
    res = exe.run_steps(main, feed=per_step, fetch_list=[out],
                        return_numpy=False, scope=pf.Scope())
    assert isinstance(res[0], torch.Tensor)
    assert res[0].device == torch.device("cpu")
    np.testing.assert_array_equal(
        res[0].numpy(), 3.0 * np.stack([f["x"] for f in per_step]))


# ---------------------------------------------------------------------------
# the program cache and program identity
# ---------------------------------------------------------------------------
def test_program_versions_and_uids():
    a, b = pf.Program(), pf.Program()
    assert a._uid != b._uid and a._version == 0
    blk = a.global_block
    x = blk.create_var(name="x", shape=(2,), dtype="float32")
    blk.append_op("scale", {"X": x}, {"Out": ["y"]}, {"scale": 2.0})
    blk.prepend_op("scale", {"X": x}, {"Out": ["z"]}, {"scale": 2.0})
    blk.insert_op(1, "scale", {"X": x}, {"Out": ["w"]}, {"scale": 2.0})
    assert [op.outputs["Out"][0] for op in blk.ops] == ["z", "w", "y"]
    assert a._version == 3
    blk._remove_op(0)
    assert a._version == 4 and len(blk.ops) == 2
    c = a.clone()
    assert c._version == 4 and c._uid != a._uid
    with p_unique_name.guard():
        main, _, _ = PT.build_program(**CFG)
    v = main._version
    assert v > 0  # the grad ops bumped it too
    assert main.clone()._version == v


def test_program_cache_hits_and_invalidates():
    main, out = _scale_program()
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    assert exe.run(main, feed=ONES, fetch_list=[out], scope=scope)[0][0, 0] \
        == 3.0
    assert exe.cache_hit_count == 0
    exe.run(main, feed=ONES, fetch_list=[out], scope=scope)
    assert exe.cache_hit_count == 1
    # another scope, fetch list or feed shape is another entry
    exe.run(main, feed=ONES, fetch_list=[out], scope=pf.Scope())
    exe.run(main, feed={"x": np.ones((3, 4), np.float32)},
            fetch_list=[out], scope=scope)
    assert exe.cache_hit_count == 1
    # an op appended after the first run: a miss that runs the new op,
    # and the older version's entries for this scope are gone
    with pf.program_guard(main):
        doubled = pf.layers.scale(out, scale=2.0)
    n = len(exe._cache)
    exe.run(main, feed=ONES, fetch_list=[out], scope=scope)
    assert exe.cache_hit_count == 1
    assert len(exe._cache) == n - 1  # two old entries out, one in
    assert all(k[1] == main._version for k in exe._cache
               if k[4] == scope._uid)
    got = exe.run(main, feed=ONES, fetch_list=[doubled], scope=scope)
    np.testing.assert_array_equal(got[0], np.full((2, 4), 6.0))
    # a scope that is gone takes its entries with it
    n = len(exe._cache)
    gone = pf.Scope()
    exe.run(main, feed=ONES, fetch_list=[out], scope=gone)
    assert len(exe._cache) == n + 1
    del gone
    assert len(exe._cache) == n


class _MetaPlace:
    """A place of another device than the host's (torch's meta device,
    where the test runs nothing)."""

    def device(self):
        return torch.device("meta")


def test_shared_cache_keeps_each_place_apart():
    """Executors sharing one program cache: another executor of the same
    place hits the entry the first made; one of another place misses and
    its entry is its own, so each runs on its own device."""
    main, out = _scale_program()
    cache, scope = {}, pf.Scope()
    cpu = pf.Executor(pf.CPUPlace(), cache=cache)
    want = cpu.run(main, feed=ONES, fetch_list=[out], scope=scope)[0]
    meta = pf.Executor(_MetaPlace(), cache=cache)
    key = meta._block_cache_key(main, p_executor._feed_specs(ONES),
                                [out.name], scope)
    assert key not in cache
    made = meta._prepared(key, scope, lambda: "the meta place's own")
    assert made == "the meta place's own" and meta.cache_hit_count == 0
    assert len(cache) == 2
    assert all(k[-1] == str(p.exe.device) for k, p in cache.items()
               if not isinstance(p, str))
    other = pf.Executor(pf.CPUPlace(), cache=cache)
    got = other.run(main, feed=ONES, fetch_list=[out], scope=scope)[0]
    assert other.cache_hit_count == 1 and len(cache) == 2
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the last-use plan
# ---------------------------------------------------------------------------
FEEDS = ("src_ids", "tgt_ids", "label")


def test_last_use_plan_matches_reference(pair):
    from paddle_tpu.core import executor as j_executor

    jp = j_executor._last_use_plan_py(pair["jmain"].global_block, FEEDS,
                                      [pair["jcost"].name])
    pp = p_executor._last_use_plan_py(pair["pmain"].global_block, FEEDS,
                                      [pair["pcost"].name])
    assert pp == jp
    assert sum(map(len, pp)) > 100  # the step's intermediates


def test_freeing_changes_no_result(pair):
    """Fetches and persistables with each value dropped after its last
    reader equal those of a run that keeps every value; what a step
    leaves in its env is only what is protected."""
    feed = _feed()
    params = [v.name for v in pair["pmain"].all_parameters()]
    fetch = [pair["pcost"].name] + [p + "@GRAD" for p in params]
    exe = pf.Executor(pf.CPUPlace())
    keep_scope, free_scope = _scope(pair), _scope(pair)
    keep = exe.prepare(pair["pmain"], feed=feed, fetch_list=fetch,
                       scope=keep_scope)
    keep.frees = [[] for _ in keep.ops]
    free = exe.prepare(pair["pmain"], feed=feed, fetch_list=fetch,
                       scope=free_scope)
    for _ in range(2):
        a, b = keep.run(feed), free.run(feed)
        for n, x, y in zip(fetch, a, b):
            np.testing.assert_array_equal(y, x, err_msg=n)
    a, b = (_state(s, pair["names"]) for s in (keep_scope, free_scope))
    for n in pair["names"]:
        np.testing.assert_array_equal(b[n], a[n], err_msg=n)
    env = exe._stage(free, feed)
    exe._step(free, env, key=0)
    block = pair["pmain"].global_block
    left = {n for n in env if not block.var(n).persistable}
    assert left == set(fetch) | set(FEEDS)


# ---------------------------------------------------------------------------
# what a CUDA graph cannot capture: named, warned, run eagerly
# ---------------------------------------------------------------------------
def _uniform_program(n_ops=1, shape=(4,), lo=-1.0, hi=1.0, seed=None):
    prog = pf.Program()
    prog.random_seed = seed
    for i in range(n_ops):
        prog.global_block.append_op(
            "uniform_random", {}, {"Out": [f"u{i}"]},
            {"shape": list(shape), "dtype": "float32", "min": lo,
             "max": hi, "seed": 0})
    return prog


def _while_program():
    """acc = x doubled while i < 3 (test_torch_ops.py's loop)."""
    main, startup = pf.Program(), pf.Program()
    L = pf.layers
    with pf.program_guard(main, startup):
        x = L.data("x", shape=[4], dtype="float32")
        two = L.fill_constant([1], "float32", 2.0)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        acc = L.assign(x)
        cond = L.less_than(i, limit)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_mul(acc, two), output=acc)
            L.increment(i, 1)
            L.less_than(i, limit, cond=cond)
    return main, acc


@pytest.mark.parametrize("kind", ["while", "uniform_random"])
def test_uncapturable_programs_name_their_reason(kind):
    if kind == "while":
        prog, out = _while_program()
        feed, fetch = {"x": np.arange(8, dtype=np.float32)
                       .reshape(2, 4)}, [out]
        want = "'while' reads its condition back to the host"
    else:
        prog, feed, fetch = _uniform_program(), {}, ["u0"]
        want = "'uniform_random' draws on a CPU generator"
    exe = pf.Executor(pf.CPUPlace())
    runs, stepped = pf.Scope(), pf.Scope()
    expect = np.stack([exe.run(prog, feed=feed, fetch_list=fetch,
                               scope=runs)[0] for _ in range(2)])
    with pytest.warns(UserWarning, match=want):
        got = exe.run_steps(prog, feed=feed, fetch_list=fetch, steps=2,
                            scope=stepped)
    assert want in exe.last_run_steps_fallback
    np.testing.assert_array_equal(got[0], expect)
    assert exe.prepare(prog, feed=feed, fetch_list=fetch, scope=stepped,
                       steps=2).fallback_reason == \
        exe.last_run_steps_fallback
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once per program
        exe.run_steps(prog, feed=feed, fetch_list=fetch, steps=2,
                      scope=stepped)


# ---------------------------------------------------------------------------
# the step key: each run draws anew
# ---------------------------------------------------------------------------
@pytest.fixture
def global_seed():
    yield
    pf.seed(0)


def test_each_run_draws_anew_in_both_packages():
    import paddle_tpu as jf

    for pkg in (jf, pf):
        prog = pkg.Program()
        prog.global_block.append_op(
            "uniform_random", {}, {"Out": ["u"]},
            {"shape": [4], "dtype": "float32", "min": -1.0, "max": 1.0,
             "seed": 0})
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        a, b = (np.asarray(exe.run(prog, fetch_list=["u"], scope=scope)[0])
                for _ in range(2))
        assert not np.array_equal(a, b), pkg.__name__


def test_seed_repeats_the_sequence(global_seed):
    prog = _uniform_program()
    exe = pf.Executor(pf.CPUPlace())

    def two_runs(s):
        pf.seed(s)
        return [exe.run(prog, fetch_list=["u0"])[0] for _ in range(2)]

    a, b, c = two_runs(5), two_runs(5), two_runs(6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], c[0])


def test_ops_and_steps_draw_apart():
    """Two ops of one program over two runs: four different draws."""
    prog = _uniform_program(n_ops=2, seed=3)
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    draws = [d for _ in range(2)
             for d in exe.run(prog, fetch_list=["u0", "u1"], scope=scope)]
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(draws[i], draws[j]), (i, j)


def test_run_steps_draws_what_k_runs_draw():
    lo, hi, k = -0.25, 0.75, 4
    prog = _uniform_program(shape=(64, 32), lo=lo, hi=hi, seed=9)
    exe = pf.Executor(pf.CPUPlace())
    runs, stepped = pf.Scope(), pf.Scope()
    want = np.stack([exe.run(prog, fetch_list=["u0"], scope=runs)[0]
                     for _ in range(k)])
    with pytest.warns(UserWarning, match="uniform_random"):
        got = exe.run_steps(prog, feed={}, fetch_list=["u0"], steps=k,
                            scope=stepped)[0]
    np.testing.assert_array_equal(got, want)
    assert len({row.tobytes() for row in got}) == k
    assert got.min() >= lo and got.max() < hi
    se = (hi - lo) / np.sqrt(12 * got.size)
    assert abs(got.mean() - (lo + hi) / 2) <= 4 * se


# ---------------------------------------------------------------------------
# on the card: K steps through the captured graph against K eager steps
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_run_steps.py`")
    return torch.device("cuda")


def _trained(vocab=CFG["vocab"]):
    """The training program and its seeded initial state."""
    with p_unique_name.guard():
        main, startup, cost = PT.build_program(**{**CFG, "vocab": vocab})
    startup.random_seed = 5
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    init = pf.Scope()
    pf.Executor(pf.CPUPlace()).run(startup, scope=init)
    return dict(state=_state(init, names), names=names, pmain=main,
                pcost=cost)


def _distinct_feed(seed, batch=BATCH, vocab=CFG["vocab"]):
    """A feed whose source and target ids are distinct within the batch:
    each embedding row's grad then has one addend."""
    rs = np.random.RandomState(seed)
    n = (batch, CFG["seq_len"])
    return {"src_ids": rs.permutation(vocab)[:np.prod(n)].reshape(n),
            "tgt_ids": rs.permutation(vocab)[:np.prod(n)].reshape(n),
            "label": rs.randint(0, vocab, n)}


def _port_kernel_launches(run):
    """`run()` under torch.profiler: the launches of each of the port's
    kernels (the __global__ functions of its CUDA sources) in the trace,
    by the kernel's full name."""
    from torch.profiler import ProfilerActivity, profile

    names = set()
    for f in build.CSRC.glob("*.cu*"):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", f.read_text()))
    port = re.compile(r"\b(" + "|".join(sorted(names)) + r")\b")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and port.search(e.name):
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _assert_close_state(got, want, names):
    for n in names:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=0,
                                   err_msg=n)


# the kernel wrappers this small model's training step reaches (its
# attention ops take the plain composition at seq 16)
WRAPPERS = (KL.layer_norm, KX.xent_forward, KX.xent_backward)


@pytest.mark.gpu
def test_embedding_grad_same_bits_on_repeated_ids(cuda):
    """lookup_table_grad on the card sums each row's repeated ids in a
    fixed order: two runs give the same bits, with 32768 lookups of 50
    rows (the bench's batch of ids, Transformer-base's width). The card's
    and the CPU's sums lie within fp32 rounding of the float64 sum: 1e-6
    of the largest sum of |addends| (about 650 addends a row, summed in
    fp32 in two orders)."""
    from paddle_tpu_torch.core import registry

    prog = pf.Program()
    blk = prog.global_block
    v, d, n = 32000, 512, 32768
    for name, shape, dtype in (("W", (v, d), "float32"),
                               ("Ids", (n, 1), "int64"),
                               ("Out@GRAD", (n, d), "float32")):
        blk.create_var(name=name, shape=shape, dtype=dtype)
    op = blk.append_op("lookup_table_grad",
                       {"W": ["W"], "Ids": ["Ids"], "Out@GRAD": ["Out@GRAD"]},
                       {"W@GRAD": ["W@GRAD"]}, {"padding_idx": -1})
    rs = np.random.RandomState(11)
    host = {"W": torch.zeros(v, d),
            "Ids": torch.from_numpy(rs.randint(0, 50, (n, 1))),
            "Out@GRAD": torch.from_numpy(rs.randn(n, d).astype(np.float32))}

    def run(device):
        env = {k: t.to(device) for k, t in host.items()}
        registry.run_op(op, env, device)
        return env["W@GRAD"]

    first, second = run(cuda), run(cuda)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    ids, dy = host["Ids"][:, 0], host["Out@GRAD"].double()
    exact = torch.zeros(v, d, dtype=torch.float64).index_add_(0, ids, dy)
    scale = float(torch.zeros(v, d, dtype=torch.float64).index_add_(
        0, ids, dy.abs()).max())
    for got in (first.cpu(), run(torch.device("cpu"))):
        assert float((got.double() - exact).abs().max()) <= 1e-6 * scale


@pytest.mark.gpu
def test_captured_steps_match_eager_steps(cuda):
    """Two run_steps calls of K steps each (per-step batches), the first
    capturing, against 2K eager steps from the same weights: losses and
    persistables within 1e-6 relative. The capturing call moves each
    wrapper's counter by two steps' launches (step 1 and the capture),
    the second call captures nothing and moves no counter, and its trace
    holds every kernel of K eager steps', none more often."""
    pair = _trained()
    names = pair["names"]
    feeds = [_distinct_feed(s) for s in range(2 * STEPS)]
    fetch = [pair["pcost"]]
    exe = pf.Executor(pf.CUDAPlace(0))
    eager_scope, graph_scope = _scope(pair, cuda), _scope(pair, cuda)
    eager = []
    for w in WRAPPERS:
        w.launches = 0
    per_k = _port_kernel_launches(lambda: eager.extend(
        exe.run(pair["pmain"], feed=f, fetch_list=fetch,
                scope=eager_scope)[0] for f in feeds))
    per_step = {w.__name__: w.launches // len(feeds) for w in WRAPPERS}
    assert all(w.launches == per_step[w.__name__] * len(feeds)
               for w in WRAPPERS)
    assert per_step["layer_norm"] > 0 and per_step["xent_forward"] == 1
    assert all(c % 2 == 0 for c in per_k.values()), per_k
    per_k = {n: c // 2 for n, c in per_k.items()}
    assert any("ln_fwd" in n for n in per_k), per_k
    assert any("xent_bwd" in n for n in per_k), per_k
    for w in WRAPPERS:
        w.launches = 0

    def call(i):
        out = exe.run_steps(pair["pmain"], feed=feeds[i * STEPS:
                                                      (i + 1) * STEPS],
                            fetch_list=fetch, scope=graph_scope)[0]
        assert exe.last_run_steps_fallback is None
        assert exe.compile_count == 1  # the second call captures nothing
        assert {w.__name__: w.launches for w in WRAPPERS} == {
            n: 2 * c for n, c in per_step.items()}
        return out

    got = [call(0)]
    replayed = _port_kernel_launches(lambda: got.append(call(1)))
    assert set(replayed) == set(per_k)
    assert all(0 < replayed[n] <= per_k[n] for n in per_k), (replayed,
                                                              per_k)
    got = np.concatenate(got)
    np.testing.assert_allclose(got, np.stack(eager), rtol=1e-6, atol=0)
    a, b = _state(eager_scope, names), _state(graph_scope, names)
    _assert_close_state(b, a, names)
    print("captured losses bit-identical to eager:",
          np.array_equal(got, np.stack(eager)), "; persistables:",
          all(np.array_equal(b[n], a[n]) for n in names),
          "; trace records a replay lost:",
          {n: per_k[n] - replayed[n] for n in per_k})


@pytest.mark.gpu
def test_captures_share_a_pool_and_a_program_keeps_one(cuda):
    """One scope fed batch 384, then 256, then 384 and 256 again (vocab
    8192, so that the ids of a batch can be distinct): each new
    shape drops the program's older captured step and captures again in
    the shared pool, so the second capture grows the reserved memory by
    less than half of what the first did; then a second scope's capture
    lives beside the first, and the two replay in turn. Every loss and
    persistable within 1e-6 relative of eager steps fed the same."""
    vocab = 8192
    pair = _trained(vocab)
    names, fetch = pair["names"], [pair["pcost"]]
    big = [_distinct_feed(s, 384, vocab) for s in range(STEPS)]
    small = [_distinct_feed(s + 10, 256, vocab) for s in range(STEPS)]
    calls = [(0, big), (0, small), (0, big), (0, small), (1, small),
             (0, small), (1, small)]
    exe = pf.Executor(pf.CUDAPlace(0))
    graph = [_scope(pair, cuda), _scope(pair, cuda)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = [torch.cuda.memory_reserved()]
    got = []
    for n, (i, feeds) in enumerate(calls):
        got.append(exe.run_steps(pair["pmain"], feed=feeds,
                                 fetch_list=fetch, scope=graph[i])[0])
        assert exe.compile_count == min(n + 1, 5)
        live = sum(p.captured is not None for p in exe._cache.values())
        assert live == (1 if n < 4 else 2)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    grown = np.diff(reserved[:3])
    print("reserved memory grown by the first two captures (MiB):",
          grown / 2 ** 20)
    assert grown[1] < grown[0] / 2, grown
    ref = pf.Executor(pf.CUDAPlace(0))
    eager = [_scope(pair, cuda), _scope(pair, cuda)]
    for (i, feeds), losses in zip(calls, got):
        want = [ref.run(pair["pmain"], feed=f, fetch_list=fetch,
                        scope=eager[i])[0] for f in feeds]
        np.testing.assert_allclose(losses, np.stack(want), rtol=1e-6,
                                   atol=0)
    for g, e in zip(graph, eager):
        _assert_close_state(_state(g, names), _state(e, names), names)


@pytest.mark.gpu
def test_shared_cache_runs_each_place_on_its_device(cuda):
    """A CPU executor and a card executor sharing one program cache, on
    one program and scope: each call runs on its own executor's device,
    and each executor's second call hits its own entry."""
    main, out = _scale_program()
    cache, scope = {}, pf.Scope()
    exes = (pf.Executor(pf.CPUPlace(), cache=cache),
            pf.Executor(pf.CUDAPlace(0), cache=cache))
    for _ in range(2):
        for exe in exes:
            got, = exe.run(main, feed=ONES, fetch_list=[out], scope=scope,
                           return_numpy=False)
            assert got.device.type == exe.device.type
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          np.full((2, 4), 3.0))
    assert [e.cache_hit_count for e in exes] == [1, 1] and len(cache) == 2


@pytest.mark.gpu
def test_captured_dropout_steps_match_eager_steps(cuda):
    """The training program at dropout 0.1 is captured (no eager
    reason): K captured steps draw the masks K eager steps draw, since
    the graph advances its device step key with the host's arithmetic;
    losses and persistables within 1e-6 relative of eager (bit-identical
    where no atomics reorder a sum), two replayed calls differ from each
    other (each replay draws anew), and the losses differ from the
    dropout-0 program's."""
    cfg = {**CFG, "dropout_rate": 0.1}
    with p_unique_name.guard():
        main, startup, cost = PT.build_program(**cfg)
    startup.random_seed = 5
    main.random_seed = 9
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    init = pf.Scope()
    pf.Executor(pf.CPUPlace()).run(startup, scope=init)
    pair = dict(state=_state(init, names))
    feed = _distinct_feed(3)
    exe = pf.Executor(pf.CUDAPlace(0))
    eager_scope, graph_scope = _scope(pair, cuda), _scope(pair, cuda)
    eager = [exe.run(main, feed=feed, fetch_list=[cost],
                     scope=eager_scope)[0] for _ in range(2 * STEPS)]
    got = [exe.run_steps(main, feed=feed, fetch_list=[cost], steps=STEPS,
                         scope=graph_scope)[0] for _ in range(2)]
    assert exe.last_run_steps_fallback is None
    assert exe.compile_count == 1
    got = np.concatenate(got)
    np.testing.assert_allclose(got, np.stack(eager), rtol=1e-6, atol=0)
    _assert_close_state(_state(graph_scope, names),
                        _state(eager_scope, names), names)
    assert not np.array_equal(got[:STEPS], got[STEPS:])
    plain = _trained()
    base = exe.run(plain["pmain"], feed=feed, fetch_list=[plain["pcost"]],
                   scope=_scope(plain, cuda))[0]
    assert not np.allclose(base, got[0], rtol=1e-6, atol=0)
    print("captured dropout losses bit-identical to eager:",
          np.array_equal(got, np.stack(eager)))


@pytest.mark.gpu
def test_amp_fused_blocks_launch_on_the_card(cuda, monkeypatch):
    """Built with PADDLE_TPU_FUSE_ATTN_BLOCK=1, the attention_block and
    ffn_block ops launch their kernels (#10-#13) in fp32 and, under AMP,
    with bf16 inputs (their bf16 instances); under AMP K captured steps
    match K eager steps within 1e-6."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.ops.kernels import attention_block as KAB
    from paddle_tpu_torch.ops.kernels import ffn_block as KFF

    monkeypatch.setenv("PADDLE_TPU_FUSE_ATTN_BLOCK", "1")
    with p_unique_name.guard():
        main, startup, cost = PT.build_program(**CFG)
    types = [op.type for op in main.global_block.ops]
    assert "attention_block" in types and "ffn_block" in types
    startup.random_seed = 5
    exe = pf.Executor(pf.CUDAPlace(0))
    feed = _distinct_feed(4)
    kern = (KAB.attention_block, KAB.attention_block_bwd, KFF.ffn_block,
            KFF.ffn_block_bwd)
    for on in (False, True):
        scope = pf.Scope()
        exe.run(startup, scope=scope)
        before = [k.launches for k in kern]
        with amp.amp_guard(on):
            loss = exe.run(main, feed=feed, fetch_list=[cost],
                           scope=scope)[0]
        assert np.isfinite(loss).all()
        moved = [k.launches - b for k, b in zip(kern, before)]
        assert all(m > 0 for m in moved), moved
    init = pf.Scope()
    exe.run(startup, scope=init)
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    pair = dict(state=_state(init, names))
    eager_scope, graph_scope = _scope(pair, cuda), _scope(pair, cuda)
    with amp.amp_guard(True):
        eager = [exe.run(main, feed=feed, fetch_list=[cost],
                         scope=eager_scope)[0] for _ in range(STEPS)]
        got = exe.run_steps(main, feed=feed, fetch_list=[cost],
                            steps=STEPS, scope=graph_scope)[0]
    assert exe.last_run_steps_fallback is None
    np.testing.assert_allclose(got, np.stack(eager), rtol=1e-6, atol=0)
