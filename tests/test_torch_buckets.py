"""Sequence buckets, the group-selection hook and AOT warm-up of the
port's InferenceServer on the CPU, each case of the JAX package's
tests/test_serving.py (aot_warmup seeding every bucket, sequence
bucketing bounding the shapes, the select_group hook ordering dispatch)
run through both packages' servers: the outputs agree within 1e-6
relative, and aot_warmup builds as many programs as the JAX package
compiles (the port counts PreparedProgram builds,
``Executor.prepare_count``).
"""
import warnings

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu.inference import serving as JS
from paddle_tpu_torch.inference import serving as PS

import torch_predictor_setup as S

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    jtest, _, name, w = S.mnist_pair()
    d = str(tmp_path_factory.mktemp("mnist"))
    S.jax_save(d, jtest, name, w, feeds=["img"])
    return d


def _scale_runners(scale):
    """The JAX test's program in both packages: x declared [-1, -1, 4],
    out = scale * x, each in a ProgramRunner on the CPU."""
    out = []
    for fl, serving in ((jf, JS), (pf, PS)):
        prog, startup = fl.Program(), fl.Program()
        with fl.program_guard(prog, startup):
            x = fl.layers.data("x", shape=[-1, 4], dtype="float32")
            y = fl.layers.scale(x, scale=scale)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        exe.run(startup, scope=scope)
        out.append(serving.ProgramRunner(prog, ["x"], [y.name],
                                         executor=exe, scope=scope))
    return out


def test_aot_warmup_seeds_every_bucket(mnist_dir):
    """After aot_warmup, traffic of mixed row counts builds nothing in
    either package, and both serve the same rows."""
    jpred = S.j_predictor(mnist_dir)
    ppred = S.p_predictor(mnist_dir)
    rng = np.random.RandomState(1)
    reqs = [rng.randn(rows, 784).astype(np.float32)
            for rows in (1, 2, 3, 5, 8, 4, 7, 1)]
    got = {}
    for tag, pred, server, built in (
            ("jax", jpred, JS.InferenceServer,
             lambda e: e.compile_count),
            ("port", ppred, PS.InferenceServer,
             lambda e: e.prepare_count)):
        with server(pred, max_batch_size=8, max_wait_ms=1.0) as srv:
            warmed = srv.aot_warmup()
            assert warmed == len(srv.batch_buckets) == 4, (tag, warmed)
            exe = pred._exe
            before = built(exe)
            got[tag] = [srv.infer({"img": a}, timeout=60.0)[0]
                        for a in reqs]
            assert built(exe) == before, tag  # every bucket was warm
            assert exe.cache_hit_count > 0 or tag == "port"
            assert srv.stats()["warmed_compiles"] == 4
    for a, b in zip(got["jax"], got["port"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-6)


def test_seq_bucketing_bounds_shapes():
    """Declared -1 sequence dims pad up the ladder; outputs come back at
    the padded length and the real positions match the unpadded values;
    a bucket pair builds one program in either package."""
    jrun, prun = _scale_runners(3.0)
    r = np.random.RandomState(2)
    a3 = r.randn(1, 3, 4).astype(np.float32)   # T=3 -> 4
    a5 = r.randn(2, 5, 4).astype(np.float32)   # T=5 -> 8
    outs = {}
    p0 = prun.executor.prepare_count  # the startup's build
    for tag, runner, server in (("jax", jrun, JS.InferenceServer),
                                ("port", prun, PS.InferenceServer)):
        with server(runner, max_batch_size=4, max_wait_ms=2.0,
                    seq_buckets=(4, 8)) as srv:
            o3 = srv.infer({"x": a3}, timeout=60.0)[0]
            o5 = srv.infer({"x": a5}, timeout=60.0)[0]
        assert o3.shape == (1, 4, 4) and o5.shape == (2, 8, 4), tag
        np.testing.assert_allclose(o3[:, :3], a3 * 3.0, rtol=RTOL)
        np.testing.assert_allclose(o5[:, :5], a5 * 3.0, rtol=RTOL)
        assert not o3[:, 3:].any() and not o5[:, 5:].any()
        outs[tag] = (o3, o5)
    assert jrun.executor.compile_count <= 2 * 3
    # the (4, 1) and (8, 2) pairs
    assert prun.executor.prepare_count - p0 == 2
    for j, p in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(p, j, rtol=RTOL)


def test_seq_bucketed_warmup_counts_match():
    """aot_warmup over a sequence ladder: one program a (sequence bucket,
    batch bucket) pair in both packages, and none for later traffic."""
    jrun, prun = _scale_runners(2.0)
    r = np.random.RandomState(3)
    reqs = [r.randn(rows, t, 4).astype(np.float32)
            for rows, t in ((1, 3), (2, 7), (4, 8), (3, 2), (1, 5))]
    counts, got = {}, {}
    for tag, runner, server, built in (
            ("jax", jrun, JS.InferenceServer, lambda e: e.compile_count),
            ("port", prun, PS.InferenceServer,
             lambda e: e.prepare_count)):
        with server(runner, max_batch_size=4, max_wait_ms=1.0,
                    seq_buckets=(4, 8)) as srv:
            counts[tag] = srv.aot_warmup()
            before = built(runner.executor)
            got[tag] = [srv.infer({"x": a}, timeout=60.0)[0]
                        for a in reqs]
            assert built(runner.executor) == before, tag
    assert counts["port"] == counts["jax"] == 2 * 3
    for j, p in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(p, j, rtol=RTOL)


def test_warmup_needs_the_ladder():
    """A program with -1 sequence dims cannot be warmed without
    seq_buckets, in either package."""
    jrun, prun = _scale_runners(1.0)
    for runner, server in ((jrun, JS.InferenceServer),
                           (prun, PS.InferenceServer)):
        srv = server(runner, max_batch_size=2, start=False)
        with pytest.raises(ValueError, match="seq_buckets"):
            srv.aot_warmup()
        srv.close()


def test_sequence_past_the_ladder_is_refused():
    jrun, prun = _scale_runners(1.0)
    for runner, server in ((jrun, JS.InferenceServer),
                           (prun, PS.InferenceServer)):
        srv = server(runner, max_batch_size=2, seq_buckets=(4,),
                     start=False)
        with pytest.raises(ValueError, match="largest bucket"):
            srv.submit({"x": np.zeros((1, 5, 4), np.float32)})
        srv.close()


def _select_group_order(runner, server, hook):
    srv = server(runner, max_batch_size=4, max_wait_ms=200.0,
                 seq_buckets=(4, 8), select_group=hook, start=False)
    r = np.random.RandomState(7)
    rep_short = srv.submit({"x": r.randn(1, 3, 4).astype(np.float32)})
    rep_long = srv.submit({"x": r.randn(1, 7, 4).astype(np.float32)})
    done = []
    rep_short.add_done_callback(lambda f: done.append("s"))
    rep_long.add_done_callback(lambda f: done.append("l"))
    srv.start()
    outs = (rep_short.result(60.0)[0], rep_long.result(60.0)[0])
    srv.close()
    return done, outs


def test_select_group_hook_orders_dispatch():
    """With two shape groups queued, a hook preferring the later group's
    longer bucket gets it dispatched first, in both packages."""
    jrun, prun = _scale_runners(2.0)

    def prefer_longest(groups):
        return max(groups, key=lambda k: k[0][1])

    jdone, jouts = _select_group_order(jrun, JS.InferenceServer,
                                       prefer_longest)
    pdone, pouts = _select_group_order(prun, PS.InferenceServer,
                                       prefer_longest)
    assert pdone == jdone == ["l", "s"], (pdone, jdone)
    for j, p in zip(jouts, pouts):
        np.testing.assert_allclose(p, j, rtol=RTOL)


def test_select_group_failure_warns_once_then_oldest_first():
    """A hook that raises warns once a server and falls back to
    oldest-request-first, as the JAX package's does; a hook returning
    a key that is not queued declines silently."""
    jrun, prun = _scale_runners(2.0)

    def broken(groups):
        raise RuntimeError("hook bug")

    for runner, server in ((jrun, JS.InferenceServer),
                           (prun, PS.InferenceServer)):
        with pytest.warns(UserWarning, match="select_group hook failed"):
            done, _ = _select_group_order(runner, server, broken)
        assert done == ["s", "l"]
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            done, _ = _select_group_order(runner, server,
                                          lambda groups: "no such key")
        assert done == ["s", "l"]
