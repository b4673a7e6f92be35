"""The port's core: package isolation, the Executor's place rules, and
the incremental decode Program built by both packages.

The JAX package (paddle_tpu) is the reference; paddle_tpu_torch must
build the same Program (op types, io names, attrs, var shapes) from
the same layers calls.
"""
import os
import subprocess
import sys

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.models import decode_engine as PD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(seq_len=8, max_out_len=6, d_model=128, n_heads=2,
             n_layers=2, d_inner=256, vocab=256, start_id=0, end_id=1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small so these tests do not crowd the
    timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_port_imports_no_jax_and_nothing_of_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch\n"
        "import paddle_tpu_torch.inference.serving\n"
        "import paddle_tpu_torch.models.decode_engine\n"
        "import paddle_tpu_torch.ops.kernels.build\n"
        "import paddle_tpu_torch.ops.kernels.xent\n"
        "import paddle_tpu_torch.ops.kernels.attention_block\n"
        "import paddle_tpu_torch.ops.kernels.ffn_block\n"
        "import paddle_tpu_torch.ops.optimizer_ops\n"
        "import paddle_tpu_torch.backward\n"
        "import paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.layers.learning_rate_scheduler\n"
        "import paddle_tpu_torch.models.transformer\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'paddle_tpu' or m.startswith('paddle_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_executor_without_a_card_raises_and_names_cpuplace(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        pf.Executor()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        pf.Executor(pf.CUDAPlace(0))


def test_run_before_startup_and_bad_feed_are_named():
    main, startup = pf.Program(), pf.Program()
    with pf.program_guard(main, startup):
        x = pf.layers.data("x", shape=[4], dtype="float32")
        y = pf.layers.fc(x, 3)
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    feed = {"x": np.ones((2, 4), "float32")}
    with pytest.raises(RuntimeError, match="used before initialization"):
        exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="program declares"):
        exe.run(main, feed={"x": np.ones((2, 5), "float32")},
                fetch_list=[y], scope=scope)
    with pytest.raises(KeyError, match="does not exist"):
        exe.run(main, feed=feed, fetch_list=["nope"], scope=scope)
    out, = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    assert out.shape == (2, 3)


def _build_both():
    with j_unique_name.guard():
        jprog = JT.build_incremental_decode_program(**SMALL)
    with p_unique_name.guard():
        pprog = PD.build_incremental_decode_program(**SMALL)
    return jprog, pprog


def _norm_attr(v):
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.kind, v.shape, v.tolist())
    if hasattr(v, "ops") and hasattr(v, "idx"):  # a sub-Block
        return ("block", v.idx)
    if isinstance(v, (list, tuple)):
        return [_norm_attr(x) for x in v]
    return v


def _norm_dtype(dt):
    # JAX without x64 truncates int64 vars to int32; compare the kind
    s = getattr(dt, "value", str(dt))
    return {"int32": "int", "int64": "int"}.get(s, s)


def test_incremental_decode_program_matches_paddle_tpu():
    (jmain, jstart, jfeeds, jout), (pmain, pstart, pfeeds, pout) = \
        _build_both()
    assert jfeeds == pfeeds and jout.name == pout.name
    for jp, pp in ((jmain, pmain), (jstart, pstart)):
        assert len(jp.blocks) == len(pp.blocks)
        for jb, pb in zip(jp.blocks, pp.blocks):
            assert [op.type for op in jb.ops] == [op.type for op in pb.ops]
            for jo, po in zip(jb.ops, pb.ops):
                assert jo.inputs == po.inputs, jo.type
                assert jo.outputs == po.outputs, jo.type
                ja = {k: _norm_attr(v) for k, v in jo.attrs.items()}
                pa = {k: _norm_attr(v) for k, v in po.attrs.items()}
                assert ja == pa, jo.type
            assert sorted(jb.vars) == sorted(pb.vars)
            for name, jv in jb.vars.items():
                pv = pb.vars[name]
                assert jv.shape == pv.shape, name
                assert jv.persistable == pv.persistable, name
                assert _norm_dtype(jv.dtype) == _norm_dtype(pv.dtype), name


def test_startup_initializes_every_parameter_deterministically():
    _, (pmain, pstart, _, _) = _build_both()
    params = [v.name for v in pstart.global_block.vars.values()
              if v.persistable]
    # 53 persistables at L=2: every one explicitly named
    assert len(params) == 53
    exe = pf.Executor(pf.CPUPlace())
    s1, s2 = pf.Scope(), pf.Scope()
    exe.run(pstart, scope=s1)
    exe.run(pstart, scope=s2)
    a = pf.scope_to_numpy(s1, params)
    b = pf.scope_to_numpy(s2, params)
    for n in params:
        np.testing.assert_array_equal(a[n], b[n])
        shape = tuple(pstart.global_block.vars[n].shape)
        assert a[n].shape == shape
    w = a["dec0_self_qkv.w"]
    limit = np.sqrt(6.0 / (128 + 128))  # explicit Xavier fans
    assert np.abs(w).max() <= limit and w.std() > limit / 3
    np.testing.assert_array_equal(a["enc0_a_ln.w"], 1.0)
    np.testing.assert_array_equal(a["enc0_fc1.b"], 0.0)


# ---------------------------------------------------------------------------
# the reference's Executor, Place and Scope signatures (C16)
# ---------------------------------------------------------------------------
def _fc_program(pkg):
    """x [B, 4] -> fc 3, its parameters fc_0.w_0 and fc_0.b_0."""
    main, startup = pkg.Program(), pkg.Program()
    with (j_unique_name if pkg is jf else p_unique_name).guard():
        with pkg.program_guard(main, startup):
            x = pkg.layers.data("x", shape=[4], dtype="float32")
            y = pkg.layers.fc(x, 3)
    return main, startup, y


def test_executor_run_takes_the_reference_parameters_in_order():
    """exe.run(prog, feed, fetch, "feed", "fetch", scope): the positional
    call of the JAX package's signature, in both packages, gives the same
    output; the scope given is the one read."""
    feed = {"x": np.arange(8, dtype="float32").reshape(2, 4)}
    outs = []
    for pkg in (jf, pf):
        main, startup, y = _fc_program(pkg)
        scope = pkg.Scope()
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(startup, None, None, "feed", "fetch", scope)
        state = {"fc_0.w_0": np.full((4, 3), 0.5, "float32"),
                 "fc_0.b_0": np.array([1.0, 2.0, 3.0], "float32")}
        if pkg is pf:
            pf.load_numpy_params(scope, state, torch.device("cpu"))
        else:
            for n, v in state.items():
                scope.var(n)
                scope._set(n, v)
        out, = exe.run(main, feed, [y], "feed", "fetch", scope, True, True)
        outs.append(out)
    np.testing.assert_array_equal(outs[1], outs[0])


def test_use_program_cache_false_prepares_anew():
    """Without the program cache every call prepares its own program and
    nothing is kept: cache_hit_count stays 0 and the cache stays empty,
    for run and for run_steps; with it the second call hits."""
    main, startup, y = _fc_program(pf)
    scope = pf.Scope()
    exe = pf.Executor(pf.CPUPlace())
    exe.run(startup, scope=scope, use_program_cache=False)
    feed = {"x": np.ones((2, 4), "float32")}
    for _ in range(2):
        a, = exe.run(main, feed=feed, fetch_list=[y], scope=scope,
                     use_program_cache=False)
        s, = exe.run_steps(main, feed=feed, fetch_list=[y], steps=2,
                           scope=scope, use_program_cache=False)
    assert exe.cache_hit_count == 0 and not exe._cache
    for _ in range(2):
        b, = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    assert exe.cache_hit_count == 1
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(s[1], a)


def test_executor_constructor_place_and_scope_parent():
    """Executor(place, donate, cache), CPUPlace(device_id) and
    Scope(parent) as the JAX package takes them: a shared cache serves a
    second executor; a child scope reads its parent's names and writes a
    name where it is found."""
    cache = {}
    main, startup, y = _fc_program(pf)
    parent = pf.Scope()
    exe = pf.Executor(pf.CPUPlace(0), False, cache)
    exe.run(startup, scope=parent)
    kid = pf.Scope(parent)
    assert parent._get("fc_0.w_0") is not None
    assert kid._get("fc_0.w_0") is parent._get("fc_0.w_0")
    feed = {"x": np.ones((2, 4), "float32")}
    a, = exe.run(main, feed=feed, fetch_list=[y], scope=kid)
    exe2 = pf.Executor(pf.CPUPlace(), donate=True, cache=cache)
    b, = exe2.run(main, feed=feed, fetch_list=[y], scope=kid)
    assert exe2.cache_hit_count == 1
    np.testing.assert_array_equal(a, b)
    assert "fc_0.w_0" not in kid._vars and "fc_0.w_0" in parent._vars
    kid._set("fc_0.w_0", torch.zeros(4, 3))
    assert float(parent._get("fc_0.w_0").abs().sum()) == 0.0
    kid._set("only_here", torch.ones(1))
    assert parent._get("only_here") is None
