"""The IR passes of the port against the JAX package's on the CPU: for
each of the nine registered passes, the same program rewritten by both
packages gives the same ``to_dict`` and, where a pass folds parameter
values into the scope (conv_bn_fuse), the same values within 1e-6. The
conv programs are built by the JAX package (the port has no conv op yet)
and read into the port through ``Program.from_dict``; they are not run.
Also the ``fc`` op the fc pass writes, through the port's OpTest, and
the rewritten programs run against the unrewritten ones.
"""
import json

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import ir as j_ir
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import compile_cache as j_cc
from paddle_tpu_torch import ir as p_ir
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.core import program as p_program

import torch_predictor_setup as S
from torch_op_test import op_case

FOLD_TOL = 1e-6
PASSES = ["dropout_eliminate_pass", "conv_bn_fuse_pass", "fc_fuse_pass",
          "attention_fuse_pass", "identity_elimination_pass",
          "conv_relu_fuse_pass", "conv_eltwiseadd_fuse_pass",
          "fuse_sgd_op_pass", "fuse_adam_op_pass"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _norm(d):
    return json.loads(json.dumps(d, sort_keys=True, default=j_cc._canon))


def test_registry_holds_the_reference_passes():
    assert sorted(p_ir.PassRegistry._passes) == sorted(PASSES)
    assert sorted(j_ir.PassRegistry._passes) == sorted(PASSES)
    with pytest.raises(KeyError):
        p_ir.get_pass("nope_pass")


# --- programs built the same way in both packages ---------------------------
def _dropout_net(m, impl, fetch_dropout):
    x = m.layers.data("x", shape=[8], dtype="float32")
    h = m.layers.fc(x, 6, act="relu")
    d = m.layers.dropout(h, 0.3, is_test=True, dropout_implementation=impl)
    out = d if fetch_dropout else m.layers.fc(d, 3)
    return [out.name]


def _fc_net(m):
    x = m.layers.data("x", shape=[8], dtype="float32")
    h = m.layers.fc(x, 4, act="relu")
    return [m.layers.fc(h, 2).name]


def _fc_3d(m):
    x = m.layers.data("x", shape=[5, 8], dtype="float32")
    return [m.layers.fc(x, 4, num_flatten_dims=2, act="relu").name]


def _residual(m):
    x = m.layers.data("x", shape=[8], dtype="float32")
    h = m.layers.fc(x, 8, bias_attr=False)
    return [m.layers.elementwise_add(h, x).name]


def _attention(m, dropout):
    q, k, v = (m.layers.data(n, shape=[2, 6, 4], dtype="float32")
               for n in ("q", "k", "v"))
    s = m.layers.matmul(q, k, transpose_y=True, alpha=0.5)
    s = m.layers.scale(s, scale=0.25)
    p = m.layers.softmax(s)
    if dropout:
        p = m.layers.dropout(p, 0.1, is_test=True,
                             dropout_implementation="upscale_in_train")
    return [m.layers.matmul(p, v).name]


def _identities(m):
    x = m.layers.data("x", shape=[4], dtype="float32")
    a = m.layers.scale(x, scale=1.0)
    b = m.layers.cast(a, "float32")
    c = m.layers.assign(b)
    return [m.layers.relu(c).name, m.layers.scale(c, scale=2.0).name]


def _optimizer_net(m, opt):
    x = m.layers.data("x", shape=[8], dtype="float32")
    h = m.layers.fc(x, 6, act="relu")
    loss = m.layers.mean(m.layers.fc(h, 3))
    opt(m).minimize(loss)
    return [loss.name]


BUILDS = {
    "dropout_eliminate_pass": [
        ("upscale", lambda m: _dropout_net(m, "upscale_in_train", False)),
        ("upscale_fetched",
         lambda m: _dropout_net(m, "upscale_in_train", True)),
        ("downgrade", lambda m: _dropout_net(m, "downgrade_in_infer",
                                             False))],
    "fc_fuse_pass": [("fc_net", _fc_net), ("fc_3d", _fc_3d),
                     ("residual", _residual)],
    "attention_fuse_pass": [("plain", lambda m: _attention(m, False)),
                            ("dropout", lambda m: _attention(m, True))],
    "identity_elimination_pass": [("identities", _identities)],
    "fuse_sgd_op_pass": [("sgd", lambda m: _optimizer_net(
        m, lambda m: m.optimizer.SGD(learning_rate=0.1)))],
    "fuse_adam_op_pass": [("adam", lambda m: _optimizer_net(
        m, lambda m: m.optimizer.Adam(learning_rate=0.01)))],
}
CASES = [(p, tag, fn) for p, cases in BUILDS.items() for tag, fn in cases]


def _built(m, guard, build, pass_name, protected_fetch=True):
    """`build` in package `m`, then `pass_name` applied, both under one
    unique-name guard (the optimizer fusions name their new vars):
    (program before, program after, fetch names)."""
    with guard():
        main, startup = m.Program(), m.Program()
        with m.program_guard(main, startup):
            fetch = build(m)
        before = main.clone()
        m.ir.apply_passes(main, [pass_name],
                          protected=fetch if protected_fetch else ())
    return before, main, startup, fetch


@pytest.mark.parametrize("pass_name,tag,build", CASES,
                         ids=[f"{p}-{t}" for p, t, _ in CASES])
def test_pass_rewrites_as_the_reference(pass_name, tag, build):
    jb, ja, _, _ = _built(jf, j_unique_name.guard, build, pass_name)
    pb, pa, _, _ = _built(pf, p_unique_name.guard, build, pass_name)
    assert _norm(pb.to_dict()) == _norm(jb.to_dict())
    assert _norm(pa.to_dict()) == _norm(ja.to_dict())
    assert pa._version > pb._version
    if tag in ("residual",):
        assert [o.type for o in pa.global_block.ops] == \
            [o.type for o in pb.global_block.ops]
    else:
        assert len(pa.global_block.ops) != len(pb.global_block.ops) or \
            pass_name == "dropout_eliminate_pass"


@pytest.mark.parametrize("build,feed_shape", [
    (_fc_net, (3, 8)), (_fc_3d, (3, 5, 8)),
    (lambda m: _dropout_net(m, "downgrade_in_infer", False), (3, 8)),
    (lambda m: _attention(m, True), None), (_identities, (3, 4))],
    ids=["fc_net", "fc_3d", "dropout_downgrade", "attention", "identities"])
def test_rewritten_program_runs_as_before(build, feed_shape):
    """The port's rewritten program gives the fetches of the program it
    was rewritten from (the fc pass on 3-D input keeps the rank)."""
    with p_unique_name.guard():
        main, startup = pf.Program(), pf.Program()
        with pf.program_guard(main, startup):
            fetch = build(pf)
    startup.random_seed = 3
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(0)
    feed = ({n: rs.randn(3, 2, 6, 4).astype("float32")
             for n in ("q", "k", "v")} if feed_shape is None
            else {"x": rs.randn(*feed_shape).astype("float32")})
    want = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    test = main.clone(for_test=True)
    p_ir.apply_passes(test, PASSES, scope=scope, protected=fetch)
    got = exe.run(test, feed=feed, fetch_list=fetch, scope=scope)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_transformer_passes_as_the_reference():
    """The predictor's default pipeline on the exported Transformer:
    dropout gone, each FFN's mul + add (+ relu) an fc, as in the JAX
    package."""
    jtest, ptest, name, _ = S.transformer_pair(40)
    jp, pp = jtest._prune([name]), ptest._prune([name])
    from paddle_tpu_torch.inference.config import TPU_PASSES
    n0 = len(pp.global_block.ops)
    j_ir.apply_passes(jp, TPU_PASSES, protected={name})
    p_ir.apply_passes(pp, TPU_PASSES, protected={name})
    assert _norm(pp.to_dict()) == _norm(jp.to_dict())
    types = [o.type for o in pp.global_block.ops]
    assert "dropout" not in types
    n_ffn = 2 * S.SMALL["n_layers"]
    assert types.count("fc") == 2 * n_ffn
    # each FFN's mul + add + relu and mul + add became two fc ops, and
    # every dropout went
    assert n0 - len(types) == 3 * n_ffn + _dropouts(ptest, name)
    assert pp.fingerprint() == jp.fingerprint()


def _dropouts(program, fetch):
    return [o.type for o in program._prune([fetch]).global_block.ops
            ].count("dropout")


# --- the conv passes: JAX-built programs read through from_dict ------------
def _conv_program(kind):
    with j_unique_name.guard():
        main, startup = jf.Program(), jf.Program()
        with jf.program_guard(main, startup):
            x = jf.layers.data("img", shape=[3, 6, 6], dtype="float32")
            if kind == "bn_bias":
                y = jf.layers.conv2d(x, 4, 3, padding=1)
                y = jf.layers.batch_norm(y, is_test=True)
            elif kind == "bn":
                y = jf.layers.conv2d(x, 4, 3, padding=1, bias_attr=False)
                y = jf.layers.batch_norm(y, is_test=True)
            elif kind == "relu":
                y = jf.layers.relu(jf.layers.conv2d(x, 4, 3, padding=1))
            else:  # residual
                r = jf.layers.data("res", shape=[4, 6, 6], dtype="float32")
                y = jf.layers.elementwise_add(
                    jf.layers.conv2d(x, 4, 3, padding=1, bias_attr=False), r)
            out = jf.layers.mean(y)
    startup.random_seed = 5
    scope = jf.Scope()
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    rs = np.random.RandomState(1)
    vals = {}
    for n, v in startup.global_block.vars.items():
        if v.persistable:
            a = np.asarray(scope._get(n))
            # biases, scales and running stats away from their initial
            # 0 and 1 (a variance stays positive)
            if a.ndim == 1:
                a = (a + rs.uniform(0.2, 1.0, a.shape)).astype(a.dtype)
            vals[n] = a
    return main, out.name, vals


@pytest.mark.parametrize("kind,pass_name", [
    ("bn_bias", "conv_bn_fuse_pass"), ("bn", "conv_bn_fuse_pass"),
    ("relu", "conv_relu_fuse_pass"),
    ("residual", "conv_eltwiseadd_fuse_pass")])
def test_conv_pass_rewrites_and_folds_as_the_reference(kind, pass_name):
    jprog, fetch, vals = _conv_program(kind)
    pprog = p_program.Program.from_dict(jprog.to_dict())
    jscope = jf.Scope()
    for n, a in vals.items():
        jscope._set(n, a)
    pscope = pf.Scope()
    pf.load_numpy_params(pscope, vals, pf.CPUPlace())
    j_ir.apply_passes(jprog, [pass_name], scope=jscope, protected={fetch})
    p_ir.apply_passes(pprog, [pass_name], scope=pscope, protected={fetch})
    assert _norm(pprog.to_dict()) == _norm(jprog.to_dict())
    types = [o.type for o in pprog.global_block.ops]
    if pass_name == "conv_bn_fuse_pass":
        assert "batch_norm" not in types
    else:
        assert "conv2d_fusion" in types and "conv2d" not in types
    assert sorted(pscope.local_var_names()) == \
        sorted(jscope.local_var_names())
    moved = 0
    for n in jscope.local_var_names():
        want = np.asarray(jscope._get(n))
        got = pscope._get(n).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, n
        np.testing.assert_allclose(got, want, rtol=0, atol=FOLD_TOL)
        moved += n not in vals or not np.array_equal(want, vals[n])
    if pass_name == "conv_bn_fuse_pass":
        assert moved == 2  # the filter and the (new or folded) bias


# --- the fc op --------------------------------------------------------------
def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


FC_CASES = [
    ("ncd1", {"Input": _rand(4, 6), "W": _rand(6, 3, seed=1),
              "Bias": _rand(3, seed=2)}, {"in_num_col_dims": 1}),
    ("ncd2", {"Input": _rand(2, 5, 6), "W": _rand(6, 3, seed=1),
              "Bias": _rand(3, seed=2)}, {"in_num_col_dims": 2}),
    ("ncd1_of_3d", {"Input": _rand(2, 3, 4), "W": _rand(12, 5, seed=1),
                    "Bias": _rand(5, seed=2)}, {"in_num_col_dims": 1}),
    ("no_bias", {"Input": _rand(4, 6), "W": _rand(6, 3, seed=1)},
     {"in_num_col_dims": 1}),
] + [(f"act_{a}", {"Input": _rand(2, 5, 6), "W": _rand(6, 3, seed=1),
                   "Bias": _rand(3, seed=2)},
      {"in_num_col_dims": 2, "activation_type": a})
     for a in ("relu", "tanh", "softmax", "")]


@pytest.mark.parametrize("name,inputs,attrs", FC_CASES,
                         ids=[c[0] for c in FC_CASES])
def test_fc_op_matches_reference(name, inputs, attrs):
    op_case("fc", inputs, attrs).check_output(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,inputs,attrs", FC_CASES[:2] + FC_CASES[5:6],
                         ids=["ncd1", "ncd2", "act_tanh"])
def test_fc_op_grad(name, inputs, attrs):
    op_case("fc", inputs, attrs).check_grad(list(inputs))


def test_fc_op_unknown_activation_raises():
    t = op_case("fc", {"Input": _rand(2, 4), "W": _rand(4, 3)},
                {"activation_type": "gelu"})
    with pytest.raises(ValueError, match="unsupported activation"):
        t.port_outputs()
    with pytest.raises(ValueError, match="unsupported activation"):
        t.reference_outputs()
