"""Gradient clipping and weight decay in the port (``clip.py``,
``regularizer.py``, their ops and the Optimizer pipeline) against the
JAX package.

Tolerances:
- one op (clip, clip_by_norm, sign, sqrt, squared_l2_norm,
  elementwise_div and its grad): 1e-6 relative and absolute; fp32, the
  same arithmetic (a sum of squares over a few hundred terms in another
  order), and sign and the clip's branches exactly.
- training through ``minimize`` on a small fc program started from the
  JAX package's weights: 5 SGD or Adam steps, losses and every parameter
  within 1e-5 relative (``rtol``, with 1e-6 absolute for values near 0);
  fp32 in another summation order. Each clip really acts (the clipped
  grads differ from the raw ones) and each decay moves the parameters.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import clip as j_clip
from paddle_tpu import regularizer as j_reg
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu_torch import clip as p_clip
from paddle_tpu_torch import regularizer as p_reg
from paddle_tpu_torch import unique_name as p_unique_name

STEPS = 5
RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": (jf, j_clip, j_reg, j_unique_name),
        "torch": (pf, p_clip, p_reg, p_unique_name)}


@pytest.fixture(autouse=True)
def _clean_clip_state():
    """The JAX package keeps set_gradient_clip's choices in a module
    dict keyed by parameter name: empty it around each test so no other
    test's program is clipped."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    j_clip._clip_attr.clear()
    yield
    j_clip._clip_attr.clear()
    torch.set_num_threads(n)


def _one_op(pkg, op_type, feeds, attrs, grad_of=()):
    """Out of one `op_type` op on the numpy `feeds` ({slot: array}), and
    with `grad_of` the grads of those slots' inputs of mean(Out * w),
    w a fixed ramp, through append_backward."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        blk = main.global_block
        ins = {s: pkg.layers.data(s.lower(), shape=list(a.shape),
                                  dtype=str(a.dtype),
                                  append_batch_size=False,
                                  stop_gradient=s not in grad_of)
               for s, a in feeds.items()}
        out = blk.create_var(name="out", dtype="float32")
        blk.append_op(op_type, {s: [v] for s, v in ins.items()},
                      {"Out": [out]}, attrs)
        fetch = [out]
        n = feeds["X"].size  # Out is shaped like X
        if grad_of:
            w = pkg.layers.data("w", shape=[n], dtype="float32",
                                append_batch_size=False)
            flat = pkg.layers.reshape(out, [-1])
            loss = pkg.layers.mean(pkg.layers.elementwise_mul(flat, w))
            pkg.backward.append_backward(loss)
            fetch += [ins[s].name + "@GRAD" for s in grad_of]
    feed = {v.name: feeds[s] for s, v in ins.items()}
    exe = pkg.Executor(pkg.CPUPlace())
    if grad_of:
        feed["w"] = np.linspace(-1.0, 2.0, n).astype(np.float32)
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch)]


def _both(op_type, feeds, attrs, grad_of=()):
    got = _one_op(pf, op_type, feeds, attrs, grad_of)
    want = _one_op(jf, op_type, feeds, attrs, grad_of)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    return got


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", ["above", "equal", "below", "zero"])
def test_clip_by_norm_matches_reference_at_the_edges(case):
    """At norm == max_norm x is kept, as the reference's strict '>'
    keeps it; a zero x stays zero (no 0/0)."""
    x = _x(6, 5) if case != "zero" else np.zeros((6, 5), np.float32)
    norm = float(np.sqrt(np.sum(x.astype(np.float64) ** 2)))
    max_norm = {"above": norm / 3, "equal": float(np.float32(norm)),
                "below": norm * 2, "zero": 1.0}[case]
    if case == "equal":
        # the norm as both packages compute it in fp32, so the op sees
        # norm == max_norm exactly
        max_norm = float(np.sqrt(np.sum(x * x, dtype=np.float32)))
    out, = _both("clip_by_norm", {"X": x}, {"max_norm": max_norm})
    if case == "above":
        np.testing.assert_allclose(np.linalg.norm(out), max_norm, rtol=1e-5)
    else:
        np.testing.assert_array_equal(out, x)


def test_clip_matches_reference_with_its_grad_at_the_bounds():
    """Values inside, outside and at both bounds: JAX's clip passes half
    of the gradient at a bound (max then min), and so does the port's."""
    x = np.array([[-2.0, -0.5, 0.0, 0.25, 0.5, 3.0]], np.float32)
    out, dx = _both("clip", {"X": x}, {"min": -0.5, "max": 0.5},
                    grad_of=("X",))
    np.testing.assert_array_equal(out, np.clip(x, -0.5, 0.5))
    # d mean(out * w) / dx: w / 6 inside, half of it at a bound, 0 outside
    w = np.linspace(-1.0, 2.0, 6).astype(np.float32) / 6
    np.testing.assert_allclose(dx[0], w * [0, 0.5, 1, 1, 0.5, 0],
                               rtol=1e-6)


def test_sign_and_sqrt_match_reference():
    x = np.array([-3.0, -0.0, 0.0, 1e-30, 2.5], np.float32)
    sign, = _both("sign", {"X": x}, {})
    np.testing.assert_array_equal(sign, [-1.0, 0.0, 0.0, 1.0, 1.0])
    _both("sqrt", {"X": np.abs(_x(4, 7))}, {}, grad_of=("X",))


def test_sign_keeps_nan_and_negative_zero():
    """sign gives X itself at -0.0, 0.0 and NaN, as jnp.sign does: the
    same bits as the JAX package's (torch.sign maps NaN to 0)."""
    x = np.array([-0.0, 0.0, np.nan, -2.0], np.float32)
    got = _one_op(pf, "sign", {"X": x}, {})[0]
    want = _one_op(jf, "sign", {"X": x}, {})[0]
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_squared_l2_norm_has_shape_one():
    x = _x(3, 4, 5)
    out, = _both("squared_l2_norm", {"X": x}, {})
    assert out.shape == (1,)
    np.testing.assert_allclose(out[0], np.sum(x.astype(np.float64) ** 2),
                               rtol=1e-6)


@pytest.mark.parametrize("yshape,axis", [((4, 5, 6), -1), ((6,), -1),
                                         ((5,), 1), ((4, 5), 0),
                                         ((5, 1), 1)])
def test_elementwise_div_broadcasts_by_axis_with_its_grad(yshape, axis):
    x = _x(4, 5, 6)
    y = np.abs(_x(*yshape, seed=1)) + 0.5
    _both("elementwise_div", {"X": x, "Y": y}, {"axis": axis},
          grad_of=("X", "Y"))


# --------------------------------------------------------------------------
# clips and regularizers through minimize
# --------------------------------------------------------------------------
def _fc_program(pkg, clip_mod, reg_mod, opt_name, clip, reg, param_reg):
    """x [16] -> fc 32 relu -> fc 4 -> softmax_with_cross_entropy, mean;
    `clip`: None or (class name, args) set on every parameter with
    set_gradient_clip; `reg`: None or (class name, coeff) for the
    optimizer; `param_reg`: the same for the first fc's weight alone."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        x = pkg.layers.data("x", shape=[16], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        w_attr = None
        if param_reg is not None:
            w_attr = pkg.ParamAttr(
                name="fc_w0",
                regularizer=getattr(reg_mod, param_reg[0])(param_reg[1]))
        h = pkg.layers.fc(x, 32, act="relu", param_attr=w_attr)
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        kw = {}
        if reg is not None:
            kw["regularization"] = getattr(reg_mod, reg[0])(reg[1])
        if opt_name == "sgd":
            opt = pkg.optimizer.SGD(learning_rate=0.5, **kw)
        else:
            opt = pkg.optimizer.Adam(learning_rate=0.05, **kw)
        if clip is not None:
            clip_mod.set_gradient_clip(getattr(clip_mod, clip[0])(*clip[1]))
        opt.minimize(loss)
    return main, start, loss


def _train(case):
    """5 steps of `case` in both packages from the JAX package's initial
    weights: {package: (losses, final params, step-1 grads)}."""
    opt, clip, reg, param_reg = case
    r = np.random.RandomState(0)
    x = r.randn(32, 16).astype(np.float32)
    y = r.randint(0, 4, (32, 1)).astype(np.int64)
    res, state = {}, None
    for name in ("jax", "torch"):
        pkg, clip_mod, reg_mod, un = PKGS[name]
        with un.guard():
            main, start, loss = _fc_program(pkg, clip_mod, reg_mod, opt,
                                            clip, reg, param_reg)
        params = [p.name for p in main.all_parameters()]
        grads = [p + "@GRAD" for p in params]
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        if name == "jax":
            exe.run(start, scope=scope)
            names = [n for n, v in start.global_block.vars.items()
                     if v.persistable]
            state = {n: np.asarray(scope.find_var(n).get_tensor())
                     for n in names}
        else:
            pf.load_numpy_params(scope, state, pf.CPUPlace())
        losses, step1 = [], None
        for i in range(STEPS):
            out = exe.run(main, feed={"x": x, "y": y},
                          fetch_list=[loss] + (grads if i == 0 else []),
                          scope=scope)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if i == 0:
                step1 = [np.asarray(g) for g in out[1:]]
        if name == "jax":
            final = {p: np.asarray(scope.find_var(p).get_tensor())
                     for p in params}
        else:
            final = pf.scope_to_numpy(scope, params)
        res[name] = (losses, final, step1, main)
    return res, state


CASES = {
    "sgd-by-value": ("sgd", ("GradientClipByValue", (0.01,)), None, None),
    "adam-by-value-min": ("adam", ("GradientClipByValue", (0.02, -0.01)),
                          None, None),
    "sgd-by-norm": ("sgd", ("GradientClipByNorm", (0.05,)), None, None),
    "adam-global-norm": ("adam", ("GradientClipByGlobalNorm", (0.1,)), None,
                         None),
    "sgd-l2": ("sgd", None, ("L2Decay", 0.05), None),
    "adam-l1": ("adam", None, ("L1Decay", 0.01), None),
    "sgd-l2-param-l1": ("sgd", None, ("L2Decay", 0.05), ("L1Decay", 0.02)),
    "adam-global-norm-l2": ("adam", ("GradientClipByGlobalNorm", (0.1,)),
                            ("L2Decay", 1e-3), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_clip_and_regularizer_training_matches_reference(name):
    res, state = _train(CASES[name])
    jl, jp, jg, jmain = res["jax"]
    pl, pp, pg, pmain = res["torch"]
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    for p in jp:
        np.testing.assert_allclose(pp[p], jp[p], rtol=RTOL, atol=ATOL,
                                   err_msg=p)
        assert not np.array_equal(pp[p], state[p]), f"{p} did not move"
    for g, w in zip(pg, jg):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    types = [op.type for op in pmain.global_block.ops]
    assert types == [op.type for op in jmain.global_block.ops]
    _, clip, reg, param_reg = CASES[name]
    if clip is not None:
        want = {"GradientClipByValue": "clip",
                "GradientClipByNorm": "clip_by_norm",
                "GradientClipByGlobalNorm": "squared_l2_norm"}[clip[0]]
        assert want in types
    if reg is not None or param_reg is not None:
        assert "scale" in types and types.count("sum") >= 4


def _clipped_grads(clip_norm):
    """Step-1 grads of the fc program (SGD) in the port, fetched after
    the global-norm clip, and the raw grads' global norm."""
    with p_unique_name.guard():
        main, start, loss = _fc_program(
            pf, p_clip, p_reg, "sgd",
            ("GradientClipByGlobalNorm", (clip_norm,)), None, None)
    params = [p.name for p in main.all_parameters()]
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    pf.seed(3)
    exe.run(start, scope=scope)
    r = np.random.RandomState(0)
    feed = {"x": r.randn(32, 16).astype(np.float32),
            "y": r.randint(0, 4, (32, 1)).astype(np.int64)}
    names = [p + "@GRAD" for p in params]
    clipped = [n for n in main.global_block.vars if n.endswith("@GCLIP")]
    out = exe.run(main, feed=feed, fetch_list=names + sorted(clipped),
                  scope=scope)
    raw, cl = out[:len(names)], out[len(names):]
    gnorm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                              for g in raw)))
    cnorm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                              for g in cl)))
    return gnorm, cnorm


def test_global_norm_clip_scales_to_clip_norm():
    gnorm, cnorm = _clipped_grads(1e-3)
    assert gnorm > 1e-3
    np.testing.assert_allclose(cnorm, 1e-3, rtol=1e-5)
    gnorm, cnorm = _clipped_grads(1e3)  # below the limit: unchanged
    np.testing.assert_allclose(cnorm, gnorm, rtol=1e-6)


def test_param_regularizer_overrides_the_optimizers():
    """fc_w0's own L1 term replaces the optimizer's L2 one: its decay op
    is a sign and a scale, every other parameter's a scale alone."""
    with p_unique_name.guard():
        main, _, _ = _fc_program(pf, p_clip, p_reg, "sgd", None,
                                 ("L2Decay", 0.05), ("L1Decay", 0.02))
    ops = main.global_block.ops
    signs = [op for op in ops if op.type == "sign"]
    assert [op.inputs["X"] for op in signs] == [["fc_w0"]]
    scaled = sorted(op.inputs["X"][0] for op in ops if op.type == "scale")
    params = sorted(p.name for p in main.all_parameters())
    assert len(scaled) == len(params)
    assert "fc_w0" not in scaled


def test_error_clip_callback_is_the_default_and_does_nothing():
    """Optimizer.backward hands append_backward [error_clip_callback], as
    the JAX package does; it appends nothing. A callback of one's own is
    called after every grad op with the grad-to-forward names."""
    seen = []

    def record(block, context):
        seen.append(dict(context))

    with p_unique_name.guard():
        main, _, loss = _fc_program(pf, p_clip, p_reg, "sgd", None, None,
                                    None)
    with p_unique_name.guard():
        main2, start2 = pf.Program(), pf.Program()
        with pf.program_guard(main2, start2):
            x = pf.layers.data("x", shape=[16], dtype="float32")
            loss2 = pf.layers.mean(pf.layers.fc(x, 4))
            pf.backward.append_backward(loss2, callbacks=[record])
    assert seen and seen[-1]["fc_0.w_0@GRAD"] == "fc_0.w_0"
    ref = _fc_program(jf, j_clip, j_reg, "sgd", None, None, None)[0]
    assert len(main.global_block.ops) == len(ref.global_block.ops)
    assert p_clip.ErrorClipByValue(0.5).min == -0.5
