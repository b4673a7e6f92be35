"""The port's optimizers (``optimizer.py``) and their update ops
(``ops/optimizer_ops.py``) against the JAX package's.

- each update op alone (``tests/torch_op_test.py``): every output slot
  within 1e-6 relative and absolute, from random state and from zero
  state (Adagrad's first step, FTRL's sq = 0); fp32, the same formulas in
  the same order.
- each optimizer class: 5 steps of a 2-layer fc net (x [16] -> fc 32
  relu -> fc 4 -> softmax_with_cross_entropy) from the JAX package's
  initial weights, plain and with L2Decay(1e-3) and a global-norm clip:
  losses within 1e-5 relative, every parameter and every accumulator
  within 1e-5 of its largest |value| (fp32 in another summation order:
  an adaptive step, g / sqrt(m), turns a grad of ~1e-6 that rounds
  apart into a step that differs by ~1e-6 at a parameter near 0, so
  per element a relative limit does not hold). Every parameter moves
  (under LARS, whose step scales with |p|, the zero biases stay zero)
  and the loss falls.
- ``Adam(lazy_mode=True)`` builds the dense adam op, as the JAX package
  does (C20: it raised before).
- on the card (marked ``gpu``; ``python -m pytest --noconftest -m gpu
  tests/test_torch_optimizers.py``, the JAX package imported only by the
  tests that read it): each update op against the port's CPU run within
  1e-6, and each optimizer's 5 steps there within the limits above.
"""
import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch import unique_name as p_unique_name
from torch_op_test import op_case

STEPS = 5
RTOL, ATOL = 1e-5, 1e-6


def _jax_pkg():
    """The JAX package, imported only by the tests that read it: the
    card's machine has no JAX."""
    import paddle_tpu

    return paddle_tpu


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the update ops
# ---------------------------------------------------------------------------
def _state(shape, zero, seed, positive=False):
    if zero:
        return np.zeros(shape, np.float32)
    lo = 0.01 if positive else -1.0
    return _x(*shape, seed=seed, lo=lo, hi=1.0)


def _update_case(op_type, attrs, zero):
    shape = (4, 6)
    p, g = _x(*shape, seed=10), _x(*shape, seed=11)
    lr = np.array([0.05], np.float32)
    ins = {"Param": p, "Grad": g, "LearningRate": lr}
    st = {
        "momentum": {"Velocity": False},
        "lars_momentum": {"Velocity": False},
        "adagrad": {"Moment": True},
        "decayed_adagrad": {"Moment": True},
        "adamax": {"Moment": False, "InfNorm": True},
        "adadelta": {"AvgSquaredGrad": True, "AvgSquaredUpdate": True},
        "rmsprop": {"Moment": False, "MeanSquare": True, "MeanGrad": False},
        "ftrl": {"SquaredAccumulator": True, "LinearAccumulator": False},
    }[op_type]
    for i, (slot, pos) in enumerate(st.items()):
        ins[slot] = _state(shape, zero, 20 + i, pos)
    if op_type == "adamax":
        ins["Beta1Pow"] = np.array([0.9 ** 3], np.float32)
    if op_type == "adadelta":
        del ins["LearningRate"]
    outs = {
        "momentum": ("ParamOut", "VelocityOut"),
        "lars_momentum": ("ParamOut", "VelocityOut"),
        "adagrad": ("ParamOut", "MomentOut"),
        "decayed_adagrad": ("ParamOut", "MomentOut"),
        "adamax": ("ParamOut", "MomentOut", "InfNormOut"),
        "adadelta": ("ParamOut", "AvgSquaredGradOut",
                     "AvgSquaredUpdateOut"),
        "rmsprop": ("ParamOut", "MomentOut", "MeanSquareOut",
                    "MeanGradOut"),
        "ftrl": ("ParamOut", "SquaredAccumOut", "LinearAccumOut"),
    }[op_type]
    return op_case(op_type, ins, attrs, outs)


UPDATES = [
    ("momentum", {"mu": 0.9}),
    ("momentum", {"mu": 0.9, "use_nesterov": True}),
    ("lars_momentum", {"mu": 0.9, "lars_coeff": 0.001,
                       "lars_weight_decay": 0.0005}),
    ("adagrad", {"epsilon": 1e-6}),
    ("decayed_adagrad", {"decay": 0.95, "epsilon": 1e-6}),
    ("adamax", {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adadelta", {"rho": 0.95, "epsilon": 1e-6}),
    ("rmsprop", {"decay": 0.95, "epsilon": 1e-6}),
    ("rmsprop", {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5,
                 "centered": True}),
    ("ftrl", {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    ("ftrl", {"l1": 0.01, "l2": 0.02, "lr_power": -0.3}),
]


@pytest.mark.parametrize("zero", [False, True], ids=["state", "zero"])
@pytest.mark.parametrize("op_type,attrs", UPDATES,
                         ids=[f"{t}-{i}" for i, (t, _) in
                              enumerate(UPDATES)])
def test_update_op(op_type, attrs, zero):
    """Every output slot the reference writes, within 1e-6, from random
    state and from zero state (Adagrad's first step, FTRL's sq = 0)."""
    _update_case(op_type, attrs, zero).check_output()


# ---------------------------------------------------------------------------
# the optimizer classes through minimize
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "momentum": ("Momentum", dict(learning_rate=0.1, momentum=0.9)),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.1, momentum=0.9,
                                           use_nesterov=True)),
    "lars_momentum": ("LarsMomentum", dict(learning_rate=0.5, momentum=0.9,
                                           lars_coeff=0.01)),
    "adagrad": ("Adagrad", dict(learning_rate=0.1)),
    "adamax": ("Adamax", dict(learning_rate=0.05)),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=0.05)),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, rho=0.9)),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01)),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, momentum=0.5,
                                         centered=True)),
    "ftrl": ("Ftrl", dict(learning_rate=0.1, l1=0.001, l2=0.01)),
    "ftrl_power": ("Ftrl", dict(learning_rate=0.1, l1=0.001, l2=0.01,
                                lr_power=-0.3)),
    "adam_lazy": ("Adam", dict(learning_rate=0.05, lazy_mode=True)),
}


def _program(pkg, opt, decay_clip):
    """The 2-layer fc net under optimizer `opt`. The JAX package keeps
    set_gradient_clip's choices in a module dict keyed by parameter
    name: it is emptied around the build, so no other program of the
    worker is clipped."""
    name, kw = OPTIMIZERS[opt]
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start), \
            _clip_dict_cleared(pkg):
        x = pkg.layers.data("x", shape=[16], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, 32, act="relu")
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        kw = dict(kw)
        if decay_clip:
            kw["regularization"] = pkg.regularizer.L2Decay(1e-3)
            pkg.clip.set_gradient_clip(
                pkg.clip.GradientClipByGlobalNorm(0.5))
        getattr(pkg.optimizer, name)(**kw).minimize(loss)
    return main, start, loss


@contextlib.contextmanager
def _clip_dict_cleared(pkg):
    attr = getattr(pkg.clip, "_clip_attr", None)
    if attr is not None:
        attr.clear()
    try:
        yield
    finally:
        if attr is not None:
            attr.clear()


def _feed():
    r = np.random.RandomState(0)
    return {"x": r.randn(32, 16).astype(np.float32),
            "y": r.randint(0, 4, (32, 1)).astype(np.int64)}


def _port_steps(opt, decay_clip, state, place):
    """5 steps of the port from `state` on `place`: (losses, final
    persistables, program)."""
    main, start, loss = _program(pf, opt, decay_clip)
    names = [n for n, v in start.global_block.vars.items() if v.persistable]
    exe, scope = pf.Executor(place), pf.Scope()
    pf.load_numpy_params(scope, state, place)
    losses = [float(np.asarray(exe.run(main, feed=_feed(), fetch_list=[loss],
                                       scope=scope)[0]).reshape(-1)[0])
              for _ in range(STEPS)]
    return losses, pf.scope_to_numpy(scope, names), main


def _train(opt, decay_clip):
    """5 steps in both packages from the JAX package's initial state:
    {package: (losses, final persistables, program)}, and that state."""
    feed = _feed()
    res, state = {}, None
    jf = _jax_pkg()
    for pkg in (jf, pf):
        main, start, loss = _program(pkg, opt, decay_clip)
        names = [n for n, v in start.global_block.vars.items()
                 if v.persistable]
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        if pkg is jf:
            exe.run(start, scope=scope)
            state = {n: np.asarray(scope.find_var(n).get_tensor())
                     for n in names}
        else:
            pf.load_numpy_params(scope, state, pf.CPUPlace())
        losses = [float(np.asarray(exe.run(main, feed=feed,
                                           fetch_list=[loss],
                                           scope=scope)[0]).reshape(-1)[0])
                  for _ in range(STEPS)]
        if pkg is jf:
            final = {n: np.asarray(scope.find_var(n).get_tensor())
                     for n in names}
        else:
            final = pf.scope_to_numpy(scope, names)
        res[pkg.__name__] = (losses, final, main)
    return res, state


def _assert_states_close(got, want):
    assert set(got) == set(want)
    for n in want:
        assert got[n].shape == want[n].shape, n
        err = float(np.max(np.abs(got[n] - want[n])))
        assert err <= RTOL * max(float(np.max(np.abs(want[n]))), ATOL), \
            (n, err)


@pytest.mark.parametrize("decay_clip", [False, True],
                         ids=["plain", "l2_clip"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizer_training_matches_reference(opt, decay_clip):
    res, state = _train(opt, decay_clip)
    jl, jstate, jmain = res["paddle_tpu"]
    pl, pstate, pmain = res["paddle_tpu_torch"]
    assert [o.type for o in pmain.global_block.ops] == \
        [o.type for o in jmain.global_block.ops]
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    _assert_states_close(pstate, jstate)
    for p in pmain.all_parameters():
        if opt == "lars_momentum" and not np.any(state[p.name]):
            # LARS scales the step by |p|: a zero bias stays zero
            np.testing.assert_array_equal(pstate[p.name], 0)
            continue
        assert not np.array_equal(pstate[p.name], state[p.name]), p.name
    assert pl[-1] < pl[0]


def test_adam_lazy_mode_builds_the_dense_adam_op():
    """Adam(lazy_mode=True) is Adam: the same op types and attrs as
    lazy_mode=False, in both packages."""
    with p_unique_name.guard():
        lazy = _program(pf, "adam_lazy", False)[0]
    OPTIMIZERS["adam_dense"] = ("Adam", dict(learning_rate=0.05))
    try:
        with p_unique_name.guard():
            dense = _program(pf, "adam_dense", False)[0]
    finally:
        del OPTIMIZERS["adam_dense"]
    ops = [(o.type, sorted(o.attrs.items())) for o in lazy.global_block.ops
           if o.type == "adam"]
    assert len(ops) == 4
    assert ops == [(o.type, sorted(o.attrs.items()))
                   for o in dense.global_block.ops if o.type == "adam"]


# ---------------------------------------------------------------------------
# on the card: against the port's CPU run
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_optimizers.py`")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("op_type,attrs", UPDATES,
                         ids=[f"{t}-{i}" for i, (t, _) in
                              enumerate(UPDATES)])
def test_update_op_on_the_card_matches_cpu(cuda, op_type, attrs):
    for zero in (False, True):
        t = _update_case(op_type, attrs, zero)
        got, want = t.port_outputs(device=cuda), t.port_outputs()
        for s in want:
            np.testing.assert_allclose(got[s].cpu().numpy(),
                                       want[s].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=s)


@pytest.mark.gpu
def test_optimizers_on_the_card_match_cpu(cuda):
    """Each optimizer, with L2Decay and the clip: 5 steps on the card
    from the port's seeded initial state against the same on the CPU."""
    for opt in sorted(OPTIMIZERS):
        main, start, _ = _program(pf, opt, True)
        scope = pf.Scope()
        start.random_seed = 3
        pf.Executor(pf.CPUPlace()).run(start, scope=scope)
        names = [n for n, v in start.global_block.vars.items()
                 if v.persistable]
        state = pf.scope_to_numpy(scope, names)
        gl, gstate, _ = _port_steps(opt, True, state, pf.CUDAPlace(0))
        wl, wstate, _ = _port_steps(opt, True, state, pf.CPUPlace())
        np.testing.assert_allclose(gl, wl, rtol=RTOL, err_msg=opt)
        _assert_states_close(gstate, wstate)
