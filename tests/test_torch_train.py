"""The training slice end to end: Transformer ``build_program`` with Adam
under noam decay, built by both packages, started from the same
parameters and trained on the same feeds.

The model is Transformer-base cut to d_model 64, 2 heads, 1+1 layers,
d_inner 128, vocab 256, seq 16, batch 4, dropout 0. warmup_steps=100
makes noam's rates 1.25e-4·step, which move the loss by about 5% in
5 steps on one repeated batch.

Tolerances:
- losses: 1e-5 relative; fp32, sums in a different order.
- step-1 grads of every parameter: 1e-5 norm-wise (‖a-b‖/‖b‖).
- parameters after 5 steps: 1e-5 + 2·Σlr absolute. Adam's m/√v turns a
  gradient that is ±tiny in one package and 0 in the other into a full
  ±lr step, so a parameter may legitimately differ by up to twice the
  summed rates. That bound alone would pass an update never applied,
  so each parameter's change over the 5 steps is also held norm-wise
  to 1e-5 on the elements whose step-1 |grad| exceeds 1e-5 of the
  parameter's largest: below that a grad is within a few tens of fp32
  roundings of its largest terms, the m/√v sign flip above. (They
  read at most 3e-6.)
- the optimizer state after 5 steps (Adam's moments, the beta powers):
  1e-5 norm-wise; they read at most 8e-7.
- the SGD case: 1e-5 absolute after 3 steps (SGD is linear in the
  grads, so a grad fault shows apart from Adam).
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops.kernels import xent as KX

CFG = dict(seq_len=16, d_model=64, n_heads=2, n_layers=1, d_inner=128,
           vocab=256, dropout_rate=0.0)
WARMUP = 100
BATCH = 4
STEPS = 5
# a step-1 grad below this fraction of its parameter's largest is at
# rounding level (see the tolerances above)
GRAD_FLOOR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small so these tests do not crowd the
    timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _feed(seed=7):
    rs = np.random.RandomState(seed)
    return {k: rs.randint(0, CFG["vocab"], (BATCH, CFG["seq_len"])).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}


def _persistables(startup):
    return [n for n, v in startup.global_block.vars.items() if v.persistable]


def _pair(build):
    """Both packages' programs from `build(pkg, transformer_module)`, the
    reference's startup run, and its state carried into the port."""
    with j_unique_name.guard():
        jmain, jstart, jcost = build(jf, JT)
    with p_unique_name.guard():
        pmain, pstart, pcost = build(pf, PT)
    jexe = jf.Executor(jf.CPUPlace())
    jscope = jf.Scope()
    jexe.run(jstart, scope=jscope)
    names = _persistables(jstart)
    assert names == _persistables(pstart)
    state = {n: np.asarray(jscope.find_var(n).get_tensor()) for n in names}
    pscope = pf.Scope()
    pf.load_numpy_params(pscope, state, pf.CPUPlace())
    return dict(jmain=jmain, jcost=jcost, jexe=jexe, jscope=jscope,
                pmain=pmain, pcost=pcost, pexe=pf.Executor(pf.CPUPlace()),
                pscope=pscope, names=names, state=state)


def _adam_program(pkg, T):
    return T.build_program(warmup_steps=WARMUP, **CFG)


@pytest.fixture(scope="module")
def adam_pair():
    return _pair(_adam_program)


def _op_list(prog):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
            for op in prog.global_block.ops]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_both_packages_build_the_same_training_program(adam_pair):
    assert _op_list(adam_pair["pmain"]) == _op_list(adam_pair["jmain"])
    types = [op.type for op in adam_pair["pmain"].global_block.ops]
    assert "softmax_with_cross_entropy_grad" in types
    assert types.count("adam") == len(adam_pair["pmain"].all_parameters())


def test_adam_training_matches_reference(adam_pair):
    p = adam_pair
    feed = _feed()
    params = [v.name for v in p["pmain"].all_parameters()]
    m1 = [n for n in p["names"] if n.startswith("logits.w_moment1")]
    fetch = [p["jcost"].name] + [g + "@GRAD" for g in params] + m1
    launches = KX.xent_forward.launches, KX.xent_backward.launches
    jl, pl = [], []
    for step in range(STEPS):
        jout = p["jexe"].run(p["jmain"], feed=feed,
                             fetch_list=fetch if step == 0 else [p["jcost"]],
                             scope=p["jscope"])
        pout = p["pexe"].run(p["pmain"], feed=feed,
                             fetch_list=fetch if step == 0 else [p["pcost"]],
                             scope=p["pscope"])
        jl.append(float(np.asarray(jout[0]).reshape(())))
        pl.append(float(np.asarray(pout[0]).reshape(())))
        if step == 0:
            for name, a, b in zip(fetch[1:], pout[1:], jout[1:]):
                b = np.asarray(b)
                assert _rel(a, b) <= 1e-5, name
            grad1 = {n: np.abs(np.asarray(b)) for n, b in zip(params,
                                                              jout[1:])}
            # Moment1 after one step is (1 - beta1) g
            g_logits = pout[1 + params.index("logits.w")]
            np.testing.assert_allclose(pout[-1], 0.1 * g_logits, rtol=1e-6,
                                       atol=1e-9)
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert (jl[0] - jl[-1]) / jl[0] >= 0.01, jl  # the steps train
    # noam: d^-0.5 · min(s^-0.5, s · w^-1.5) for steps 1..5
    d = CFG["d_model"]
    sum_lr = sum(d ** -0.5 * min(s ** -0.5, s * WARMUP ** -1.5)
                 for s in range(1, STEPS + 1))
    for name in p["names"]:
        got = pf.scope_to_numpy(p["pscope"], [name])[name]
        want = np.asarray(p["jscope"].find_var(name).get_tensor())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 + 2 * sum_lr, err_msg=name)
        if name in grad1:
            # the update itself, where the step-1 grad is not rounding
            g = grad1[name]
            moved = g > GRAD_FLOOR * g.max()
            before = p["state"][name]
            assert moved.any(), name
            assert _rel(got[moved] - before[moved],
                        want[moved] - before[moved]) <= 1e-5, name
        else:
            assert _rel(got, want) <= 1e-5, name  # moments, beta powers
    # on the CPU the xent wrappers run their plain versions
    assert (KX.xent_forward.launches, KX.xent_backward.launches) == launches


# long sequences: head dim 64 and fp32, so the port routes every attention
# op of the program to a kernel wrapper (on the CPU its plain version):
# seq 264 to sdpa_short (tq == tk in (256, 512]), seq 520 to flash
LONG_CFG = dict(d_model=128, n_heads=2, n_layers=1, d_inner=256, vocab=256,
                dropout_rate=0.0)
LONG_BATCH = 2
LONG_STEPS = 3


@pytest.mark.parametrize("seq_len", [264, 520])
def test_long_sequence_training_matches_reference(seq_len):
    """Adam steps of a d128, 2-head, 1+1-layer Transformer at a routed
    length against the JAX package's composition path: losses within
    1e-5 relative, every parameter's step-1 grad within 1e-5 norm-wise."""
    p = _pair(lambda pkg, T: T.build_program(
        seq_len=seq_len, warmup_steps=WARMUP, **LONG_CFG))
    rs = np.random.RandomState(seq_len)
    feed = {k: rs.randint(0, LONG_CFG["vocab"], (LONG_BATCH, seq_len))
            .astype("int64") for k in ("src_ids", "tgt_ids", "label")}
    params = [v.name for v in p["pmain"].all_parameters()]
    fetch = [p["jcost"].name] + [g + "@GRAD" for g in params]
    jl, pl = [], []
    for step in range(LONG_STEPS):
        jout = p["jexe"].run(p["jmain"], feed=feed,
                             fetch_list=fetch if step == 0 else [p["jcost"]],
                             scope=p["jscope"])
        pout = p["pexe"].run(p["pmain"], feed=feed,
                             fetch_list=fetch if step == 0 else [p["pcost"]],
                             scope=p["pscope"])
        jl.append(float(np.asarray(jout[0]).reshape(())))
        pl.append(float(np.asarray(pout[0]).reshape(())))
        if step == 0:
            for name, a, b in zip(fetch[1:], pout[1:], jout[1:]):
                assert _rel(a, np.asarray(b)) <= 1e-5, name
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert jl[-1] < jl[0], jl


def _sgd_program(pkg, T):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        src = pkg.layers.data("src_ids", shape=[CFG["seq_len"]], dtype="int64")
        tgt = pkg.layers.data("tgt_ids", shape=[CFG["seq_len"]], dtype="int64")
        label = pkg.layers.data("label", shape=[CFG["seq_len"]],
                                dtype="int64")
        cost, _ = T.transformer(
            src, tgt, label, src_vocab=CFG["vocab"], tgt_vocab=CFG["vocab"],
            max_len=256, d_model=CFG["d_model"], n_heads=CFG["n_heads"],
            n_layers=CFG["n_layers"], d_inner=CFG["d_inner"],
            dropout_rate=0.0)
        pkg.optimizer.SGD(learning_rate=0.5).minimize(cost)
    return main, startup, cost


def test_sgd_training_matches_reference():
    p = _pair(_sgd_program)
    feed = _feed(seed=8)
    for _ in range(3):
        jl = p["jexe"].run(p["jmain"], feed=feed, fetch_list=[p["jcost"]],
                           scope=p["jscope"])[0]
        pl = p["pexe"].run(p["pmain"], feed=feed, fetch_list=[p["pcost"]],
                           scope=p["pscope"])[0]
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-5, atol=0)
    for name in p["names"]:
        got = pf.scope_to_numpy(p["pscope"], [name])[name]
        want = np.asarray(p["jscope"].find_var(name).get_tensor())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_dropout_is_refused_not_dropped():
    """A nonzero dropout rate is never dropped: the port refused it until
    dropout was ported, and now builds the JAX package's program, its
    dropout ops (and their grads) and attention dropout included."""
    cfg = dict(CFG, dropout_rate=0.1)
    with p_unique_name.guard():
        pmain, _, _ = PT.build_program(warmup_steps=WARMUP, **cfg)
    with j_unique_name.guard():
        jmain, _, _ = JT.build_program(warmup_steps=WARMUP, **cfg)
    assert _op_list(pmain) == _op_list(jmain)
    types = [op.type for op in pmain.global_block.ops]
    assert "dropout" in types and "dropout_grad" in types
    assert all(op.attrs["dropout_rate"] == 0.1
               for op in pmain.global_block.ops if op.type == "attention")
