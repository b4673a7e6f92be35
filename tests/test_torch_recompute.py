"""Activation checkpointing in the port (``append_backward(checkpoints=)``,
``RecomputeOptimizer``, ``build_program(recompute=True)``) against the
port without it and against the JAX package, after the JAX package's
own ``tests/test_recompute.py``.

Tolerances:
- recompute against the same program without it, in the port: the same
  ops on the same values in another order, so losses equal within
  1e-6 (they read 0).
- against the JAX package: losses 1e-5 relative (fp32, another
  summation order), the programs op for op the same.
- a recomputed dropout op's mask equals its forward's exactly: both
  draw from the same step key, op uid and call index.
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
from paddle_tpu_torch.core import executor as p_executor
from paddle_tpu_torch.core import registry as p_registry
from paddle_tpu_torch.models import transformer as PT

STEPS = 5
CFG = dict(seq_len=16, d_model=32, n_heads=2, n_layers=2, d_inner=64,
           vocab=64)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _build(pkg, with_dropout, skip=False, recompute=True):
    """The JAX package's recompute test network: fc layers with two
    checkpoints (c1, c2), dropout after the first with `with_dropout`,
    and with `skip` a connection from h1 past c1 into the last layer."""
    main, start = pkg.Program(), pkg.Program()
    main.random_seed = 1234
    with pkg.program_guard(main, start):
        x = pkg.layers.data("x", shape=(16,), dtype="float32")
        y = pkg.layers.data("y", shape=(1,), dtype="int64")
        h1 = pkg.layers.fc(x, size=32, act="relu")
        if with_dropout:
            h1 = pkg.layers.dropout(
                h1, 0.3, dropout_implementation="upscale_in_train")
        c1 = pkg.layers.fc(h1, size=32, act="relu")
        h2 = pkg.layers.fc(c1, size=32, act="relu")
        c2 = pkg.layers.fc(h2, size=32, act="relu")
        if skip:
            c2 = pkg.layers.elementwise_add(c2, h1)
        logits = pkg.layers.fc(c2, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        opt = pkg.optimizer.Adam(learning_rate=0.01)
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([c1, c2])
        opt.minimize(loss)
    return main, start, loss


def _feed(seed=0, n=32):
    r = np.random.RandomState(seed)
    return {"x": r.rand(n, 16).astype("float32"),
            "y": r.randint(0, 4, (n, 1)).astype("int64")}


def _port_losses(recompute, with_dropout, skip=False, fetch=()):
    with p_unique_name.guard():
        main, start, loss = _build(pf, with_dropout, skip, recompute)
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    pf.seed(1234)
    exe.run(start, scope=scope)
    out = [exe.run(main, feed=_feed(), fetch_list=[loss, *fetch],
                   scope=scope) for _ in range(STEPS)]
    return main, [float(o[0][0]) for o in out], [o[1:] for o in out]


@pytest.mark.parametrize("with_dropout,skip", [(False, False),
                                               (True, False),
                                               (False, True),
                                               (True, True)])
def test_recompute_matches_plain(with_dropout, skip):
    _, plain, _ = _port_losses(False, with_dropout, skip)
    prog, ck, _ = _port_losses(True, with_dropout, skip)
    np.testing.assert_allclose(ck, plain, rtol=1e-6, atol=1e-6)
    assert plain[-1] < plain[0]
    names = [n for op in prog.global_block.ops for n in op.output_arg_names]
    assert any("@RECOMP" in n for n in names), "no recompute emitted"


def test_recompute_emits_barriers_and_keeps_uids():
    prog, _, _ = _port_losses(True, False)
    ops = prog.global_block.ops
    assert "optimization_barrier" in [op.type for op in ops]
    fwd = {n: op for op in ops if op.attrs.get("op_role") != "backward"
           for n in op.output_arg_names}
    clones = [op for op in ops if any("@RECOMP" in n
                                      for n in op.output_arg_names)]
    assert clones
    for clone in clones:
        src = fwd[next(n for n in clone.output_arg_names
                       if "@RECOMP" in n).split("@RECOMP")[0]]
        assert clone._uid == src._uid and clone.type == src.type


def test_recomputed_dropout_draws_its_forwards_mask():
    """The forward dropout op's Mask and its recomputed clone's Mask, both
    fetched in the same steps: equal at every step, and other from step
    to step."""
    with p_unique_name.guard():
        main, start, loss = _build(pf, True)
    ops = main.global_block.ops
    drop = [op for op in ops if op.type == "dropout"]
    assert len(drop) == 2, [op.outputs for op in drop]
    fwd_mask, rec_mask = (op.outputs["Mask"][0] for op in drop)
    assert "@RECOMP" in rec_mask and drop[0]._uid == drop[1]._uid
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    pf.seed(3)
    exe.run(start, scope=scope)
    masks = [exe.run(main, feed=_feed(), fetch_list=[fwd_mask, rec_mask],
                     scope=scope) for _ in range(3)]
    for f, r in masks:
        np.testing.assert_array_equal(f, r)
        assert 0 < f.mean() < 1
    assert not np.array_equal(masks[0][0], masks[1][0])


def test_recompute_requires_checkpoints():
    main, start = pf.Program(), pf.Program()
    with pf.program_guard(main, start):
        x = pf.layers.data("x", shape=(4,), dtype="float32")
        loss = pf.layers.mean(pf.layers.fc(x, size=1))
        opt = pf.optimizer.RecomputeOptimizer(pf.optimizer.SGD(0.1))
        with pytest.raises(ValueError, match="checkpoints"):
            opt.minimize(loss)


def test_barrier_output_outlives_its_input():
    """optimization_barrier's Out is X's tensor; the Executor drops X
    after its last reader and Out still reads the values."""
    blk = pf.Program().global_block
    blk.create_var(name="x", shape=(3,), dtype="float32")
    op = blk.append_op("optimization_barrier", {"X": ["x"]},
                       {"Out": ["y"]}, {})
    env = {"x": torch.tensor([1.0, 2.0, 3.0])}
    p_registry.run_op(op, env, torch.device("cpu"))
    del env["x"]
    assert torch.equal(env["y"], torch.tensor([1.0, 2.0, 3.0]))


def test_last_use_plan_frees_non_checkpoints_in_the_forward():
    """With recompute every forward activation but the checkpoints (and
    the values read across segments) is last read by a forward op, so
    the run drops it before the backward starts; without recompute the
    grad ops read them."""
    def last_reads(recompute):
        with p_unique_name.guard():
            main, _, _ = _build(pf, False, recompute=recompute)
        ops = main.global_block.ops
        first_bwd = next(i for i, op in enumerate(ops)
                         if op.attrs.get("op_role") == "backward")
        plan = p_executor._last_use_plan_py(main.global_block, ["x", "y"],
                                            [])
        freed_at = {n: i for i, names in enumerate(plan) for n in names}
        acts = [op.outputs["Out"][0] for op in ops[:first_bwd]
                if op.type == "relu"]
        return {a: freed_at[a] < first_bwd for a in acts}

    plain, ck = last_reads(False), last_reads(True)
    assert not any(plain.values())
    # h1 and h2 (the relus of layers 1 and 3) are recomputed; the
    # checkpoints c1 and c2 stay for the backward
    assert sorted(ck.values()) == [False, False, True, True]


def _pair(build):
    with j_unique_name.guard():
        jmain, jstart, jloss = build(jf, JT)
    with p_unique_name.guard():
        pmain, pstart, ploss = build(pf, PT)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    names = [n for n, v in jstart.global_block.vars.items() if v.persistable]
    state = {n: np.asarray(jscope.find_var(n).get_tensor()) for n in names}
    pscope = pf.Scope()
    pf.load_numpy_params(pscope, state, pf.CPUPlace())
    return (jmain, jloss, jexe, jscope), (pmain, ploss,
                                           pf.Executor(pf.CPUPlace()),
                                           pscope)


def _ops(prog):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
            for op in prog.global_block.ops]


def _losses(side, feed, steps):
    main, loss, exe, scope = side
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0]).reshape(-1)[0])
            for _ in range(steps)]


def test_recompute_fc_matches_reference():
    j, p = _pair(lambda pkg, _: _build(pkg, False, skip=True))
    assert _ops(p[0]) == _ops(j[0])
    np.testing.assert_allclose(_losses(p, _feed(), STEPS),
                               _losses(j, _feed(), STEPS), rtol=1e-5)


def test_recompute_transformer_matches_reference():
    """build_program(recompute=True) in both packages: the same program,
    op for op, and 3 Adam steps' losses within 1e-5."""
    j, p = _pair(lambda pkg, T: T.build_program(
        warmup_steps=100, dropout_rate=0.0, recompute=True, **CFG))
    assert _ops(p[0]) == _ops(j[0])
    types = [op.type for op in p[0].global_block.ops]
    assert types.count("optimization_barrier") > 0
    r = np.random.RandomState(7)
    feed = {k: r.randint(0, CFG["vocab"], (4, CFG["seq_len"])).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}
    np.testing.assert_allclose(_losses(p, feed, 3), _losses(j, feed, 3),
                               rtol=1e-5)


def test_recompute_transformer_with_dropout_matches_plain_in_run_steps():
    """The recompute Transformer at dropout 0.1 through run_steps (eager
    on the CPU) against the same program without recompute, from the same
    weights and step keys: the recomputed attention and FFN dropout draw
    their forwards' masks, so the losses agree."""
    losses = []
    for recompute in (False, True):
        with p_unique_name.guard():
            main, start, cost = PT.build_program(
                warmup_steps=100, dropout_rate=0.1, recompute=recompute,
                **CFG)
        exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
        pf.seed(11)
        exe.run(start, scope=scope)
        r = np.random.RandomState(7)
        feed = {k: r.randint(0, CFG["vocab"], (4, CFG["seq_len"])).astype(
            "int64") for k in ("src_ids", "tgt_ids", "label")}
        out = exe.run_steps(main, feed=feed, fetch_list=[cost], steps=3,
                            scope=scope)
        losses.append(np.asarray(out[0]).reshape(-1))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    assert len(set(losses[0].tolist())) == 3


def _recompute_clip_l2_program(pkg, T, clip_mod, reg_mod, clip_norm):
    """chip_smoke.py's recompute leg at a small width, built the same way
    in both packages: transformer(checkpoints=ck) under
    RecomputeOptimizer(Adam(noam_decay, regularization=L2Decay(1e-4)))
    with set_gradient_clip(GradientClipByGlobalNorm(clip_norm))."""
    seq = CFG["seq_len"]
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start):
        src, tgt, label = (pkg.layers.data(n, shape=[seq], dtype="int64")
                           for n in ("src_ids", "tgt_ids", "label"))
        ck = []
        cost, _ = T.transformer(
            src, tgt, label, src_vocab=CFG["vocab"], tgt_vocab=CFG["vocab"],
            max_len=256, d_model=CFG["d_model"], n_heads=CFG["n_heads"],
            n_layers=CFG["n_layers"], d_inner=CFG["d_inner"],
            dropout_rate=0.0, checkpoints=ck)
        lr = pkg.layers.learning_rate_scheduler.noam_decay(CFG["d_model"],
                                                           100)
        opt = pkg.optimizer.Adam(learning_rate=lr, beta1=0.9, beta2=0.997,
                                 epsilon=1e-9,
                                 regularization=reg_mod.L2Decay(1e-4))
        clip_mod.set_gradient_clip(
            clip_mod.GradientClipByGlobalNorm(clip_norm))
        opt = pkg.optimizer.RecomputeOptimizer(opt)
        opt._set_checkpoints(ck)
        opt.minimize(cost)
    return main, start, cost


def test_recompute_clip_l2_transformer_matches_reference():
    """The card's recompute leg at a small width: the same program in
    both packages op for op, 3 Adam steps' losses within 1e-5, and the
    clip scaling (its scale below 1: clip_norm is a quarter of the step-1
    global gradient norm, about 1.1 here)."""
    from paddle_tpu import clip as j_clip
    from paddle_tpu import regularizer as j_reg
    from paddle_tpu_torch import clip as p_clip
    from paddle_tpu_torch import regularizer as p_reg

    try:
        j, p = _pair(lambda pkg, T: _recompute_clip_l2_program(
            pkg, T, *((j_clip, j_reg) if pkg is jf else (p_clip, p_reg)),
            0.25))
        assert _ops(p[0]) == _ops(j[0])
        r = np.random.RandomState(7)
        feed = {k: r.randint(0, CFG["vocab"], (4, CFG["seq_len"])).astype(
            "int64") for k in ("src_ids", "tgt_ids", "label")}
        np.testing.assert_allclose(_losses(p, feed, 3), _losses(j, feed, 3),
                                   rtol=1e-5)
        main, _, exe, scope = p
        gnorm = next(n for n in main.global_block.vars
                     if n.endswith("@GNORM"))
        norm, scale = exe.run(main, feed=feed,
                              fetch_list=[gnorm, gnorm + "@SCALE"],
                              scope=scope)
        assert float(norm[0]) > 0.25 and float(scale[0]) < 1
        np.testing.assert_allclose(scale[0], 0.25 / norm[0], rtol=1e-6)
    finally:
        j_clip._clip_attr.clear()
