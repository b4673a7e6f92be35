"""GradientMergeOptimizer, ModelAverage, ExponentialMovingAverage,
DGCMomentumOptimizer and the dgc, dgc_clip_by_norm and dpsgd ops of the
port against the JAX package's, and the distributions of
gaussian_random, XavierInitializer(uniform=False) and dpsgd's noise, on
the CPU.

The model: a 20 -> 16 -> 4 fc net with softmax cross-entropy, batches
of 8 from seeded numpy, both packages from the JAX package's initial
weights. Tolerances: losses and parameters within 1e-5 (fp32 sums in
another order over a few updates); averages within 1e-6 of a numpy
recomputation. The distributions: mean and std within 3 standard errors
of their targets (the standard error of a std taken as std / sqrt(2n)),
the same bits from the same seed, other bits from another.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf

from paddle_tpu_torch.layer_helper import LayerHelper

from torch_op_test import op_case

TOL = 1e-5
IN, HID, OUT, BATCH = 20, 16, 4, 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=0):
    r = np.random.RandomState(seed)
    return [{"x": r.randn(BATCH, IN).astype(np.float32),
             "y": r.randint(0, OUT, (BATCH, 1)).astype(np.int64)}
            for _ in range(n)]


def _net(pkg, make_opt, average=None):
    """(main, startup, loss, params, averager) of the fc net under the
    optimizer `make_opt(pkg)` builds; `average(pkg)` adds an averager
    after the optimizer."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[IN], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, HID, act="relu",
                          param_attr=pkg.ParamAttr(do_model_average=True),
                          bias_attr=pkg.ParamAttr(do_model_average=True))
        logits = pkg.layers.fc(
            h, OUT, param_attr=pkg.ParamAttr(do_model_average=True),
            bias_attr=pkg.ParamAttr(do_model_average=True))
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        make_opt(pkg).minimize(loss)
        avg = average(pkg) if average is not None else None
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, loss, params, avg


def _init_state(startup):
    """The JAX package's initial weights of `startup`."""
    scope = jf.Scope()
    startup.random_seed = 11
    jf.Executor(jf.CPUPlace()).run(startup, scope=scope)
    return {n: np.asarray(scope._get(n))
            for n, v in startup.global_block.vars.items() if v.persistable}


def _train(make_opt, steps, average=None, fetch_extra=()):
    """Both packages: {pkg name: (losses, final params, scope, net)}."""
    out, state = {}, None
    for pkg in (jf, pf):
        main, startup, loss, params, avg = _net(pkg, make_opt, average)
        if state is None:
            state = _init_state(startup)
        scope = pkg.Scope()
        if pkg is jf:
            for n, a in state.items():
                scope._set(n, a)
        else:
            pf.load_numpy_params(scope, state, pf.CPUPlace())
        exe = pkg.Executor(pkg.CPUPlace())
        losses, extras = [], []
        for b in _batches(steps):
            vals = exe.run(main, feed=b, fetch_list=[loss, *fetch_extra],
                           scope=scope)
            losses.append(float(np.asarray(vals[0]).reshape(-1)[0]))
            extras.append([np.asarray(v) for v in vals[1:]])
        final = {n: np.asarray(scope.find_var(n).get_tensor())
                 for n in params}
        out[pkg.__name__] = dict(losses=np.array(losses), params=final,
                                 scope=scope, avg=avg, main=main,
                                 extras=extras)
    return out


def _agree(res):
    j, p = res["paddle_tpu"], res["paddle_tpu_torch"]
    np.testing.assert_allclose(p["losses"], j["losses"], rtol=TOL)
    for n in j["params"]:
        np.testing.assert_allclose(p["params"][n], j["params"][n], rtol=0,
                                   atol=TOL, err_msg=n)


# --- GradientMerge -----------------------------------------------------------
@pytest.mark.parametrize("k", [1, 4])
def test_gradient_merge_matches_jax(k):
    def make(pkg):
        return pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.Adam(learning_rate=0.05), k_steps=k)

    res = _train(make, 8, fetch_extra=["fc_0.w_0"])
    _agree(res)
    p = res["paddle_tpu_torch"]
    ops = [o.type for o in p["main"].global_block.ops]
    assert ops.count("run_block_if") == 1 and "adam" not in ops
    # the weights move on apply steps only: every k-th step
    ws = [e[0] for e in p["extras"]]
    for i in range(1, len(ws)):
        moved = not np.array_equal(ws[i], ws[i - 1])
        assert moved == ((i + 1) % k == 0), (k, i)


def test_gradient_merge_state_holds_between_applies():
    """Adam's moments and beta powers do not move on a step that does
    not apply; the merged gradient is cleared on one that does."""
    def make(pkg):
        return pkg.optimizer.GradientMergeOptimizer(
            pkg.optimizer.Adam(learning_rate=0.05), k_steps=3)

    main, startup, loss, params, _ = _net(pf, make)
    moments = sorted(n for n in startup.global_block.vars
                     if "moment1" in n or "beta1_pow" in n)
    merges = sorted(n for n in startup.global_block.vars if "MERGE" in n)
    assert moments and merges
    scope, exe = pf.Scope(), pf.Executor(pf.CPUPlace())
    exe.run(startup, scope=scope)
    seen = []
    for b in _batches(3):
        exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        seen.append({n: scope._get(n).clone()
                     for n in moments + merges})
    for n in moments:
        assert torch.equal(seen[0][n], seen[1][n]), n
        assert not torch.equal(seen[1][n], seen[2][n]), n
    for n in merges:
        assert not torch.equal(seen[0][n], seen[1][n]), n
        assert float(seen[2][n].abs().max()) == 0.0, n


# --- ModelAverage and EMA ----------------------------------------------------
def _applied(res, pkg):
    """The parameters inside `apply()` and after it."""
    r = res[pkg.__name__]
    names = sorted(r["params"])
    with pkg.scope_guard(r["scope"]):
        with r["avg"].apply(None):
            inside = {n: np.asarray(r["scope"].find_var(n).get_tensor())
                      for n in names}
        after = {n: np.asarray(r["scope"].find_var(n).get_tensor())
                 for n in names}
    return inside, after


@pytest.mark.parametrize("kind", ["model_average", "ema"])
def test_averages_apply_and_restore_as_jax(kind):
    steps = 4

    def average(pkg):
        if kind == "ema":
            return pkg.optimizer.ExponentialMovingAverage(0.8)
        return pkg.optimizer.ModelAverage(0.15)

    def make(pkg):
        return pkg.optimizer.SGD(learning_rate=0.2)

    names = ["fc_0.w_0", "fc_0.b_0", "fc_1.w_0", "fc_1.b_0"]
    res = _train(make, steps, average=average, fetch_extra=names)
    _agree(res)
    p_in, p_after = _applied(res, pf)
    j_in, j_after = _applied(res, jf)
    for n in names:
        np.testing.assert_allclose(p_in[n], j_in[n], rtol=0, atol=TOL)
        # restore puts the trained weights back
        np.testing.assert_array_equal(p_after[n],
                                      res["paddle_tpu_torch"]["params"][n])
        # numpy from the fetched per-step parameters
        hist = [e[names.index(n)] for e in
                res["paddle_tpu_torch"]["extras"]]
        if kind == "ema":
            want = np.zeros_like(hist[0])
            for h in hist:
                want = np.float32(0.8) * want + np.float32(0.2) * h
        else:
            want = np.sum(hist, axis=0) / steps
        np.testing.assert_allclose(p_in[n], want, rtol=0, atol=1e-6,
                                   err_msg=n)


# --- DGC -------------------------------------------------------------------
def test_dgc_before_rampup_is_momentum():
    def dgc(pkg):
        return pkg.optimizer.DGCMomentumOptimizer(
            0.1, 0.9, rampup_begin_step=100, sparsity=[0.9])

    def mom(pkg):
        return pkg.optimizer.Momentum(0.1, 0.9)

    a = _train(dgc, 5)["paddle_tpu_torch"]
    b = _train(mom, 5)["paddle_tpu_torch"]
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for n in a["params"]:
        np.testing.assert_array_equal(a["params"][n], b["params"][n])


@pytest.mark.parametrize("nesterov,clip", [(False, None), (True, 0.5)])
def test_dgc_after_rampup_matches_jax(nesterov, clip):
    def make(pkg):
        return pkg.optimizer.DGCMomentumOptimizer(
            0.1, 0.9, rampup_begin_step=2, rampup_step=3,
            sparsity=[0.5, 0.75, 0.9], use_nesterov=nesterov,
            local_grad_clip_norm=clip)

    res = _train(make, 8)
    _agree(res)
    ops = [o.type for o in res["paddle_tpu_torch"]["main"].global_block.ops]
    assert ops.count("dgc_momentum") == 4


def _dgc_inputs(seed, step, n=(6, 7)):
    r = np.random.RandomState(seed)
    return {"U": r.randn(*n).astype(np.float32),
            "V": r.randn(*n).astype(np.float32),
            "Grad": r.randn(*n).astype(np.float32),
            "current_step": np.array([step], np.float32)}


@pytest.mark.parametrize("step,nesterov", [(0, True), (3, True), (3, False),
                                           (9, False)])
def test_dgc_op_matches_jax(step, nesterov):
    case = op_case("dgc", _dgc_inputs(step, step),
                   {"m": 0.9, "sparsity": [0.3, 0.6, 0.95],
                    "rampup_begin_step": 2.0, "rampup_step": 4.0,
                    "use_nesterov": nesterov},
                   outputs=("U_out", "V_out", "EncodeGrad", "Grad_out",
                            "k"))
    got = case.check_output(rtol=TOL, atol=TOL)
    assert (float(got["k"]) == 0.0) == (step < 2)


@pytest.mark.parametrize("step", [0, 5])
def test_dgc_clip_by_norm_matches_jax(step):
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    case = op_case("dgc_clip_by_norm",
                   {"X": x, "current_step": np.array([step], np.float32)},
                   {"max_norm": 1.0, "rampup_begin_step": 3.0})
    got = case.check_output(rtol=TOL, atol=TOL)
    norm = float(np.sqrt((got["Out"] ** 2).sum()))
    assert (abs(norm - 1.0) < 1e-5) == (step >= 3)


def test_quantile_matches_jnp_at_large_sizes():
    """The sort-based quantile of parallel/dgc.py against jnp.quantile,
    on sizes with and without an exact order statistic."""
    import jax.numpy as jnp

    from paddle_tpu_torch.parallel import dgc as PDGC

    r = np.random.RandomState(0)
    for n in (1, 2, 999, 100003):
        x = np.abs(r.randn(n)).astype(np.float32)
        for q in (0.0, 0.5, 0.999, 1.0):
            got = float(PDGC.quantile(torch.from_numpy(x),
                                      torch.tensor(q)))
            want = float(jnp.quantile(jnp.asarray(x), jnp.float32(q)))
            assert got == want, (n, q, got, want)


# --- distributions -----------------------------------------------------------
def _moments_ok(a, mean, std):
    a = np.asarray(a, np.float64).reshape(-1)
    n = a.size
    assert abs(a.mean() - mean) <= 3 * std / np.sqrt(n), a.mean()
    assert abs(a.std() - std) <= 3 * std / np.sqrt(2 * n), a.std()


def _startup_draw(make_init, shape, seed):
    """Run a startup program holding one parameter made by
    `make_init()`: its values."""
    main, startup = pf.Program(), pf.Program()
    with pf.unique_name.guard(), pf.program_guard(main, startup):
        LayerHelper("w").create_parameter(
            pf.ParamAttr(name="w", initializer=make_init()), shape,
            "float32")
    startup.random_seed = seed
    scope = pf.Scope()
    pf.Executor(pf.CPUPlace()).run(startup, scope=scope)
    return scope._get("w").numpy()


def test_gaussian_random_distribution():
    shape = [200, 100]

    def draw(seed, op_seed=0):
        main, startup = pf.Program(), pf.Program()
        with pf.unique_name.guard(), pf.program_guard(main, startup):
            out = pf.layers.gaussian_random(shape, mean=0.5, std=2.0,
                                            seed=op_seed)
        main.random_seed = seed
        return pf.Executor(pf.CPUPlace()).run(
            main, fetch_list=[out], scope=pf.Scope())[0]

    a, b, c = draw(1), draw(1), draw(2)
    assert a.shape == tuple(shape) and a.dtype == np.float32
    _moments_ok(a, 0.5, 2.0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # a nonzero seed attr pins the draw whatever the program's seed
    np.testing.assert_array_equal(draw(1, op_seed=9), draw(2, op_seed=9))


def test_xavier_normal_distribution():
    from paddle_tpu_torch.initializer import (NormalInitializer,
                                              XavierInitializer)

    shape = [300, 200]
    a = _startup_draw(lambda: XavierInitializer(uniform=False), shape, 1)
    b = _startup_draw(lambda: XavierInitializer(uniform=False), shape, 1)
    c = _startup_draw(lambda: XavierInitializer(uniform=False), shape, 2)
    _moments_ok(a, 0.0, np.sqrt(2.0 / (300 + 200)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    n = _startup_draw(lambda: NormalInitializer(1.0, 0.5), [40000], 3)
    _moments_ok(n, 1.0, 0.5)


def test_dpsgd_noise_distribution():
    """Param 0, Grad 0 and rate -1: ParamOut is the noise alone, std
    sigma * clip, drawn from the device step key."""
    shape = [100, 100]

    def run(prog_seed, steps=1):
        main, startup = pf.Program(), pf.Program()
        with pf.unique_name.guard(), pf.program_guard(main, startup):
            blk = main.global_block
            for n, s, v in (("p", shape, 0.0), ("g", shape, 0.0),
                            ("lr", [1], -1.0)):
                pf.layers.fill_constant(s, "float32", v,
                                        out=blk.create_var(
                                            name=n, shape=s,
                                            dtype="float32"))
            blk.create_var(name="out", shape=shape, dtype="float32")
            blk.append_op("dpsgd", {"Param": "p", "Grad": "g",
                                    "LearningRate": "lr"},
                          {"ParamOut": "out"},
                          {"clip": 2.0, "sigma": 1.5})
        main.random_seed = prog_seed
        exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
        return [exe.run(main, fetch_list=["out"], scope=scope)[0]
                for _ in range(steps)]

    (a, a2), (b, _), (c, _) = run(1, 2), run(1, 2), run(2, 2)
    _moments_ok(a, 0.0, 3.0)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # each step draws anew
    assert not np.array_equal(a, a2)
    _moments_ok(a2, 0.0, 3.0)


def test_dpsgd_clips_the_gradient():
    """With sigma 0 the update is the clipped gradient's."""
    r = np.random.RandomState(0)
    p = r.randn(6, 5).astype(np.float32)
    g = 10 * r.randn(6, 5).astype(np.float32)
    main, startup = pf.Program(), pf.Program()
    with pf.unique_name.guard(), pf.program_guard(main, startup):
        blk = main.global_block
        for n in ("p", "g", "lr"):
            blk.create_var(name=n, dtype="float32", is_data=True,
                           shape=(6, 5) if n != "lr" else (1,))
        blk.create_var(name="out", dtype="float32", shape=(6, 5))
        blk.append_op("dpsgd", {"Param": "p", "Grad": "g",
                                "LearningRate": "lr"},
                      {"ParamOut": "out"}, {"clip": 1.0, "sigma": 0.0})
    out = pf.Executor(pf.CPUPlace()).run(
        main, feed={"p": p, "g": g, "lr": np.array([0.5], np.float32)},
        fetch_list=["out"], scope=pf.Scope())[0]
    want = p - 0.5 * g / np.sqrt((g.astype(np.float64) ** 2).sum())
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)
