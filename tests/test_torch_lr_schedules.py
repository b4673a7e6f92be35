"""The learning-rate schedules of the port
(``layers/learning_rate_scheduler.py``) against the JAX package's.

Each schedule is built alone in a program of each package, and the
program is run 12 times: the rate fetched at steps 1-12 (the step
counter advances before the rate is computed), with `staircase` and
`cycle` on and off and piecewise_decay's boundaries among the steps.

Tolerances: 1e-6 relative (fp32; a pow, exp or cos of the same float32
argument may differ in its last bit between the two libraries), and
piecewise_decay's values exactly. Under ``run_steps`` the port's rates
equal its K ``run`` calls bit for bit (the same ops in the same order).
On the card (marked ``gpu``; ``python -m pytest --noconftest -m gpu
tests/test_torch_lr_schedules.py``, the JAX package imported only by the
tests that read it): every schedule's rates against the port's CPU run
within 1e-6 relative, and a captured ``run_steps`` call against K
``run`` calls there bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf

STEPS = 12
RTOL = 1e-6

SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.1, 4, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 4, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.7),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.7, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 5, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 5, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 8, 0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 5, 0.001,
                                                     power=1.5, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 6, 10],
                                             [0.1, 0.05, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "linear_warmup_over_exponential": lambda L: L.linear_lr_warmup(
        L.exponential_decay(0.1, 4, 0.5), 5, 0.01, 0.1),
    "noam": lambda L: L.noam_decay(64, 4),
}


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


def _build(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        lr = SCHEDULES[name](pkg.layers)
    return main, startup, lr


def _rates(pkg, name, place=None):
    main, startup, lr = _build(pkg, name)
    scope = pkg.Scope()
    exe = pkg.Executor(place or pkg.CPUPlace())
    exe.run(startup, scope=scope)
    return np.array([np.asarray(exe.run(main, fetch_list=[lr],
                                        scope=scope)[0]).reshape(-1)
                     for _ in range(STEPS)])


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    got, want = _rates(pf, name), _rates(_jax_pkg(), name)
    assert got.shape == want.shape == (STEPS, 1)
    assert got.dtype == want.dtype == np.float32
    if name == "piecewise":
        np.testing.assert_array_equal(got, want)
        # steps 1-2, 3-5, 6-9, 10-12: a boundary step takes the next value
        np.testing.assert_array_equal(
            got[:, 0], np.float32([0.1] * 2 + [0.05] * 3 + [0.01] * 4
                                  + [0.001] * 3))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert np.all(np.isfinite(got))


def test_schedules_move_with_the_step():
    """Staircase holds the rate within a period and steps at its end;
    cycle restarts polynomial_decay past decay_steps; the warmup reaches
    its target."""
    stair = _rates(pf, "exponential_staircase")[:, 0]
    assert stair[0] == stair[2] and stair[3] < stair[2]
    cyc = _rates(pf, "polynomial_cycle")[:, 0]
    assert cyc[5] > cyc[4]  # step 6 opens the second cycle
    warm = _rates(pf, "linear_warmup")[:, 0]
    np.testing.assert_allclose(warm[4:], 0.1, rtol=RTOL)
    assert np.all(np.diff(warm[:5]) > 0)


def test_schedule_under_run_steps_equals_k_runs():
    """K steps of a schedule through run_steps: the rates K run calls
    fetch, bit for bit, and the counter where K runs leave it."""
    k = 7
    main, startup, lr = _build(pf, "cosine")
    exe = pf.Executor(pf.CPUPlace())
    a, b = pf.Scope(), pf.Scope()
    exe.run(startup, scope=a)
    exe.run(startup, scope=b)
    by_run = np.array([exe.run(main, fetch_list=[lr], scope=a)[0]
                       for _ in range(k)])
    stacked, = exe.run_steps(main, fetch_list=[lr], steps=k, scope=b)
    np.testing.assert_array_equal(stacked, by_run)
    counter = "@LR_DECAY_COUNTER@"
    assert float(b._get(counter)) == float(a._get(counter)) == k


def test_append_lars_matches_reference():
    """append_LARS's rate lr |w| / (|g| + wd |w|) for two (w, g) pairs,
    against the JAX package's and the closed form."""
    rs = np.random.RandomState(0)
    feed = {"w0": rs.randn(4, 3).astype("float32"),
            "g0": rs.randn(4, 3).astype("float32"),
            "w1": rs.randn(5).astype("float32"),
            "g1": rs.randn(5).astype("float32")}
    outs = []
    for pkg in (pf, _jax_pkg()):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            v = {n: pkg.layers.data(n, shape=list(a.shape), dtype="float32",
                                    append_batch_size=False)
                 for n, a in feed.items()}
            lrs = pkg.layers.append_LARS([(v["w0"], v["g0"]),
                                          (v["w1"], v["g1"])],
                                         learning_rate=0.1,
                                         weight_decay=0.25)
        exe = pkg.Executor(pkg.CPUPlace())
        outs.append([np.asarray(x).reshape(-1) for x in
                     exe.run(main, feed=feed, fetch_list=lrs,
                             scope=pkg.Scope())])
    for i, (got, want) in enumerate(zip(*outs)):
        np.testing.assert_allclose(got, want, rtol=RTOL)
        wn = np.linalg.norm(feed[f"w{i}"].astype(np.float64))
        gn = np.linalg.norm(feed[f"g{i}"].astype(np.float64))
        np.testing.assert_allclose(got, 0.1 * wn / (gn + 0.25 * wn),
                                   rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_lr_schedules.py`")
    return torch.device("cuda")


@pytest.mark.gpu
def test_schedules_on_the_card_match_cpu(cuda):
    for name in sorted(SCHEDULES):
        got = _rates(pf, name, pf.CUDAPlace(0))
        want = _rates(pf, name)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0,
                                   err_msg=name)


@pytest.mark.gpu
def test_captured_schedule_equals_k_runs_on_the_card(cuda):
    """run_steps on the card captures one step (compile_count 1) and its
    rates equal K eager runs there bit for bit."""
    k = 7
    main, startup, lr = _build(pf, "polynomial_cycle")
    exe = pf.Executor(pf.CUDAPlace(0))
    a, b = pf.Scope(), pf.Scope()
    exe.run(startup, scope=a)
    exe.run(startup, scope=b)
    by_run = np.array([exe.run(main, fetch_list=[lr], scope=a)[0]
                       for _ in range(k)])
    stacked, = exe.run_steps(main, fetch_list=[lr], steps=k, scope=b)
    assert exe.compile_count == 1 and exe.last_run_steps_fallback is None
    np.testing.assert_array_equal(stacked, by_run)
