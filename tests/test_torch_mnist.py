"""The MNIST fc net of the port (``models/mnist.py``: 784 -> hidden ->
10, ReLU, softmax_with_cross_entropy, top-1 accuracy) trained with SGD
against the JAX package's, at widths 784-32-16-10 and batch 64.

Both packages start from the JAX package's initial weights (carried
across with ``load_numpy_params``) and take 20 SGD steps (lr 0.5) on the
same 20 batches: synthetic and separable, bench.py's MNIST recipe on
[784] images (noise of 0.1, and 2.0 added at the pixel the label
names).

Tolerances: the loss within 1e-5 relative at step 1 and 1e-4 at step
20 (fp32 sums in another order, compounded over 20 updates); the
accuracy op's Correct equal at every step, except that a row whose
top-2 margin in the JAX package's softmax is below 1e-5 may count apart
(rounding may order a near tie either way).

On the card (marked ``gpu``; ``python -m pytest --noconftest -m gpu
tests/test_torch_mnist.py``, the JAX package imported only by the tests
that read it): step 1 against the port's CPU run (loss 1e-5 relative),
20 steps through ``run_steps`` (one capture) against 20 eager steps
there within 1e-6, and the xent kernels launched once each a step.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pf
from paddle_tpu_torch.models import mnist as PM

HIDDEN = (32, 16)
BATCH = 64
STEPS = 20
LR = 0.5
TIE = 1e-5


def _jax_pkg():
    """The JAX package and its MNIST models, imported only by the tests
    that read them: the card's machine has no JAX."""
    import paddle_tpu
    from paddle_tpu.models import mnist

    return paddle_tpu, mnist


def _batches(n=STEPS, batch=BATCH, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = r.randint(0, 10, (batch, 1)).astype(np.int64)
        img = r.randn(batch, 784).astype(np.float32) * 0.1
        img[np.arange(batch), lab[:, 0]] += 2.0
        out.append({"img": img, "label": lab})
    return out


def _program(pkg, models):
    """(main, startup, fetch list: loss, accuracy, Correct, logits)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data("img", shape=[784], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        loss, acc, logits = models.mlp(img, label, hidden_sizes=HIDDEN)
        pkg.optimizer.SGD(learning_rate=LR).minimize(loss)
    acc_op, = [op for op in main.global_block.ops if op.type == "accuracy"]
    return main, startup, [loss, acc, acc_op.outputs["Correct"][0], logits]


def _softmax_margin(logits):
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    top2 = np.sort(p, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.fixture(scope="module")
def trained():
    """20 steps in each package: {package: [(loss, acc, correct, logits)
    per step]}, and the JAX package's initial state."""
    jf, jm = _jax_pkg()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    res, state = {}, None
    for pkg, models in ((jf, jm), (pf, PM)):
        main, startup, fetch = _program(pkg, models)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        if pkg is jf:
            exe.run(startup, scope=scope)
            names = [n for n, v in startup.global_block.vars.items()
                     if v.persistable]
            state = {n: np.asarray(scope.find_var(n).get_tensor())
                     for n in names}
        else:
            pf.load_numpy_params(scope, state, pf.CPUPlace())
        res[pkg.__name__] = [
            [np.asarray(v) for v in exe.run(main, feed=b, fetch_list=fetch,
                                            scope=scope)]
            for b in _batches()]
    torch.set_num_threads(n)
    return res, state


def test_losses_match_reference(trained):
    res, _ = trained
    jl = np.array([s[0].reshape(-1)[0] for s in res["paddle_tpu"]])
    pl = np.array([s[0].reshape(-1)[0] for s in res["paddle_tpu_torch"]])
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl[-1], jl[-1], rtol=1e-4)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0] / 2  # it learns the separable batches


def test_correct_matches_reference_but_for_ties(trained):
    """Correct equal at every step, apart from rows the reference's
    softmax leaves within TIE of a tie; Accuracy = Correct / Total."""
    res, _ = trained
    for i, (j, p) in enumerate(zip(res["paddle_tpu"],
                                   res["paddle_tpu_torch"])):
        assert p[2].dtype == np.int32 and p[2].shape == (1,)
        assert p[1].dtype == np.float32 and p[1].shape == (1,)
        ties = int(np.sum(_softmax_margin(j[3]) < TIE))
        assert abs(int(p[2][0]) - int(j[2][0])) <= ties, (i, p[2], j[2])
        np.testing.assert_allclose(p[1][0], p[2][0] / BATCH, rtol=1e-7)
    accs = [s[1][0] for s in res["paddle_tpu_torch"]]
    assert accs[-1] > max(0.5, accs[0])


def test_build_program_matches_reference_ops():
    """build_program(use_conv=False): the same ops, in order, with the
    same parameter names as the JAX package's; the default builds the
    conv net (held op by op in tests/test_torch_conv_mnist.py)."""
    jf, jm = _jax_pkg()
    with jf.unique_name.guard():
        jmain, jstart, _, _ = jm.build_program(use_conv=False)
    with pf.unique_name.guard():
        pmain, pstart, loss, acc = PM.build_program(use_conv=False)
    assert [o.type for o in pmain.global_block.ops] == \
        [o.type for o in jmain.global_block.ops]
    assert sorted(p.name for p in pmain.all_parameters()) == \
        sorted(p.name for p in jmain.all_parameters())
    assert [p.shape for p in pmain.all_parameters()] == [
        (784, 128), (128,), (128, 64), (64,), (64, 10), (10,)]
    with pf.unique_name.guard():
        cmain = PM.build_program()[0]
    assert [o.type for o in cmain.global_block.ops][:4] == [
        "conv2d", "elementwise_add", "relu", "pool2d"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_mnist.py`")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fc_net_on_the_card(cuda):
    from paddle_tpu_torch.ops.kernels import xent as KX

    main, startup, fetch = _program(pf, PM)
    startup.random_seed = 11
    init = pf.Scope()
    pf.Executor(pf.CPUPlace()).run(startup, scope=init)
    names = [n for n, v in startup.global_block.vars.items()
             if v.persistable]
    state = pf.scope_to_numpy(init, names)
    batches = _batches()

    def scope_on(place):
        sc = pf.Scope()
        pf.load_numpy_params(sc, state, place)
        return sc

    cpu = pf.Executor(pf.CPUPlace())
    want = cpu.run(main, feed=batches[0], fetch_list=fetch[:1],
                   scope=scope_on(pf.CPUPlace()))[0]
    exe = pf.Executor(pf.CUDAPlace(0))
    sc = scope_on(pf.CUDAPlace(0))
    KX.xent_forward.launches = KX.xent_backward.launches = 0
    eager = [exe.run(main, feed=b, fetch_list=fetch[:1], scope=sc)[0]
             for b in batches]
    assert KX.xent_forward.launches == KX.xent_backward.launches == STEPS
    np.testing.assert_allclose(eager[0], want, rtol=1e-5)
    sc = scope_on(pf.CUDAPlace(0))
    steps, = exe.run_steps(main, feed=batches, fetch_list=fetch[:1],
                           scope=sc)
    assert exe.compile_count == 1 and exe.last_run_steps_fallback is None
    np.testing.assert_allclose(steps.reshape(-1),
                               np.array(eager).reshape(-1), rtol=1e-6)
    assert steps.reshape(-1)[-1] < steps.reshape(-1)[0]
