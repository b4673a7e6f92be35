"""conv2d, depthwise_conv2d and pool2d, and the MNIST conv net
(``models/mnist.py`` cnn_model: two 5x5 conv + ReLU + 2x2 max-pool
stages of 20 and 50 filters, fc to 10) against the JAX package's, on the
CPU.

The ops one at a time through ``tests/torch_op_test.py`` (stride,
padding, dilation, groups; max and avg pooling, exclusive with padding,
global, ties in a max window): outputs and the grads of every float
input within 1e-5 of the JAX package's (fp32 sums over a window in
another order). The net from the JAX package's initial weights on the
same seeded batch of 16 [1, 28, 28] images: the step-1 loss and every
parameter's grad within 1e-5, then 5 SGD steps' losses within 1e-5
relative.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu.models import mnist as JM
from paddle_tpu_torch.models import mnist as PM

from torch_op_test import op_case

TOL = 1e-5
BATCH, STEPS, LR = 16, 5, 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


CONV_CASES = {
    "plain_3x3": ("conv2d", (2, 3, 7, 7), (4, 3, 3, 3), {}),
    "stride2_pad1": ("conv2d", (2, 3, 8, 7), (5, 3, 3, 3),
                     {"strides": [2, 2], "paddings": [1, 1]}),
    "dilation2_pad2": ("conv2d", (1, 2, 9, 9), (3, 2, 3, 3),
                       {"dilations": [2, 2], "paddings": [2, 2]}),
    "groups2": ("conv2d", (2, 4, 6, 6), (6, 2, 3, 3), {"groups": 2}),
    "rect_mixed": ("conv2d", (1, 2, 9, 8), (3, 2, 3, 2),
                   {"strides": [2, 1], "paddings": [1, 0],
                    "dilations": [1, 2]}),
    "depthwise": ("depthwise_conv2d", (2, 4, 7, 7), (4, 1, 3, 3),
                  {"groups": 4, "paddings": [1, 1]}),
    "depthwise_x2_stride2": ("depthwise_conv2d", (1, 3, 8, 8),
                             (6, 1, 3, 3),
                             {"groups": 3, "strides": [2, 2]}),
}


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv(name):
    op_type, xs, ws, attrs = CONV_CASES[name]
    case = op_case(op_type, {"Input": _rand(*xs), "Filter": _rand(*ws,
                                                                seed=1)},
                   attrs, outputs=("Output",))
    case.check_output(rtol=TOL, atol=TOL)
    case.check_grad_with_reference(["Input", "Filter"], rtol=TOL, atol=TOL)


POOL_CASES = {
    "max_2x2_s2": ({"pooling_type": "max", "ksize": [2, 2],
                    "strides": [2, 2]}, False),
    "max_3x3_s2_pad1": ({"pooling_type": "max", "ksize": [3, 3],
                         "strides": [2, 2], "paddings": [1, 1]}, False),
    "max_ties": ({"pooling_type": "max", "ksize": [2, 2],
                  "strides": [1, 1]}, True),
    "max_ties_pad1": ({"pooling_type": "max", "ksize": [3, 3],
                       "strides": [2, 2], "paddings": [1, 1]}, True),
    "avg_2x2_s2": ({"pooling_type": "avg", "ksize": [2, 2],
                    "strides": [2, 2]}, False),
    "avg_3x3_pad1_exclusive": ({"pooling_type": "avg", "ksize": [3, 3],
                                "strides": [1, 1], "paddings": [1, 1],
                                "exclusive": True}, False),
    "avg_3x3_pad1_inclusive": ({"pooling_type": "avg", "ksize": [3, 3],
                                "strides": [2, 2], "paddings": [1, 1],
                                "exclusive": False}, False),
    "global_max": ({"pooling_type": "max", "global_pooling": True,
                    "ksize": [2, 2]}, False),
    "global_avg": ({"pooling_type": "avg", "global_pooling": True,
                    "ksize": [2, 2], "paddings": [1, 1]}, False),
}


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_pool2d(name):
    attrs, ties = POOL_CASES[name]
    x = _rand(2, 3, 7, 6, seed=2)
    if ties:
        # a few levels only: most max windows hold their maximum twice
        x = np.round(x * 2).astype(np.float32)
    case = op_case("pool2d", {"X": x}, attrs)
    case.check_output(rtol=TOL, atol=TOL)
    case.check_grad_with_reference(["X"], rtol=TOL, atol=TOL)


# --- the conv net ------------------------------------------------------------
def _batches(n=STEPS, seed=0):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lab = r.randint(0, 10, (BATCH, 1)).astype(np.int64)
        img = r.randn(BATCH, 1, 28, 28).astype(np.float32) * 0.1
        # the label shows as a bright 4x4 patch at its own place
        for i, c in enumerate(lab[:, 0]):
            img[i, 0, 2 + 2 * c:6 + 2 * c, 4:8] += 1.0
        out.append({"img": img, "label": lab})
    return out


def _program(pkg, models):
    with pkg.unique_name.guard():
        main, startup, loss, acc = models.build_program(use_conv=True)
        with pkg.program_guard(main, startup):
            pkg.optimizer.SGD(learning_rate=LR).minimize(loss)
    params = sorted(p.name for p in main.all_parameters())
    return main, startup, loss, params


@pytest.fixture(scope="module")
def trained():
    """Step-1 loss and grads, then STEPS losses, in each package from
    the JAX package's initial weights."""
    res = {}
    state = None
    for pkg, models in ((jf, JM), (pf, PM)):
        main, startup, loss, params = _program(pkg, models)
        exe, scope = pkg.Executor(pkg.CPUPlace()), pkg.Scope()
        if pkg is jf:
            startup.random_seed = 3
            exe.run(startup, scope=scope)
            state = {n: np.asarray(scope.find_var(n).get_tensor())
                     for n, v in startup.global_block.vars.items()
                     if v.persistable}
        else:
            pf.load_numpy_params(scope, state, pf.CPUPlace())
        runs = []
        for b in _batches():
            out = exe.run(main, feed=b, fetch_list=[loss] + [
                p + "@GRAD" for p in params], scope=scope)
            runs.append([np.asarray(v) for v in out])
        res[pkg.__name__] = dict(runs=runs, params=params)
    return res


def test_conv_net_step1_loss_and_grads(trained):
    j, p = trained["paddle_tpu"], trained["paddle_tpu_torch"]
    assert p["params"] == j["params"] and len(p["params"]) == 6
    np.testing.assert_allclose(p["runs"][0][0], j["runs"][0][0],
                               rtol=TOL, atol=0)
    for name, g, w in zip(p["params"], p["runs"][0][1:], j["runs"][0][1:]):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)


def test_conv_net_sgd_steps(trained):
    jl = np.array([r[0].reshape(-1)[0] for r in
                   trained["paddle_tpu"]["runs"]])
    pl = np.array([r[0].reshape(-1)[0] for r in
                   trained["paddle_tpu_torch"]["runs"]])
    np.testing.assert_allclose(pl, jl, rtol=TOL)
    assert pl[-1] < pl[0]


def test_conv_layers_build_as_the_jax_package():
    """build_program(use_conv=True): the same ops in order, the same
    parameters and shapes; conv2d's filters default to He-normal."""
    with jf.unique_name.guard():
        jmain, jstart, _, _ = JM.build_program(use_conv=True)
    with pf.unique_name.guard():
        pmain, pstart, _, _ = PM.build_program(use_conv=True)
    assert [o.type for o in pmain.global_block.ops] == \
        [o.type for o in jmain.global_block.ops]
    assert [(x.name, tuple(x.shape)) for x in pmain.all_parameters()] == \
        [(x.name, tuple(x.shape)) for x in jmain.all_parameters()]
    for j, p in zip(jstart.global_block.ops, pstart.global_block.ops):
        assert p.type == j.type
        for a in ("shape", "mean", "std"):
            assert p.attrs.get(a) == j.attrs.get(a), (p.type, a)
    stds = [op.attrs["std"] for op in pstart.global_block.ops
            if op.type == "gaussian_random"]
    np.testing.assert_allclose(stds, [(2 / 25) ** 0.5, (2 / 500) ** 0.5])
