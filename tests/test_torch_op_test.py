"""The port's OpTest cases (``tests/torch_op_test.py``) for the ops of the
MNIST slice: exp, cos, square, floor, ceil, sign, elementwise_pow,
top_k, accuracy, clip and increment, each at its edges (NaN, integer
input, a negative axis, k equal to the width, a tie); the eight update
ops' cases are in test_torch_optimizers.py.

Tolerances:
- outputs against the JAX package: the dtype and shape exactly, NaN in
  the same places, values within 1e-6 relative and absolute (fp32, one
  library call or a few ops in the same order); sign, floor, ceil,
  top_k's indices and accuracy's counts exactly, sign bit for bit
  (-0.0 and NaN kept).
- grads against float64 central differences (delta 1e-6) of
  sum(w * Out): 1e-4 of max(|numeric|, 1) per element; the float32
  grad op is ~1e-7 off, and a planted fault of 1e-3 must fail.
- elementwise_pow's grads at base 0 against the JAX package's grad op
  (differences mean nothing there): 1e-6, NaN and inf in the same
  places.
- on the card (marked ``gpu``): each op's outputs against the port's CPU
  run, bit for bit for top_k (ties and NaN rows), accuracy and sign,
  the same values and signs for floor and ceil (a NaN's payload may
  differ), 1e-6 for the rest. Run there with ``python -m pytest
  --noconftest -m gpu tests/test_torch_op_test.py``: the JAX package is
  imported only inside the checks that read it.
"""
import numpy as np
import pytest
import torch

from torch_op_test import TorchOpTest, op_case


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(*shape, seed=0, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


EDGES = np.array([[-np.inf, -2.5, -1.0, -0.0, 0.0, 0.5, 1.5, np.nan,
                   np.inf, 3.0]], np.float32)


# ---------------------------------------------------------------------------
# unary ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op_type", ["exp", "cos", "square", "floor",
                                     "ceil"])
@pytest.mark.parametrize("x", ["random", "edges", "int"])
def test_unary_output(op_type, x):
    arr = {"random": _x(3, 5), "edges": EDGES,
           "int": np.array([[-3, 0, 2, 7]], np.int32)}[x]
    op_case(op_type, {"X": arr}).check_output()


@pytest.mark.parametrize("op_type", ["exp", "cos", "square"])
def test_unary_grad(op_type):
    op_case(op_type, {"X": _x(3, 4)}).check_grad(["X"])


def test_sign_bits():
    """NaN stays NaN and -0.0 stays -0.0, as jnp.sign keeps them (C17:
    torch.sign maps NaN to 0)."""
    x = np.array([-0.0, 0.0, np.nan, -2.0, 3.0, -np.inf], np.float32)
    got = op_case("sign", {"X": x}).check_output(exact=True)["Out"]
    assert np.signbit(got[0]) and np.isnan(got[2])


def test_sign_int():
    op_case("sign", {"X": np.array([-4, 0, 9], np.int32)}).check_output(
        exact=True)


# ---------------------------------------------------------------------------
# elementwise_pow
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis,yshape", [(-1, (5,)), (1, (4,)),
                                         (-1, (4, 5)), (0, (3, 1))])
def test_pow_broadcast(axis, yshape):
    """Y broadcast from `axis` (fluid semantics, trailing 1s trimmed),
    and the grads summed back to Y's shape."""
    t = op_case("elementwise_pow", {"X": _x(3, 4, 5, lo=0.5, hi=2.0),
                                  "Y": _x(*yshape, seed=1)},
              {"axis": axis})
    t.check_output()
    t.check_grad(["X", "Y"])


def test_pow_grad_at_base_zero():
    """At base 0 the grads follow jax.lax.pow's rules (NaN at 0^0 for X,
    0 for Y at y >= 0, NaN for Y at y < 0), where torch's own differ."""
    x = np.array([0.0, 0.0, 0.0, 0.0, 2.0, -2.0, 0.5], np.float32)
    y = np.array([2.0, 0.0, 0.5, -1.0, 3.0, 2.0, -0.5], np.float32)
    t = op_case("elementwise_pow", {"X": x, "Y": y})
    t.check_output()
    t.check_grad_with_reference(["X", "Y"])


def test_pow_int():
    t = op_case("elementwise_pow", {"X": np.array([2, 3, -2, 0], np.int32),
                                  "Y": np.array([3, 2, 3, 5], np.int32)})
    t.check_output(exact=True)


# ---------------------------------------------------------------------------
# top_k and accuracy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["random", "k_width", "tie", "nan",
                                  "3d"])
def test_top_k(case):
    """Values largest first and int32 indices, the lower index first
    among equal values (jax.lax.top_k), NaN above every number."""
    x, k = {"random": (_x(4, 9), 3),
            "k_width": (_x(4, 9), 9),
            "tie": (np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 3.0]], np.float32),
                    3),
            "nan": (np.array([[0.5, np.nan, 2.0, -1.0]], np.float32), 2),
            "3d": (_x(2, 3, 6), 4)}[case]
    out = op_case("top_k", {"X": x}, {"k": k},
                ("Out", "Indices")).check_output(exact=True)
    if case == "tie":
        np.testing.assert_array_equal(out["Indices"], [[1, 2, 4]])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("label_rank", [1, 2])
def test_accuracy(k, label_rank):
    """Accuracy float32 [1], Correct and Total int32 [1], labels as [N]
    or [N, 1]; a tied row counts its lower index."""
    x = _x(16, 10, seed=3)
    x[0, :] = 1.0  # a row of equal values: top-1 is index 0
    rs = np.random.RandomState(4)
    label = rs.randint(0, 10, (16,)).astype(np.int64)
    label[0] = 0
    label[1] = int(np.argmax(x[1]))
    if label_rank == 2:
        label = label[:, None]
    top = op_case("top_k", {"X": x}, {"k": k}, ("Out", "Indices"))
    idx = top.check_output(exact=True)["Indices"]
    acc = op_case("accuracy", {"Out": x[:, :k], "Indices": idx,
                             "Label": label},
                outputs=("Accuracy", "Correct", "Total"))
    got = acc.check_output(exact=True)
    assert got["Total"].tolist() == [16]
    assert got["Correct"][0] >= 2


# ---------------------------------------------------------------------------
# clip and increment on integer X (C18)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lo,hi", [(0.5, 2.7), (1.0, 3.0), (1, 3)])
def test_clip_int_x(lo, hi):
    """An integer X with a float bound gives float32 (jnp.clip promotes),
    with int bounds stays int32."""
    x = np.array([[-3, 0, 1, 2, 5]], np.int32)
    out = op_case("clip", {"X": x}, {"min": lo, "max": hi}).check_output(
        exact=True)["Out"]
    assert out.dtype == (np.int32 if isinstance(lo, int) else np.float32)


@pytest.mark.parametrize("step", [1.0, 1.5, 1, -2])
def test_increment_int_x(step):
    """X + step: float32 for a float step (integral or not), int32 for an
    int one, as JAX promotes."""
    x = np.array([0, 4, -7], np.int32)
    out = op_case("increment", {"X": x}, {"step": step}).check_output(
        exact=True)["Out"]
    assert out.dtype == (np.int32 if isinstance(step, int) else np.float32)


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------
def test_planted_grad_fault_fails():
    """A grad off by 1e-3 relative must fail check_grad; the same case
    without the fault passes."""
    t = op_case("cos", {"X": _x(3, 4)})
    t.check_grad(["X"])
    t.grad_fault = lambda slot, g: g * (1 + 1e-3)
    with pytest.raises(AssertionError, match="relative error"):
        t.check_grad(["X"])


def test_planted_output_fault_fails():
    """A port output 1e-5 off the reference's must fail check_output."""

    class Off(TorchOpTest):
        def port_outputs(self, dtype=None, device="cpu"):
            out = super().port_outputs(dtype, device)
            return {s: v + 1e-5 for s, v in out.items()}

    t = Off()
    t.op_type, t.inputs, t.attrs, t.outputs = "exp", {"X": _x(3, 4)}, {}, \
        ["Out"]
    with pytest.raises(AssertionError):
        t.check_output()


# ---------------------------------------------------------------------------
# on the card: the port's ops against its CPU run
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_op_test.py`")
    return torch.device("cuda")


CARD_CASES = {
    "top_k_tie": ("top_k", {"X": np.tile(np.float32(
        [[1.0, 3.0, 3.0, 2.0, 3.0, 3.0, np.nan, 3.0]]), (64, 1))},
        {"k": 4}, ("Out", "Indices"), True),
    "top_k_width": ("top_k", {"X": _x(256, 10, seed=5)}, {"k": 10},
                    ("Out", "Indices"), True),
    "sign": ("sign", {"X": EDGES}, {}, ("Out",), True),
    # NaN's payload bits may differ between the CPU and the card
    "floor": ("floor", {"X": EDGES}, {}, ("Out",), "values"),
    "ceil": ("ceil", {"X": EDGES}, {}, ("Out",), "values"),
    "exp": ("exp", {"X": EDGES}, {}, ("Out",), False),
    "cos": ("cos", {"X": _x(64, 33)}, {}, ("Out",), False),
    "pow": ("elementwise_pow", {"X": _x(8, 16, lo=0.0, hi=2.0),
                                "Y": _x(16, seed=2)}, {}, ("Out",), False),
    "accuracy": ("accuracy", {"Out": _x(64, 1), "Indices": np.random.
                              RandomState(6).randint(0, 10, (64, 1)).astype(
                                  np.int32),
                              "Label": np.random.RandomState(7).randint(
                                  0, 10, (64, 1)).astype(np.int64)},
                 {}, ("Accuracy", "Correct", "Total"), True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_op_on_the_card_matches_cpu(cuda, name):
    op_type, inputs, attrs, outputs, exact = CARD_CASES[name]
    t = op_case(op_type, inputs, attrs, outputs)
    got = t.port_outputs(device=cuda)
    want = t.port_outputs()
    for s in outputs:
        g, w = got[s].cpu().numpy(), want[s].numpy()
        assert got[s].device.type == "cuda" and g.dtype == w.dtype
        if exact == "values":
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {s}")
            num = ~np.isnan(w)
            np.testing.assert_array_equal(np.signbit(g[num]),
                                          np.signbit(w[num]))
        elif exact:
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=f"{name} {s}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       equal_nan=True, err_msg=name)
