"""The port's autodiff against the JAX package: each grad op of the
Transformer-base training program, the optimizer and accumulation ops,
and append_backward's program transform.

Every grad case builds one forward op in both packages on the same
seeded numpy inputs, asks each registry's ``make_grad_ops`` for its grad
ops, feeds both the same output cotangents and compares the input
grads. Tolerance: 1e-5 absolute and relative, fp32; the two libraries
sum in different orders (the attention and layer_norm grads reduce over
a few dozen terms), nothing else differs.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import backward as j_backward
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import registry as j_registry
from paddle_tpu_torch import backward as p_backward
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.core import registry as p_registry
from paddle_tpu_torch.ops.kernels import attention as KA
from paddle_tpu_torch.ops.kernels import layer_norm as KL

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small so these tests do not crowd the
    timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randn(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype("float32")


def _ids(shape, high, seed):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        "int64")


# (op type, {slot: [arrays]}, {slot: n outputs}, attrs,
#  output names that receive a cotangent)
_LABEL = _ids((2, 3, 1), 16, 30)
_LABEL[0, 1, 0] = -100  # one ignored row
GRAD_CASES = {
    "mul": ("mul", {"X": [_randn((2, 3, 8), 1)], "Y": [_randn((8, 5), 2)]},
            {"Out": 1}, {"x_num_col_dims": 2, "y_num_col_dims": 1},
            ["Out0"]),
    "reshape2": ("reshape2", {"X": [_randn((2, 12), 3)]},
                 {"Out": 1, "XShape": 1}, {"shape": [0, 3, 4]}, ["Out0"]),
    "elementwise_add_bias": (
        "elementwise_add", {"X": [_randn((2, 3, 4), 4)],
                            "Y": [_randn((4,), 5)]},
        {"Out": 1}, {"axis": 2}, ["Out0"]),
    "elementwise_add_pos": (
        "elementwise_add", {"X": [_randn((2, 3, 4), 6)],
                            "Y": [_randn((3, 4), 7)]},
        {"Out": 1}, {"axis": 1}, ["Out0"]),
    "layer_norm": ("layer_norm",
                   {"X": [_randn((2, 3, 16), 8, 2.0, 0.5)],
                    "Scale": [_randn((16,), 9)], "Bias": [_randn((16,), 10)]},
                   {"Y": 1, "Mean": 1, "Variance": 1},
                   {"epsilon": 1e-5, "begin_norm_axis": 2}, ["Y0"]),
    "attention_self_causal": (
        "attention", {"Q": [_randn((2, 5, 2, 8), 11)],
                      "K": [_randn((2, 5, 2, 8), 12)],
                      "V": [_randn((2, 5, 2, 8), 13)]},
        {"Out": 1}, {"causal": True, "scale": 8 ** -0.5,
                     "dropout_rate": 0.0, "layout": "bthd"}, ["Out0"]),
    "attention_cross": (
        "attention", {"Q": [_randn((2, 5, 2, 8), 14)],
                      "K": [_randn((2, 7, 2, 8), 15)],
                      "V": [_randn((2, 7, 2, 8), 16)]},
        {"Out": 1}, {"causal": False, "scale": 8 ** -0.5,
                     "dropout_rate": 0.0, "layout": "bthd"}, ["Out0"]),
    # routed shapes (head dim 64, fp32): 256 < T <= 512 with tq == tk
    # takes sdpa_short, T > 512 flash; on the CPU their plain versions
    "attention_sdpa_short_causal": (
        "attention", {"Q": [_randn((1, 264, 2, 64), 26)],
                      "K": [_randn((1, 264, 2, 64), 27)],
                      "V": [_randn((1, 264, 2, 64), 28)]},
        {"Out": 1}, {"causal": True, "scale": 0.125, "dropout_rate": 0.0,
                     "layout": "bthd"}, ["Out0"]),
    "attention_flash_causal": (
        "attention", {"Q": [_randn((1, 520, 2, 64), 29)],
                      "K": [_randn((1, 520, 2, 64), 31)],
                      "V": [_randn((1, 520, 2, 64), 32)]},
        {"Out": 1}, {"causal": True, "scale": 0.125, "dropout_rate": 0.0,
                     "layout": "bthd"}, ["Out0"]),
    "attention_flash_cross": (
        "attention", {"Q": [_randn((1, 520, 2, 64), 33)],
                      "K": [_randn((1, 600, 2, 64), 34)],
                      "V": [_randn((1, 600, 2, 64), 35)]},
        {"Out": 1}, {"causal": False, "scale": 0.125, "dropout_rate": 0.0,
                     "layout": "bthd"}, ["Out0"]),
    "split": ("split", {"X": [_randn((2, 3, 12), 17)]}, {"Out": 3},
              {"num": 3, "sections": [], "axis": 2}, ["Out0", "Out2"]),
    "relu": ("relu", {"X": [_randn((3, 7), 18, 1.0, 0.05)]}, {"Out": 1}, {},
             ["Out0"]),
    "scale": ("scale", {"X": [_randn((3, 4), 19)]}, {"Out": 1},
              {"scale": 2.5, "bias": 0.5, "bias_after_scale": True},
              ["Out0"]),
    "lookup_table": ("lookup_table",
                     {"W": [_randn((10, 4), 20)],
                      "Ids": [np.array([[1, 3, 1], [9, 0, 3]], "int64")]},
                     {"Out": 1}, {"padding_idx": -1}, ["Out0"]),
    # 7 is out of range: its row reads NaN and its grad adds nothing; -1
    # wraps to row 5. Only rows 1 and 5 of W@GRAD are nonzero
    "lookup_table_out_of_range": (
        "lookup_table", {"W": [_randn((6, 4), 38)],
                         "Ids": [np.array([1, 7, -1], "int64")]},
        {"Out": 1}, {"padding_idx": -1}, ["Out0"]),
    # dim [] without reduce_all: the identity, so its grad is the cotangent
    "reduce_sum_no_dim": ("reduce_sum", {"X": [_randn((3, 4), 39)]},
                          {"Out": 1}, {"dim": [], "keep_dim": False,
                                       "reduce_all": False}, ["Out0"]),
    "softmax_with_cross_entropy_smooth": (
        "softmax_with_cross_entropy",
        {"Logits": [_randn((2, 3, 16), 21, 2.0)], "Label": [_LABEL]},
        {"Loss": 1, "Softmax": 1},
        {"soft_label": False, "ignore_index": -100,
         "label_smooth_eps": 0.1}, ["Loss0"]),
    "softmax_with_cross_entropy_hard": (
        "softmax_with_cross_entropy",
        {"Logits": [_randn((2, 3, 16), 22, 2.0)], "Label": [_LABEL]},
        {"Loss": 1, "Softmax": 1},
        {"soft_label": False, "ignore_index": -100,
         "label_smooth_eps": 0.0}, ["Loss0"]),
    "softmax_with_cross_entropy_soft": (
        "softmax_with_cross_entropy",
        {"Logits": [_randn((2, 3, 16), 24, 2.0)],
         "Label": [np.abs(_randn((2, 3, 16), 25)) / 8]},
        {"Loss": 1, "Softmax": 1},
        {"soft_label": True, "label_smooth_eps": 0.1}, ["Loss0"]),
    "mean": ("mean", {"X": [_randn((3, 4), 23)]}, {"Out": 1}, {},
             ["Out0"]),
    # Index [4, 1] keeps its shape; a repeated row sums its grads, -1
    # counts from the end and 7 reads the fill value, which passes none
    "gather": ("gather", {"X": [_randn((5, 3), 36)],
                          "Index": [np.array([[1], [-1], [1], [7]],
                                             "int64")]},
               {"Out": 1}, {}, ["Out0"]),
}


def _build_op(pkg, op_type, inputs, outputs, attrs):
    """One op in a fresh Program of `pkg`; inputs named <slot><i>."""
    prog = pkg.Program()
    blk = prog.global_block
    ins = {}
    for slot, arrs in inputs.items():
        names = []
        for i, a in enumerate(arrs):
            name = f"{slot}{i}"
            blk.create_var(name=name, shape=a.shape, dtype=str(a.dtype))
            names.append(name)
        ins[slot] = names
    outs = {slot: [f"{slot}{i}" for i in range(n)]
            for slot, n in outputs.items()}
    return blk.append_op(op_type, ins, outs, dict(attrs))


def _run_grads(pkg, registry, to_array, op, inputs, cots, run):
    """Every grad op of `op`, run on the forward inputs and the given
    output cotangents; returns {grad var name: numpy}."""
    env = {f"{slot}{i}": to_array(a) for slot, arrs in inputs.items()
           for i, a in enumerate(arrs)}
    env.update({n + "@GRAD": to_array(c) for n, c in cots.items()})
    got = {}
    for gop in registry.make_grad_ops(op):
        for slot, names in gop.inputs.items():
            if slot.endswith("@GRAD"):
                gop.inputs[slot] = [n if n in env else registry.EMPTY_VAR
                                    for n in names]
        run(gop, env)
        for n in gop.output_arg_names:
            got[n] = np.asarray(env[n])
    return got


def _jax_array(a):
    # with x64 off the JAX package holds int64 vars as int32
    return jnp.asarray(a.astype("int32") if a.dtype == np.int64 else a)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_op_matches_reference(case):
    op_type, inputs, outputs, attrs, cot_outs = GRAD_CASES[case]
    jop = _build_op(jf, op_type, inputs, outputs, attrs)
    pop = _build_op(pf, op_type, inputs, outputs, attrs)
    # cotangents shaped like the reference's forward outputs
    fwd_env = {f"{s}{i}": _jax_array(a) for s, arrs in inputs.items()
               for i, a in enumerate(arrs)}
    j_registry.run_op(jop, fwd_env)
    cots = {n: _randn(np.shape(fwd_env[n]), 40 + k)
            for k, n in enumerate(cot_outs)}
    want = _run_grads(jf, j_registry, _jax_array, jop, inputs, cots,
                      lambda op, env: j_registry.run_op(op, env))
    got = _run_grads(pf, p_registry, torch.from_numpy, pop, inputs, cots,
                     lambda op, env: p_registry.run_op(op, env, CPU))
    assert sorted(got) == sorted(want) and want
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_integer_inputs_take_no_gradient():
    """lookup_table's Ids, the swce Label and gather's Index are
    integers: neither package emits a grad output for them (gather's
    Index is a stop-gradient slot in both registries). gather's lone
    grad op then runs in both packages and gives the same X@GRAD."""
    for case in ("lookup_table", "softmax_with_cross_entropy_hard",
                 "gather"):
        op_type, inputs, outputs, attrs, _ = GRAD_CASES[case]
        pop = _build_op(pf, op_type, inputs, outputs, attrs)
        jop = _build_op(jf, op_type, inputs, outputs, attrs)
        (gop,) = p_registry.make_grad_ops(pop)
        (jgop,) = j_registry.make_grad_ops(jop)
        want = [s + "@GRAD" for s in inputs
                if s not in ("Ids", "Label", "Index")]
        assert list(gop.outputs) == list(jgop.outputs) == want, case
    op_type, inputs, outputs, attrs, _ = GRAD_CASES["gather"]
    cots = {"Out0": _randn((4, 1, 3), 37)}
    got = _run_grads(pf, p_registry, torch.from_numpy,
                     _build_op(pf, op_type, inputs, outputs, attrs),
                     inputs, cots,
                     lambda op, env: p_registry.run_op(op, env, CPU))
    want = _run_grads(jf, j_registry, _jax_array,
                      _build_op(jf, op_type, inputs, outputs, attrs),
                      inputs, cots,
                      lambda op, env: j_registry.run_op(op, env))
    assert sorted(got) == sorted(want) == ["X0@GRAD"]
    np.testing.assert_allclose(got["X0@GRAD"], want["X0@GRAD"], **TOL)


def test_adam_and_sum_ops_match_reference():
    shape = (4, 6)
    ins = {"Param": _randn(shape, 50), "Grad": _randn(shape, 51),
           "Moment1": _randn(shape, 52, 0.1),
           "Moment2": np.abs(_randn(shape, 53, 0.1)),
           "Beta1Pow": np.array([0.9 ** 3], "float32"),
           "Beta2Pow": np.array([0.997 ** 3], "float32"),
           "LearningRate": np.array([0.01], "float32")}
    outs = {"ParamOut": 1, "Moment1Out": 1, "Moment2Out": 1,
            "Beta1PowOut": 1, "Beta2PowOut": 1}
    attrs = {"beta1": 0.9, "beta2": 0.997, "epsilon": 1e-9}
    cases = [("adam", {s: [a] for s, a in ins.items()}, outs, attrs),
             ("sum", {"X": [_randn(shape, 54), _randn(shape, 55),
                            _randn(shape, 56)]}, {"Out": 1}, {})]
    for op_type, inputs, outputs, attrs in cases:
        jop = _build_op(jf, op_type, inputs, outputs, attrs)
        pop = _build_op(pf, op_type, inputs, outputs, attrs)
        jenv = {f"{s}{i}": jnp.asarray(a) for s, arrs in inputs.items()
                for i, a in enumerate(arrs)}
        penv = {f"{s}{i}": torch.from_numpy(a) for s, arrs in inputs.items()
                for i, a in enumerate(arrs)}
        j_registry.run_op(jop, jenv)
        p_registry.run_op(pop, penv, CPU)
        for n in jop.output_arg_names:
            np.testing.assert_allclose(penv[n].numpy(), np.asarray(jenv[n]),
                                       err_msg=f"{op_type} {n}", **TOL)


def _small_net(pkg):
    """fc -> relu -> two fc heads over the same hidden (its grad is
    summed) -> softmax_with_cross_entropy -> mean."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[8], dtype="float32")
        label = pkg.layers.data("label", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, 16, act="relu")
        a = pkg.layers.fc(h, 5)
        b = pkg.layers.fc(h, 5, bias_attr=False)
        logits = pkg.layers.elementwise_add(a, b)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            logits, label, label_smooth_eps=0.1))
    return main, loss


def _op_list(prog):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             op.attrs.get("op_role")) for op in prog.global_block.ops]


def test_append_backward_emits_the_reference_program():
    with j_unique_name.guard():
        jmain, jloss = _small_net(jf)
        jpairs = j_backward.append_backward(jloss)
    with p_unique_name.guard():
        pmain, ploss = _small_net(pf)
        ppairs = p_backward.append_backward(ploss)
    assert _op_list(pmain) == _op_list(jmain)
    types = [op.type for op in pmain.global_block.ops]
    assert types.count("sum") == 1 and "fill_any_like" in types
    assert [(p.name, g.name) for p, g in ppairs] == \
        [(p.name, g.name) for p, g in jpairs]
    assert all(g.name == p.name + "@GRAD" for p, g in ppairs)
    for p, g in ppairs:
        assert g.shape == p.shape


def test_softmax_output_is_computed_only_when_read():
    logits = _randn((2, 3, 16), 60)
    op = _build_op(pf, "softmax_with_cross_entropy",
                   {"Logits": [logits], "Label": [_LABEL]},
                   {"Loss": 1, "Softmax": 1},
                   {"soft_label": False, "ignore_index": -100,
                    "label_smooth_eps": 0.0})
    base = {"Logits0": torch.from_numpy(logits),
            "Label0": torch.from_numpy(_LABEL)}
    env = dict(base)
    p_registry.run_op(op, env, CPU, needed={"Loss0"})
    assert "Loss0" in env and "Softmax0" not in env
    env = dict(base)
    p_registry.run_op(op, env, CPU, needed={"Loss0", "Softmax0"})
    np.testing.assert_allclose(env["Softmax0"].numpy(),
                               torch.softmax(base["Logits0"], -1).numpy(),
                               **TOL)


def test_layer_norm_function_differentiates_under_vjp():
    """The card's layer_norm is an autograd.Function around the kernel;
    with the plain version standing in for the launch it must give the
    plain version's vjp, under the Executor's no_grad as well."""
    x = torch.from_numpy(_randn((6, 32), 61, 2.0, 0.3))
    s, b = torch.from_numpy(_randn((32,), 62)), torch.from_numpy(
        _randn((32,), 63))
    cot = (torch.from_numpy(_randn((6, 32), 64)), torch.zeros(6),
           torch.zeros(6))
    with torch.no_grad():
        _, vjp = torch.func.vjp(
            lambda *a: KL.LayerNormFn.apply(KL.layer_norm_plain, *a, 1e-5),
            x, s, b)
        _, want = torch.func.vjp(
            lambda *a: KL.layer_norm_plain(*a, 1e-5), x, s, b)
        for g, w in zip(vjp(cot), want(cot)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_layer_norm_grad_recomputes_with_the_plain_version(monkeypatch):
    """layer_norm_grad takes the plain version's vjp directly: it never
    calls the kernel wrapper, whose launch it would throw away, and
    still matches the reference's grads. (Building the op runs the
    wrapper on meta tensors for shape inference, which launches
    nothing.)"""
    wrapper = KL.layer_norm

    def launch(x, *a, **k):
        assert x.device.type == "meta", \
            "layer_norm_grad called the kernel wrapper"
        return wrapper(x, *a, **k)

    monkeypatch.setattr(KL, "layer_norm", launch)
    test_grad_op_matches_reference("layer_norm")


# ---------------------------------------------------------------------------
# the attention kernels' autograd Functions, with their launches replaced
# by the plain versions (the kernels run only on the card)
# ---------------------------------------------------------------------------
def _plain_launches(monkeypatch):
    """Replace the forward launches and the backward wrappers by their
    plain versions, recording each call: ("fwd", residual?) or ("bwd",).
    Like a kernel launch, each reads the storage of its tensors (a
    tensor wrapped by torch.func has none)."""
    calls = []

    def touch(args):
        for a in args:
            if isinstance(a, torch.Tensor):
                a.data_ptr()

    def sdpa(q, k, v, scale, causal, save_p):
        touch((q, k, v))
        calls.append(("fwd", save_p))
        return KA.sdpa_short_plain(q, k, v, scale, causal, save_p=save_p)

    def flash(q, k, v, scale, causal, with_lse):
        touch((q, k, v))
        calls.append(("fwd", with_lse))
        return KA.flash_attention_plain(q, k, v, scale, causal,
                                        with_lse=with_lse)

    def bwd(plain):
        def run(*a):
            touch(a)
            calls.append(("bwd",))
            return plain(*a)
        return run

    monkeypatch.setattr(KA, "_sdpa_short_launch", sdpa)
    monkeypatch.setattr(KA, "_flash_attention_launch", flash)
    monkeypatch.setattr(KA, "sdpa_short_bwd", bwd(KA.sdpa_short_bwd_plain))
    monkeypatch.setattr(KA, "flash_attention_bwd",
                        bwd(KA.flash_attention_bwd_plain))
    return calls


_FNS = {"sdpa_short": (KA.SdpaShortFn, "_sdpa_short_launch", 6, 6),
        "flash": (KA.FlashAttentionFn, "_flash_attention_launch", 8, 4)}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", sorted(_FNS))
def test_attention_function_vjp_matches_reference(monkeypatch, kind, causal):
    """`torch.func.vjp` through the card's path (`_on_card`) under the
    Executor's no_grad: the forward launch writes its residual once, the
    backward launch runs once per vjp, and the grads are the vjp of
    `reference_attention` (flash with tq > tk causal: rows that see no
    key). Without a vjp the same path is the primal launch, with no
    residual."""
    calls = _plain_launches(monkeypatch)
    fn, launch, tq, tk = _FNS[kind]
    q = torch.from_numpy(_randn((2, 2, tq, 16), 70))
    k = torch.from_numpy(_randn((2, 2, tk, 16), 71))
    v = torch.from_numpy(_randn((2, 2, tk, 16), 72))
    g = torch.from_numpy(_randn((2, 2, tq, 16), 73))

    def on_card(a, b, c):
        return KA._on_card(fn, getattr(KA, launch), a, b, c, 0.25, causal)

    with torch.no_grad():
        primal = on_card(q, k, v)
        assert calls == [("fwd", False)]
        out, vjp = torch.func.vjp(on_card, q, k, v)
        assert calls[1:] == [("fwd", True)]
        got = vjp(g)
        assert calls[2:] == [("bwd",)]
        want_out, want_vjp = torch.func.vjp(
            lambda a, b, c: KA.reference_attention(a, b, c, 0.25, causal),
            q, k, v)
        want = want_vjp(g)
    torch.testing.assert_close(primal, want_out, rtol=0, atol=0)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, **TOL, msg=name)


@pytest.mark.parametrize("case", ["attention_sdpa_short_causal",
                                  "attention_flash_causal",
                                  "attention_flash_cross"])
def test_attention_op_through_the_kernel_path(monkeypatch, case):
    """The attention op and its grad op as the Executor runs them (under
    no_grad), with the wrappers sent down their card path and the
    launches replaced by the plain versions: the forward op launches the
    primal kernel with no residual; the grad op recomputes the forward
    with its residual and runs the backward once; the grads equal the
    reference's grad op."""
    op_type, inputs, outputs, attrs, cot_outs = GRAD_CASES[case]
    jop = _build_op(jf, op_type, inputs, outputs, attrs)
    pop = _build_op(pf, op_type, inputs, outputs, attrs)
    calls = _plain_launches(monkeypatch)
    monkeypatch.setattr(KA, "sdpa_short", lambda *a: KA._on_card(
        KA.SdpaShortFn, KA._sdpa_short_launch, *a))
    monkeypatch.setattr(KA, "flash_attention", lambda *a: KA._on_card(
        KA.FlashAttentionFn, KA._flash_attention_launch, *a))
    env = {f"{s}{i}": torch.from_numpy(a) for s, arrs in inputs.items()
           for i, a in enumerate(arrs)}
    with torch.no_grad():
        p_registry.run_op(pop, env, CPU)
    assert calls == [("fwd", False)]
    fwd_env = {f"{s}{i}": _jax_array(a) for s, arrs in inputs.items()
               for i, a in enumerate(arrs)}
    j_registry.run_op(jop, fwd_env)
    np.testing.assert_allclose(env["Out0"].numpy(),
                               np.asarray(fwd_env["Out0"]), **TOL)
    cots = {"Out0": _randn(np.shape(fwd_env["Out0"]), 74)}
    want = _run_grads(jf, j_registry, _jax_array, jop, inputs, cots,
                      lambda op, env: j_registry.run_op(op, env))

    def run(op, env):
        with torch.no_grad():
            p_registry.run_op(op, env, CPU)

    got = _run_grads(pf, p_registry, torch.from_numpy, pop, inputs, cots,
                     run)
    assert calls[1:] == [("fwd", True), ("bwd",)]
    assert sorted(got) == sorted(want) and want
    for n in want:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)
