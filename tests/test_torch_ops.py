"""Each op of the serving path, run through a one-op Program in both
packages on the same seeded numpy inputs and compared.

Floats agree within 1e-5 (fp32; the two libraries sum in different
orders). Integers and booleans are compared by value: with
jax_enable_x64 off the JAX package computes int64 vars as int32.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf

ATOL = 1e-5
RNG_SEED = 7


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small so these tests do not crowd the
    timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f(*shape):
    return np.random.RandomState(RNG_SEED).randn(*shape).astype("float32")


def _i(lo, hi, *shape):
    return np.random.RandomState(RNG_SEED).randint(
        lo, hi, shape).astype("int64")


# (case id, op type, inputs {slot: {var: array}}, output slots
#  {slot: n_vars}, attrs)
CASES = [
    ("arg_max", "arg_max", {"X": {"x": _f(3, 7)}}, {"Out": 1},
     {"axis": -1}),
    ("assign", "assign", {"X": {"x": _f(2, 3)}}, {"Out": 1}, {}),
    ("assign_value", "assign_value", {}, {"Out": 1},
     {"shape": [2, 3], "dtype": "float32",
      "values": np.arange(6, dtype="float32") / 7}),
    ("attention_bthd", "attention",
     {"Q": {"q": _f(2, 5, 2, 8)}, "K": {"k": _f(2, 5, 2, 8) * 0.5},
      "V": {"v": _f(2, 5, 2, 8) + 1}}, {"Out": 1},
     {"causal": False, "scale": 0.3, "layout": "bthd",
      "dropout_rate": 0.0, "is_test": True}),
    ("attention_causal_bhtd", "attention",
     {"Q": {"q": _f(1, 2, 6, 8)}, "K": {"k": _f(1, 2, 6, 8) * 0.5},
      "V": {"v": _f(1, 2, 6, 8) + 1}}, {"Out": 1},
     {"causal": True, "scale": None, "layout": "bhtd",
      "dropout_rate": 0.0, "is_test": True}),
    # the sdpa_short window (256 < T <= 512, d 64): the port's routing
    # reaches the kernel wrapper, which runs its plain version here
    ("attention_sdpa_short_route", "attention",
     {"Q": {"q": _f(1, 264, 1, 64)}, "K": {"k": _f(1, 264, 1, 64) * 0.5},
      "V": {"v": _f(1, 264, 1, 64)}}, {"Out": 1},
     {"causal": True, "scale": 0.125, "layout": "bthd",
      "dropout_rate": 0.0, "is_test": True}),
    # the flash window (T > 512)
    ("attention_flash_route", "attention",
     {"Q": {"q": _f(1, 520, 1, 64)}, "K": {"k": _f(1, 520, 1, 64) * 0.5},
      "V": {"v": _f(1, 520, 1, 64)}}, {"Out": 1},
     {"causal": False, "scale": 0.125, "layout": "bthd",
      "dropout_rate": 0.0, "is_test": True}),
    ("cast_f2i", "cast", {"X": {"x": _f(3, 4) * 5}}, {"Out": 1},
     {"out_dtype": "int64"}),
    ("cast_b2f", "cast", {"X": {"x": _f(3, 4) > 0}}, {"Out": 1},
     {"out_dtype": "float32"}),
    ("elementwise_add_axis", "elementwise_add",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(3)}}, {"Out": 1},
     {"axis": 1}),
    ("elementwise_add_trailing", "elementwise_add",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4)}}, {"Out": 1},
     {"axis": -1}),
    ("elementwise_mul", "elementwise_mul",
     {"X": {"x": _f(2, 3)}, "Y": {"y": _f(2, 3) + 2}}, {"Out": 1},
     {"axis": -1}),
    ("elementwise_mul_int", "elementwise_mul",
     {"X": {"x": _i(0, 9, 3, 5)}, "Y": {"y": _i(0, 2, 5)}}, {"Out": 1},
     {"axis": -1}),
    ("elementwise_sub", "elementwise_sub",
     {"X": {"x": _f(4, 2)}, "Y": {"y": _f(4, 2) * 3}}, {"Out": 1},
     {"axis": -1}),
    ("elementwise_max", "elementwise_max",
     {"X": {"x": _i(0, 2, 6)}, "Y": {"y": _i(0, 2, 6) * 0 + 1}},
     {"Out": 1}, {"axis": -1}),
    ("elementwise_min", "elementwise_min",
     {"X": {"x": _i(-3, 3, 1)}, "Y": {"y": _i(0, 5, 1)}}, {"Out": 1},
     {"axis": -1}),
    ("equal", "equal", {"X": {"x": _i(0, 4, 6)}, "Y": {"y": _i(2, 3, 1)}},
     {"Out": 1}, {}),
    # fewer expand_times than dims: leading 1s, as jnp.tile pads them
    ("expand_short_times", "expand", {"X": {"x": _f(2, 3)}}, {"Out": 1},
     {"expand_times": [2]}),
    ("fill_constant_float", "fill_constant", {}, {"Out": 1},
     {"shape": [2, 3], "dtype": "float32", "value": 1.5}),
    ("fill_constant_int", "fill_constant", {}, {"Out": 1},
     {"shape": [1], "dtype": "int64", "value": 4.0}),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     {"Input": {"x": _i(0, 9, 3, 5)}}, {"Out": 1},
     {"shape": [-1, 2, 4], "dtype": "float32", "value": 0.5,
      "input_dim_idx": 0, "output_dim_idx": 0}),
    # gather keeps Index's shape: [4, 1] rows of [5, 3] give [4, 1, 3]
    ("gather_index_2d", "gather",
     {"X": {"x": _f(5, 3)}, "Index": {"i": _i(0, 5, 4, 1)}}, {"Out": 1},
     {}),
    # jnp.take's "fill" mode: -1 counts from the end, 7 >= N reads the
    # fill value, NaN for a float X and the most negative value of the
    # type for a signed integer X (-2**31 for int32)
    ("gather_out_of_range", "gather",
     {"X": {"x": _f(5, 3)},
      "Index": {"i": np.array([-1, 0, 7], "int64")}}, {"Out": 1}, {}),
    ("gather_out_of_range_int", "gather",
     {"X": {"x": _i(-9, 9, 5, 3).astype("int32")},
      "Index": {"i": np.array([-1, 0, 7, -6], "int64")}}, {"Out": 1}, {}),
    ("greater_than", "greater_than",
     {"X": {"x": _f(5)}, "Y": {"y": _f(1)}}, {"Out": 1}, {}),
    ("increment", "increment", {"X": {"x": _i(0, 9, 1)}}, {"Out": 1},
     {"step": 1}),
    ("increment_float", "increment", {"X": {"x": _f(3)}}, {"Out": 1},
     {"step": 0.5}),
    ("layer_norm", "layer_norm",
     {"X": {"x": _f(2, 3, 32) * 3 + 1}, "Scale": {"s": _f(32)},
      "Bias": {"b": _f(32) * 0.1}},
     {"Y": 1, "Mean": 1, "Variance": 1},
     {"epsilon": 1e-5, "begin_norm_axis": 2}),
    ("layer_norm_ragged_d", "layer_norm",
     {"X": {"x": _f(5, 3, 7)}, "Scale": {"s": _f(21)},
      "Bias": {"b": _f(21)}},
     {"Y": 1, "Mean": 1, "Variance": 1},
     {"epsilon": 1e-5, "begin_norm_axis": 1}),
    ("less_than", "less_than",
     {"X": {"x": _i(0, 9, 1)}, "Y": {"y": _i(3, 6, 1)}}, {"Out": 1}, {}),
    ("lookup_table", "lookup_table",
     {"Ids": {"ids": _i(0, 10, 4, 1)}, "W": {"w": _f(10, 8)}},
     {"Out": 1}, {"padding_idx": -1}),
    ("lookup_table_padding", "lookup_table",
     {"Ids": {"ids": _i(0, 4, 3, 5)}, "W": {"w": _f(4, 6)}},
     {"Out": 1}, {"padding_idx": 2}),
    # jnp.take's "fill" mode: 11 >= V reads a NaN row, -1 counts from
    # the end
    ("lookup_table_out_of_range", "lookup_table",
     {"Ids": {"ids": np.array([[11], [-1], [3]], "int64")},
      "W": {"w": _f(10, 3)}}, {"Out": 1}, {"padding_idx": -1}),
    # the padding mask reads the raw ids: -2 reads row 2 (== padding_idx)
    # unmasked, 2 itself gives zeros, 5 a NaN row
    ("lookup_table_padding_negative_id", "lookup_table",
     {"Ids": {"ids": np.array([[2], [-2], [-1], [5], [1]], "int64")},
      "W": {"w": _f(4, 6)}}, {"Out": 1}, {"padding_idx": 2}),
    ("matmul", "matmul",
     {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(2, 5, 4)}}, {"Out": 1},
     {"transpose_X": False, "transpose_Y": True, "alpha": 0.5}),
    ("matmul_broadcast", "matmul",
     {"X": {"x": _f(2, 2, 1, 4)}, "Y": {"y": _f(2, 2, 4, 6)}},
     {"Out": 1}, {"transpose_X": False, "transpose_Y": False,
                  "alpha": 1.0}),
    # an integer X: float32, as jnp.mean promotes it
    ("mean_int", "mean", {"X": {"x": _i(0, 9, 3, 4)}}, {"Out": 1}, {}),
    ("mul", "mul", {"X": {"x": _f(2, 3, 4)}, "Y": {"y": _f(4, 5)}},
     {"Out": 1}, {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    ("range", "range", {}, {"Out": 1},
     {"start": 0.0, "end": 7.0, "step": 1.0, "dtype": "int64"}),
    ("reduce_sum_dim", "reduce_sum", {"X": {"x": _f(3, 4, 5)}},
     {"Out": 1}, {"dim": [1], "keep_dim": True, "reduce_all": False}),
    ("reduce_sum_all_int", "reduce_sum", {"X": {"x": _i(0, 3, 4, 2)}},
     {"Out": 1}, {"dim": [0], "keep_dim": True, "reduce_all": True}),
    # dim [] without reduce_all sums over no axis: X unchanged, as
    # jnp.sum(x, axis=()), whatever keep_dim says
    ("reduce_sum_no_dim", "reduce_sum", {"X": {"x": _f(3, 4)}},
     {"Out": 1}, {"dim": [], "keep_dim": False, "reduce_all": False}),
    ("reduce_sum_no_dim_keep", "reduce_sum", {"X": {"x": _f(3, 4)}},
     {"Out": 1}, {"dim": [], "keep_dim": True, "reduce_all": False}),
    ("relu", "relu", {"X": {"x": _f(4, 5)}}, {"Out": 1}, {}),
    ("reshape2", "reshape2", {"X": {"x": _f(2, 3, 4)}}, {"Out": 1},
     {"shape": [0, -1, 2]}),
    ("scale", "scale", {"X": {"x": _f(3, 3)}}, {"Out": 1},
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": True}),
    ("scale_bias_first", "scale", {"X": {"x": _f(3, 3)}}, {"Out": 1},
     {"scale": -1.5, "bias": 1.0, "bias_after_scale": False}),
    ("scale_int", "scale", {"X": {"x": _i(0, 2, 4)}}, {"Out": 1},
     {"scale": 3.0, "bias": 0.0, "bias_after_scale": True}),
    ("softmax", "softmax", {"X": {"x": _f(3, 9) * 4}}, {"Out": 1},
     {"axis": -1}),
    ("split_num", "split", {"X": {"x": _f(2, 9)}}, {"Out": 3},
     {"num": 3, "sections": [], "axis": 1}),
    ("split_sections", "split", {"X": {"x": _f(7, 2)}}, {"Out": 2},
     {"num": 0, "sections": [3, -1], "axis": 0}),
    ("transpose2", "transpose2", {"X": {"x": _f(2, 3, 4, 5)}}, {"Out": 1},
     {"axis": [0, 2, 1, 3]}),
    ("unsqueeze2", "unsqueeze2", {"X": {"x": _f(3, 4)}}, {"Out": 1},
     {"axes": [1]}),
]


def _run_one_op(pkg, place, op_type, inputs, out_slots, attrs):
    prog = pkg.Program()
    blk = prog.global_block
    feed = {}
    op_inputs = {}
    for slot, named in inputs.items():
        op_inputs[slot] = []
        for name, arr in named.items():
            blk.create_var(name=name, shape=arr.shape,
                           dtype=str(arr.dtype))
            feed[name] = arr
            op_inputs[slot].append(name)
    outs = {slot: [f"{slot.lower()}_{i}" for i in range(n)]
            for slot, n in out_slots.items()}
    blk.append_op(op_type, op_inputs, outs, dict(attrs))
    fetch = [n for names in outs.values() for n in names]
    exe = pkg.Executor(place)
    return exe.run(prog, feed=feed, fetch_list=fetch, scope=pkg.Scope())


def _assert_same(j, p, what):
    j, p = np.asarray(j), np.asarray(p)
    assert j.shape == p.shape, (what, j.shape, p.shape)
    if j.dtype.kind == "f" or p.dtype.kind == "f":
        assert j.dtype.kind == p.dtype.kind == "f", (what, j.dtype, p.dtype)
        np.testing.assert_allclose(p, j, rtol=0, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(p.astype(np.int64),
                                      j.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_paddle_tpu(case):
    cid, op_type, inputs, out_slots, attrs = case
    jout = _run_one_op(jf, jf.CPUPlace(), op_type, inputs, out_slots,
                       attrs)
    pout = _run_one_op(pf, pf.CPUPlace(), op_type, inputs, out_slots,
                       attrs)
    assert len(jout) == len(pout)
    for i, (j, p) in enumerate(zip(jout, pout)):
        _assert_same(j, p, f"{cid} output {i}")


def test_gather_and_integer_mean_declare_their_outputs_at_build_time():
    """Build-time inference: gather's output is Index.shape +
    X.shape[1:], the mean of an integer var a float32 [1], in both
    packages, for a fixed and a batch (-1) leading dim."""
    for pkg in (jf, pf):
        prog = pkg.Program()
        blk = prog.global_block
        blk.create_var(name="x", shape=(5, 3), dtype="float32")
        blk.create_var(name="i", shape=(4, 1), dtype="int64")
        blk.create_var(name="n", shape=(3, 4), dtype="int64")
        blk.append_op("gather", {"X": ["x"], "Index": ["i"]},
                      {"Out": ["o"]}, {})
        blk.append_op("mean", {"X": ["n"]}, {"Out": ["m"]}, {})
        assert tuple(blk.var("o").shape) == (4, 1, 3), pkg.__name__
        assert tuple(blk.var("m").shape) == (1,), pkg.__name__
        assert blk.var("m").dtype.name == "FP32", pkg.__name__
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.layers.data("x", shape=[3], dtype="float32")
            i = pkg.layers.data("i", shape=[1], dtype="int64")
            assert tuple(pkg.layers.gather(x, i).shape) == (-1, 1, 3)


def _while_program(pkg):
    """x doubles while i < 5: a while op over a sub-block with a
    carried counter, condition and tensor, and an external."""
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.program_guard(main, startup):
        x = L.data("x", shape=[3], dtype="float32")
        two = L.fill_constant([1], "float32", 2.0)
        i = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 5)
        acc = L.assign(x)
        cond = L.less_than(i, limit)
        w = L.While(cond)
        with w.block():
            L.assign(L.elementwise_mul(acc, two), output=acc)
            L.increment(i, 1)
            L.less_than(i, limit, cond=cond)
    return main, acc, i


def test_while_matches_paddle_tpu():
    x = _f(2, 3)
    outs = []
    for pkg in (jf, pf):
        main, acc, i = _while_program(pkg)
        while_ops = [op for op in main.global_block.ops
                     if op.type == "while"]
        assert len(while_ops) == 1
        outs.append(pkg.Executor(pkg.CPUPlace()).run(
            main, feed={"x": x}, fetch_list=[acc, i], scope=pkg.Scope()))
    (ja, ji), (pa, pi) = outs
    _assert_same(ja, pa, "while acc")
    _assert_same(ji, pi, "while counter")
    np.testing.assert_allclose(pa, x * 32, rtol=1e-6)
    assert int(pi[0]) == 5


def test_uniform_random_range_shape_and_seed():
    def draw(seed_attr, run_seed):
        prog = pf.Program()
        prog.random_seed = run_seed
        prog.global_block.append_op(
            "uniform_random", {}, {"Out": ["u"]},
            {"shape": [64, 32], "dtype": "float32", "min": -0.25,
             "max": 0.75, "seed": seed_attr})
        return pf.Executor(pf.CPUPlace()).run(
            prog, fetch_list=["u"], scope=pf.Scope())[0]

    u = draw(0, 3)
    assert u.shape == (64, 32) and u.dtype == np.float32
    assert u.min() >= -0.25 and u.max() < 0.75
    assert abs(u.mean() - 0.25) < 0.03  # 2048 draws: sd of mean ~0.006
    np.testing.assert_array_equal(u, draw(0, 3))
    assert not np.array_equal(u, draw(0, 4))
    # a nonzero seed attr pins the draw whatever the run's seed
    np.testing.assert_array_equal(draw(11, 3), draw(11, 4))
