"""The port's executable cost model (paddle_tpu_torch/observability/
costmodel.py) on the CPU. The JAX package reads its snapshots off XLA's
``cost_analysis()``; the port counts the Program (``program_cost``):

* a small fc stack and one decode tick against counts written out by
  hand (the tick's products and attention per the rule: 2·M·N·K a
  product, 4·B·H·Tq·Tk·Dh the paged attention, its While body once);
* the key-0 serve program of a tiny bundle within a factor of 2 of the
  JAX package's XLA snapshot (the measured ratio is written below);
* the lazy snapshot (noted at each PreparedProgram build, counted at the
  first lookup at FLAGS_observability >= metrics) and the calibration
  (the median of a bounded window of achieved rates) against the JAX
  package's ExecutableCostModel on the same samples.
"""
import math

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu.flags import FLAGS as JFLAGS
from paddle_tpu.observability import costmodel as jcm
from paddle_tpu_torch import ir as pir
from paddle_tpu_torch.flags import FLAGS
from paddle_tpu_torch.observability import costmodel as pcm

from torch_paged_setup import BS, MODEL, PortModel, paged_cache

# the port's key-0 serve flops over the JAX package's XLA flops, for the
# dense bundle of 4 lanes below (measured: 186934 / 195788); XLA counts
# a few more elementwise and bookkeeping ops
KEY0_DENSE_RATIO = 186934 / 195788


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _obs_hermetic():
    saved = (FLAGS._values["observability"],
             JFLAGS._values["observability"])
    yield
    FLAGS._values["observability"], JFLAGS._values["observability"] = saved


def _set_level(level):
    FLAGS._values["observability"] = level
    JFLAGS._values["observability"] = level


def _fc_stack():
    """x [B, 16] -> fc 32 relu -> fc 8."""
    main, startup = pf.Program(), pf.Program()
    with pf.program_guard(main, startup):
        x = pf.layers.data("x", shape=[16], dtype="float32")
        h = pf.layers.fc(x, 32, act="relu")
        out = pf.layers.fc(h, 8)
    return main, startup, out


def test_fc_stack_hand_count():
    main, _, _ = _fc_stack()
    assert [op.type for op in main.global_block.ops] == [
        "mul", "elementwise_add", "relu", "mul", "elementwise_add"]
    B = 4
    got = pcm.program_cost(main, [("x", (B, 16), "float32")])
    products = 2 * B * 16 * 32 + 2 * B * 32 * 8
    elementwise = B * 32 + B * 32 + B * 8   # two bias adds and the relu
    f = 4  # bytes a float32
    nbytes = f * (
        (B * 16 + 16 * 32 + B * 32)          # mul 1: x, w1, out
        + (B * 32 + 32 + B * 32)             # bias add 1
        + (B * 32 + B * 32)                  # relu
        + (B * 32 + 32 * 8 + B * 8)          # mul 2
        + (B * 8 + 8 + B * 8))               # bias add 2
    assert got == dict(product_flops=products, attention_flops=0,
                       elementwise_flops=elementwise,
                       bytes_accessed=nbytes,
                       flops=products + elementwise)


def test_fc_stack_after_the_fuse_pass_keeps_its_products():
    """The IR pass fuses each mul + bias add into an `fc` op: the
    products stay 2·M·N·K each."""
    main, _, _ = _fc_stack()
    fused = main.clone(for_test=True)
    pir.apply_passes(fused, ["fc_fuse_pass"])
    assert "fc" in [op.type for op in fused.global_block.ops]
    B = 4
    a = pcm.program_cost(main, [("x", (B, 16), "float32")])
    b = pcm.program_cost(fused, [("x", (B, 16), "float32")])
    assert b["product_flops"] == a["product_flops"]


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_the_feed_sets_the_batch(batch):
    main, _, _ = _fc_stack()
    got = pcm.program_cost(main, [("x", (batch, 16), "float32")])
    assert got["product_flops"] == batch * (2 * 16 * 32 + 2 * 32 * 8)


def _tick_products(n_lanes, paged):
    """One decode tick of MODEL's decoder over n_lanes + 1 lanes, by
    hand: the position one-hot against its table, each layer's self qkv
    and output projections, the cross-attention query, scores, context
    and output, the FFN, and the logits; the self-attention over the
    cache is the paged op's (4·R·H·1·Tk·Dh, Tk the block table's pages
    times the page size) or, dense, two products over the whole buffer.
    Returns (products, attention)."""
    R = n_lanes + 1
    d, F, V = MODEL["d_model"], MODEL["d_inner"], MODEL["vocab"]
    H = MODEL["n_heads"]
    Dh = d // H
    T, S = MODEL["max_out_len"], MODEL["seq_len"]
    per_layer = (2 * R * d * 3 * d          # self q, k, v
                 + 2 * R * d * d            # self output
                 + 2 * R * d * d            # cross query
                 + 2 * R * H * S * Dh * 2   # cross scores and context
                 + 2 * R * d * d            # cross output
                 + 2 * R * d * F * 2)       # the FFN
    products = 2 * R * T * d + MODEL["n_layers"] * per_layer \
        + 2 * R * d * V
    if paged:
        tk = math.ceil(T / BS) * BS
        return products, MODEL["n_layers"] * 4 * R * H * tk * Dh
    return products + MODEL["n_layers"] * 2 * R * H * T * Dh * 2, 0


@pytest.fixture(scope="module")
def model():
    return PortModel()


@pytest.mark.parametrize("paged", [False, True])
def test_one_decode_tick_hand_count(model, paged):
    """The key-0 serve (no admission) is one tick: its While body counted
    once, whatever the burst's n_steps."""
    b = model.bundle(4, paged_cache(16, 4) if paged else None,
                     state_prefix="@cm/")
    got = pcm.program_cost(b.serves[0], b.serve_feed_spec(0))
    products, attention = _tick_products(4, paged)
    assert (got["product_flops"], got["attention_flops"]) == (
        products, attention)
    # an admission serve adds its prologue, never a second tick
    key = ("miss", 1) if paged else 1
    adm = pcm.program_cost(b.serves[key], b.serve_feed_spec(key))
    assert adm["product_flops"] > got["product_flops"]
    assert adm["attention_flops"] >= got["attention_flops"]


def test_while_body_counts_once():
    """A While's trip count is data: the program's cost is its body's
    once (as XLA counts it), the loop's condition ops included."""
    main, startup = pf.Program(), pf.Program()
    with pf.program_guard(main, startup):
        x = pf.layers.data("x", shape=[8], dtype="float32")
        i = pf.layers.fill_constant([1], "int64", 0)
        n = pf.layers.fill_constant([1], "int64", 5)
        cond = pf.layers.less_than(i, n)
        loop = pf.layers.While(cond)
        with loop.block():
            y = pf.layers.fc(x, 8, bias_attr=False)
            pf.layers.assign(y, x)
            pf.layers.increment(i, in_place=True)
            pf.layers.less_than(i, n, cond=cond)
    got = pcm.program_cost(main, [("x", (2, 8), "float32")])
    assert got["product_flops"] == 2 * 2 * 8 * 8
    # the condition twice (before and in the body), the increment once
    assert got["elementwise_flops"] == 1 + 1 + 1


@pytest.fixture(scope="module")
def jax_key0(model):
    """The JAX package's snapshot of the dense 4-lane bundle's key-0
    serve: prepared by its executor, resolved at metrics."""
    from paddle_tpu import unique_name as j_unique_name
    from paddle_tpu.models import transformer as JT

    import torch_radix_setup as R

    with j_unique_name.guard():
        jb = JT.build_decode_step_program(n_slots=4, state_prefix="@cj/",
                                          **MODEL)
    scope = R.jax_scope(model.params)
    jb.init_slot_state(scope)
    exe = jf.Executor(jf.CPUPlace())
    st = jb.state
    exe.prepare(jb.serves[0], feed=jb.serve_feed_spec(0),
                fetch_list=[st["tok_buf"], st["step"]], scope=scope)
    saved = JFLAGS._values["observability"]
    JFLAGS._values["observability"] = "metrics"
    try:
        return jcm.lookup(jb.serves[0])
    finally:
        JFLAGS._values["observability"] = saved


def test_key0_serve_within_a_factor_of_2_of_xla(model, jax_key0):
    b = model.bundle(4, state_prefix="@cj/")
    got = pcm.program_cost(b.serves[0], b.serve_feed_spec(0))
    ratio = got["flops"] / jax_key0["flops"]
    assert 0.5 <= ratio <= 2.0, ratio
    assert ratio == pytest.approx(KEY0_DENSE_RATIO, rel=0.02)
    assert 0.25 <= got["bytes_accessed"] / jax_key0["bytes_accessed"] \
        <= 4.0


def test_snapshot_is_lazy_and_follows_the_flag(model):
    """The Executor notes each PreparedProgram build; at off a lookup
    counts nothing, the first lookup at metrics counts the program at the
    build's feed shapes."""
    m = pcm.ExecutableCostModel()
    main, startup, out = _fc_stack()
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    exe.run(startup, scope=scope)
    before = exe.prepare_count
    exe.prepare(main, feed={"x": np.zeros((3, 16), np.float32)},
                fetch_list=[out], scope=scope)
    assert exe.prepare_count == before + 1
    m.note_executable(main, "block", pcm.feed_specs_of(
        main, {"x": np.zeros((3, 16), np.float32)}))
    _set_level("off")
    assert m.lookup(main) is None and m.probe_resolutions == 0
    _set_level("metrics")
    snap = m.lookup(main)
    assert m.probe_resolutions == 1
    assert snap["product_flops"] == 3 * (2 * 16 * 32 + 2 * 32 * 8)
    assert set(snap) <= set(pcm.snapshot_fields())
    assert m.lookup(main) is snap and m.probe_resolutions == 1
    # the spec-exact snapshot is picked by the feed
    assert m.lookup(main, {"x": np.zeros((3, 16), np.float32)}) is snap


def test_the_executor_notes_its_builds():
    _set_level("metrics")
    main, startup, out = _fc_stack()
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((5, 16), np.float32)},
            fetch_list=[out], scope=scope)
    snap = pcm.lookup(main, {"x": np.ones((5, 16), np.float32)})
    assert snap["product_flops"] == 5 * (2 * 16 * 32 + 2 * 32 * 8)
    assert snap["kind"] == "block"


def test_feed_specs_of_casts_within_the_family():
    main, _, _ = _fc_stack()
    specs = pcm.feed_specs_of(main, {"x": np.zeros((2, 16), np.float64)})
    assert specs == (("x", (2, 16), "float32"),)
    assert pcm.feed_specs_of(main, [("x", (2, 16), torch.float32)]) \
        == (("x", (2, 16), "float32"),)
    assert pcm.feed_specs_of(main, {"x": torch.zeros(2, 16)}) == specs


@pytest.mark.parametrize("samples", [
    [(1e9, 0.5)],
    [(1e9, 0.5), (3e9, 0.5), (2e9, 2.0)],
    [(float(i + 1) * 1e8, 0.01 * (i % 7 + 1)) for i in range(100)],
])
def test_calibration_equals_the_jax_model(samples):
    """The same observe() samples into both packages' models: the same
    median rate over the bounded window, the same expected_ms."""
    pm, jm = pcm.ExecutableCostModel(rate_window=64), \
        jcm.ExecutableCostModel(rate_window=64)
    assert pm.flops_per_s() is jm.flops_per_s() is None
    assert pm.expected_ms(1e6) is jm.expected_ms(1e6) is None
    for f, s in samples + [(0, 1.0), (1e9, 0.0)]:  # ignored samples
        pm.observe(f, s)
        jm.observe(f, s)
    assert pm.flops_per_s() == jm.flops_per_s()
    for flops in (1.0, 1e6, 2.5e9, None, 0):
        assert pm.expected_ms(flops) == jm.expected_ms(flops)
    pm.reset()
    assert pm.flops_per_s() is None


def test_metrics_samples_family_names_match():
    pm, jm = pcm.ExecutableCostModel(), jcm.ExecutableCostModel()
    assert [n for n, _, _ in pm._metrics_samples()] == \
        [n for n, _, _ in jm._metrics_samples()]
