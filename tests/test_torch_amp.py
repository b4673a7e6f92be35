"""bf16 AMP in the port (``paddle_tpu_torch/amp.py``) against the JAX
package's (``paddle_tpu/amp.py``): the policy per op type, training
under ``amp_guard``, the Executor's cache keys, and C14, the plain
attention composition's P rounded to the input dtype before P v.

Tolerances:
- the policy and the dtypes are exact: the same casts, the same dtype of
  every value.
- C14: the port's `_sdpa` and the JAX package's on the same bf16 inputs
  compute in fp32 and round to bf16 once, with P rounded to bf16 before
  P v; they may differ by one bf16 rounding (2^-8 of the largest
  |output|) where their fp32 values straddle a rounding boundary, in at
  most 1% of the elements. Keeping P in fp32 (the parent's composition)
  moves 41-42% of them.
- the Transformer under AMP (torch_amp_setup.py): 3 Adam steps' losses
  within 1e-4 relative of the JAX package's bf16 run, which must be
  tighter than either package's own gap between its bf16 and its fp32
  losses (1e-4 to 1.2e-4 after 3 steps). Both round the same activations
  to bf16, but their fp32 sums differ in order, so a value near a
  rounding boundary may round either way; each such flip spreads through
  the later layers, so element-wise agreement decays with depth and the
  losses, which average over every token, are what the two hold
  alike.
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import amp as jamp
from paddle_tpu.ops import nn_ops as j_nn_ops
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.ops import nn_ops as p_nn_ops
from torch_amp_setup import check_amp_training


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fc_program(pkg, hidden=32):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", shape=[16], dtype="float32")
        y = pkg.layers.data("y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, hidden, act="relu")
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def _separable_batch(n=64, seed=0):
    r = np.random.RandomState(seed)
    y = r.randint(0, 4, (n, 1)).astype(np.int64)
    x = r.randn(n, 16).astype(np.float32) * 0.1
    x[np.arange(n), y[:, 0]] += 2.0
    return x, y


def test_lists_are_the_reference_lists():
    assert pamp.WHITE_LIST == jamp.WHITE_LIST
    assert pamp.BLACK_LIST == jamp.BLACK_LIST
    assert pamp.KEEP_LIST == jamp.KEEP_LIST


def test_amp_training_converges():
    with p_unique_name.guard():
        main, startup, loss = _fc_program(pf)
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    x, y = _separable_batch()
    with pamp.amp_guard(True):
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed={"x": x, "y": y},
                                fetch_list=[loss], scope=scope)[0])
                  for _ in range(30)]
    assert losses[-1] < losses[0] * 0.5, losses[::10]
    assert np.isfinite(losses[-1])


def test_amp_params_stay_fp32_and_white_ops_compute_bf16():
    with p_unique_name.guard():
        main, startup, loss = _fc_program(pf)
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    x, y = _separable_batch()
    mul_out = next(op.outputs["Out"][0] for op in main.global_block.ops
                   if op.type == "mul")
    with pamp.amp_guard(True):
        exe.run(startup, scope=scope)
        h, lval = exe.run(main, feed={"x": x, "y": y},
                          fetch_list=[mul_out, loss], scope=scope,
                          return_numpy=False)
    assert h.dtype == torch.bfloat16
    assert lval.dtype == torch.float32  # mean is BLACK
    params = [p.name for p in main.all_parameters()]
    assert params
    for n in params:
        assert scope._get(n).dtype == torch.float32, n
    h = exe.run(main, feed={"x": x, "y": y}, fetch_list=[mul_out],
                scope=scope, return_numpy=False)[0]
    assert h.dtype == torch.float32  # AMP off: pure fp32


def _values(kind, pkg):
    """An input value of `kind` in `pkg`'s array type."""
    if pkg == "jax":
        import jax.numpy as jnp

        dt = {"f32": jnp.float32, "bf16": jnp.bfloat16,
              "i64": jnp.int32}[kind]
        return jnp.zeros((2,), dt)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16,
          "i64": torch.int64}[kind]
    return torch.zeros(2, dtype=dt)


def _dtype_name(v):
    if v is None:
        return None
    name = str(v.dtype).replace("torch.", "")
    return "int" if "int" in name else name


GLUE_OPS = ["elementwise_add", "relu", "reshape2", "dropout", "scale"]
INPUT_SETS = [("f32", "f32"), ("bf16", "bf16"), ("f32", "bf16"),
              ("i64", "f32"), ("i64", "bf16"), ("f32", None)]


@pytest.mark.parametrize("op_type", sorted(
    jamp.WHITE_LIST | jamp.BLACK_LIST | jamp.KEEP_LIST) + GLUE_OPS)
@pytest.mark.parametrize("grad", [False, True])
def test_cast_op_inputs_matches_reference(op_type, grad):
    """Every op type of the three lists and some glue ops, forward and
    grad (a grad op takes its forward's color), over fp32, bf16, mixed,
    integer and missing inputs: the same dtype in every slot."""
    name = op_type + ("_grad" if grad else "")
    for kinds in INPUT_SETS:
        ins = {f"S{i}": [None if k is None else _values(k, "jax")]
               for i, k in enumerate(kinds)}
        want = jamp.cast_op_inputs(name, ins)
        ins = {f"S{i}": [None if k is None else _values(k, "torch")]
               for i, k in enumerate(kinds)}
        got = pamp.cast_op_inputs(name, ins)
        assert {s: [_dtype_name(v) for v in vs] for s, vs in got.items()} \
            == {s: [_dtype_name(v) for v in vs] for s, vs in want.items()}, \
            (name, kinds)


def test_amp_guard_custom_lists_and_state_token():
    assert not pamp.enabled() and pamp.state_token() is False
    with pamp.amp_guard(True, custom_white_list=["my_op"],
                        custom_black_list=["softmax", "my_black"]):
        assert pamp.enabled() and pamp.state_token() is True
        assert "my_op" in pamp.WHITE_LIST and "my_black" in pamp.BLACK_LIST
        out = pamp.cast_op_inputs("my_op", {"X": [torch.zeros(2)]})
        assert out["X"][0].dtype == torch.bfloat16
    assert not pamp.enabled()
    assert "my_op" not in pamp.WHITE_LIST
    assert "my_black" not in pamp.BLACK_LIST
    assert "softmax" in pamp.BLACK_LIST  # was there before: kept
    pamp.enable(True)
    try:
        assert pamp.enabled()
    finally:
        pamp.enable(False)


def test_cache_misses_on_an_amp_toggle():
    """A program prepared with AMP off never runs with it on, and the
    other way round: the toggle misses the cache, toggling back hits the
    first entry, and a `prepare` handle re-binds."""
    with p_unique_name.guard():
        main, startup, loss = _fc_program(pf)
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    exe.run(startup, scope=scope)
    x, y = _separable_batch()
    mul_out = next(op.outputs["Out"][0] for op in main.global_block.ops
                   if op.type == "mul")
    feed = {"x": x, "y": y}

    def run():
        return exe.run(main, feed=feed, fetch_list=[mul_out], scope=scope,
                       return_numpy=False)[0].dtype

    assert run() == torch.float32
    hits = exe.cache_hit_count
    with pamp.amp_guard(True):
        assert run() == torch.bfloat16
    assert exe.cache_hit_count == hits
    assert run() == torch.float32
    assert exe.cache_hit_count == hits + 1
    with pamp.amp_guard(True):
        assert run() == torch.bfloat16
    assert exe.cache_hit_count == hits + 2
    handle = exe.prepare(main, feed, [mul_out], scope)
    assert handle.run(feed, return_numpy=False)[0].dtype == torch.float32
    with pamp.amp_guard(True):
        assert handle.run(feed, return_numpy=False)[0].dtype == \
            torch.bfloat16
    assert handle.run(feed, return_numpy=False)[0].dtype == torch.float32


# --------------------------------------------------------------------------
# C14: the plain composition rounds P to the input dtype before P v
# --------------------------------------------------------------------------
SDPA_REL = 2 ** -8
SDPA_SHARE = 0.01


def _gate(got, want):
    g, w = got.float(), want.float()
    return (float((g - w).abs().max()) / float(w.abs().max()),
            float((g != w).float().mean()))


def _bf16_pair(shape, seed):
    import jax.numpy as jnp

    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x, dtype=jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16)


def _to_torch(a):
    import jax.numpy as jnp

    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_rounds_p_to_the_input_dtype(causal):
    """C14: `_sdpa` on bf16 [2,300,4,64] (bthd) in both packages."""
    (jq, tq), (jk, tk), (jv, tv) = (_bf16_pair((2, 300, 4, 64), s)
                                    for s in (1, 2, 3))
    want = _to_torch(j_nn_ops._sdpa(jq, jk, jv, 0.125, causal, "bthd"))
    got = p_nn_ops._sdpa(tq, tk, tv, 0.125, causal, "bthd")
    assert got.dtype == torch.bfloat16
    rel, share = _gate(got, want)
    assert rel <= SDPA_REL and share <= SDPA_SHARE, (rel, share)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_op_bf16_matches_reference_at_t256(causal):
    """The attention op itself (bthd, T 256: the plain composition in
    both packages, the path Transformer takes at the bench's seq 256) on
    bf16 q, k, v."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as preg

    shape = (2, 256, 4, 64)
    pairs = [_bf16_pair(shape, s) for s in (4, 5, 6)]
    attrs = {"causal": causal, "scale": 0.125, "layout": "bthd"}
    outs = []
    for pkg, reg, idx in ((jf, jreg, 0), (pf, preg, 1)):
        blk = pkg.Program().global_block
        for n in ("Q", "K", "V"):
            blk.create_var(name=n, shape=shape, dtype="bfloat16")
        op = blk.append_op("attention", {"Q": ["Q"], "K": ["K"],
                                         "V": ["V"]},
                           {"Out": ["O"]}, attrs)
        env = dict(zip(("Q", "K", "V"), (p[idx] for p in pairs)))
        if idx:
            reg.run_op(op, env, torch.device("cpu"))
        else:
            reg.run_op(op, env)
        outs.append(env["O"])
    want, got = _to_torch(outs[0]), outs[1]
    assert got.dtype == torch.bfloat16
    rel, share = _gate(got, want)
    assert rel <= SDPA_REL and share <= SDPA_SHARE, (rel, share)


FUSED_CASES = {
    "attention_block": ({"X": (2, 8, 16), "WQKV": (16, 48), "WO": (16, 16)},
                        {"n_heads": 2, "scale": 0.25, "causal": True}),
    "ffn_block": ({"X": (2, 8, 16), "W1": (16, 32), "B1": (32,),
                   "W2": (32, 16), "B2": (16,)}, {}),
}


@pytest.mark.parametrize("block", sorted(FUSED_CASES))
def test_amp_fused_blocks_reach_their_wrappers_in_bf16_and_launch_on_card(
        block, monkeypatch):
    """Under AMP the fused ops (WHITE list) get bf16 inputs and route to
    their kernel wrappers, as the JAX package's gate takes bf16; on the
    CPU the wrapper computes the plain version's contract (fp32
    arithmetic, one rounding to bf16). Where a card is present, the
    wrapper's card path launches the bf16 kernel (#10 or #12: the launch
    counter moves) and never the plain version in its place."""
    from paddle_tpu_torch.core import registry as preg
    from paddle_tpu_torch.ops.kernels import attention_block as KAB
    from paddle_tpu_torch.ops.kernels import ffn_block as KFF

    shapes, attrs = FUSED_CASES[block]
    mod = KAB if block == "attention_block" else KFF
    blk = pf.Program().global_block
    for n, shape in shapes.items():
        blk.create_var(name=n, shape=shape, dtype="float32")
    op = blk.append_op(block, {n: [n] for n in shapes}, {"Out": ["Out"]},
                       attrs)
    r = np.random.RandomState(3)
    env = {n: torch.from_numpy(r.randn(*shape).astype(np.float32) * 0.3)
           for n, shape in shapes.items()}
    seen, real = [], getattr(mod, block)
    monkeypatch.setattr(mod, block,
                        lambda *a: seen.append(a[0].dtype) or real(*a))
    with pamp.amp_guard(True):
        preg.run_op(op, env, torch.device("cpu"))
    assert seen == [torch.bfloat16]
    assert env["Out"].dtype == torch.bfloat16
    args = [env[n].to(torch.bfloat16) for n in shapes]
    if block == "attention_block":
        want = KAB.attention_block_plain(*args, 2, 0.25, True)
    else:
        want = KFF.ffn_block_plain(*args)
    assert torch.equal(env["Out"], want)
    if not torch.cuda.is_available():
        return
    launches = real.launches
    cuda_args = [a.cuda() for a in args]
    if block == "attention_block":
        got = KAB._attention_block_launch(*cuda_args, 2, 0.25, True, False)
    else:
        got = KFF._ffn_block_launch(*cuda_args)
    torch.cuda.synchronize()
    assert real.launches == launches + 1
    assert got.dtype == torch.bfloat16
    # one bf16 rounding apart: at most an ulp of the element, 2^-7 of it
    g, w = got.cpu().float(), want.float()
    assert float((g - w).abs().max()) <= 2 ** -7 * float(w.abs().max())


# --------------------------------------------------------------------------
# Transformer under AMP, both packages (torch_amp_setup.py)
# --------------------------------------------------------------------------
def test_transformer_amp_matches_reference_at_seq_264(tmp_path):
    """Every attention op takes sdpa_short (#5, #6) at seq 264."""
    check_amp_training(264, tmp_path)
