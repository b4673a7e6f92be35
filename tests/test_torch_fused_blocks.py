"""The fused-block training path (PADDLE_TPU_FUSE_ATTN_BLOCK=1) against
the JAX package: the attention_block and ffn_block kernels' plain
versions against the Pallas kernels in interpret mode, their
autograd.Functions with the launches replaced by the plain versions, the
ops through the Executor's kernel path, and Transformer training built
with the knob in both packages.

Tolerances (fp32; the two libraries sum in different orders, nothing
else differs):
- forward outputs: 2e-5 absolute (the reference's own kernel test);
- the saved P: the TPU kernel rounds it to bf16, the port keeps fp32, so
  2^-8 relative (half a bf16 ulp is 2^-9) + 1e-6;
- gradients: 1e-5 of the largest |grad| of each, or 1e-5 absolute and
  relative where both sides run the same composition;
- training: losses 1e-5 relative, step-1 grads 1e-5 norm-wise
  (|a-b|/|b|).
"""
import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jf
import paddle_tpu_torch as pf
from paddle_tpu import unique_name as j_unique_name
from paddle_tpu.core import registry as j_registry
from paddle_tpu.models import transformer as JT
from paddle_tpu.ops.pallas import attention as j_attn
from paddle_tpu.ops.pallas import attention_block as JAB
from paddle_tpu.ops.pallas import ffn_block as JFB
from paddle_tpu_torch import unique_name as p_unique_name
from paddle_tpu_torch.core import registry as p_registry
from paddle_tpu_torch.models import decode_engine as PD
from paddle_tpu_torch.models import transformer as PT
from paddle_tpu_torch.ops.kernels import attention_block as KAB
from paddle_tpu_torch.ops.kernels import ffn_block as KFF

KNOB = "PADDLE_TPU_FUSE_ATTN_BLOCK"
CPU = torch.device("cpu")
# the reference's own model-level config (tests/test_attention_block.py)
CFG = dict(seq_len=8, d_model=32, n_heads=2, n_layers=2, d_inner=64,
           vocab=64, dropout_rate=0.0)
WARMUP = 40
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small so these tests do not crowd the
    timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret():
    """The JAX package's Pallas kernels in interpret mode, as its own
    tests run them on the CPU."""
    j_attn.force_interpret(True)
    yield
    j_attn.force_interpret(False)


def _attn_inputs(b=4, t=16, d=32, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(b, t, d).astype("float32")
    wqkv = (r.randn(d, 3 * d) / np.sqrt(d)).astype("float32")
    wo = (r.randn(d, d) / np.sqrt(d)).astype("float32")
    g = r.randn(b, t, d).astype("float32")
    return x, wqkv, wo, g


def _ffn_inputs(b=4, t=16, d=32, f=64, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, t, d).astype("float32"),
            (r.randn(d, f) / np.sqrt(d)).astype("float32"),
            (r.randn(f) * 0.1).astype("float32"),
            (r.randn(f, d) / np.sqrt(f)).astype("float32"),
            (r.randn(d) * 0.1).astype("float32"),
            r.randn(b, t, d).astype("float32"))


def _close_to_scale(got, want, rtol=1e-5, name=""):
    got, want = np.asarray(got, "float32"), np.asarray(want, "float32")
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (name, err)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
HEADS, SCALE = 4, (32 // 4) ** -0.5


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_plain_matches_pallas_interpret(interpret, causal):
    x, wqkv, wo, _ = _attn_inputs(seed=1)
    want, want_p = JAB._fwd_impl(jnp.asarray(x), jnp.asarray(wqkv),
                                 jnp.asarray(wo), HEADS, SCALE, causal,
                                 save_p=True)
    got, p = KAB.attention_block_fwd_plain(*_t(x, wqkv, wo), HEADS, SCALE,
                                           causal, save_p=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(
        KAB.attention_block_plain(*_t(x, wqkv, wo), HEADS, SCALE,
                                  causal).numpy(), got.numpy(), rtol=0,
        atol=0)
    assert p.shape == (4, HEADS, 16, 16) and p.dtype == torch.float32
    want_p = np.asarray(want_p.astype(jnp.float32))
    np.testing.assert_allclose(p.numpy(), want_p, rtol=2 ** -8 + 1e-6,
                               atol=1e-6)
    if causal:
        iu = np.triu_indices(16, 1)
        assert (p.numpy()[:, :, iu[0], iu[1]] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_bwd_plain_matches_pallas_interpret(interpret,
                                                            causal):
    """(dx, dwqkv, dwo) from the JAX kernel's own bf16 P, cast to fp32 on
    the port's side, against `_bwd_impl`: only the summation order
    differs."""
    x, wqkv, wo, g = _attn_inputs(seed=2)
    _, p = JAB._fwd_impl(jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo),
                         HEADS, SCALE, causal, save_p=True)
    want = JAB._bwd_impl(jnp.asarray(x), jnp.asarray(wqkv), jnp.asarray(wo),
                         p, jnp.asarray(g), HEADS, SCALE, causal)
    p32 = np.asarray(p.astype(jnp.float32))
    got = KAB.attention_block_bwd_plain(*_t(x, wqkv, wo, p32, g), HEADS,
                                        SCALE, causal)
    for name, a, b in zip(("dx", "dwqkv", "dwo"), got, want):
        _close_to_scale(a.numpy(), b, name=name)


def _attn_reference_vjp(x, wqkv, wo, g, causal):
    out, vjp = jax.vjp(
        lambda *a: JAB.attention_block_reference(*a, HEADS, SCALE, causal),
        *map(jnp.asarray, (x, wqkv, wo)))
    return out, vjp(jnp.asarray(g))


def _ffn_reference_vjp(x, w1, b1, w2, b2, g):
    out, vjp = jax.vjp(JFB.ffn_block_reference,
                       *map(jnp.asarray, (x, w1, b1, w2, b2)))
    return out, vjp(jnp.asarray(g))


def test_ffn_block_plain_matches_pallas_interpret(interpret):
    """The forward and all five grads against the interpret kernels."""
    x, w1, b1, w2, b2, g = _ffn_inputs(seed=3)
    jargs = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = JFB._fwd_impl(*jargs)
    got = KFF.ffn_block_plain(*_t(x, w1, b1, w2, b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)
    want = JFB._bwd_impl(*jargs, jnp.asarray(g))
    got = KFF.ffn_block_bwd_plain(*_t(x, w1, b1, w2, g))
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as the card's split-TF32 kernels round the big half of an
    operand): what a kernel that dropped its products' small halves would
    compute on."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_rounding_matches_the_bit_pattern():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -12), 3.0 + 2 ** -20])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -1.0,
                                 3.0]


FUSED_RTOL = 1e-5  # the card's gate on the fused kernels' outputs, grads


@pytest.mark.parametrize("case", ["attention_fwd", "attention_fwd_causal",
                                  "ffn_fwd", "ffn_bwd"])
def test_tf32_control_fails_the_fused_gate(case):
    """The card holds the split-TF32 attention_block forward and ffn_block
    forward and backward to FUSED_RTOL of the largest |plain| against
    their plain versions. That gate must see TF32 rounding: the plain
    versions on TF32-rounded operands exceed it against fp32 at a small
    shape, so a kernel that dropped the small halves of its products would
    fail."""
    b, t, d, h, f = 2, 16, 64, 2, 96
    if case.startswith("attention"):
        x, wqkv, wo, _ = _t(*_attn_inputs(b, t, d, seed=11))
        causal = case.endswith("causal")
        scale = (d // h) ** -0.5
        want, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale,
                                                 causal, save_p=True)
        got, p = KAB.attention_block_fwd_plain(
            *map(_tf32, (x, wqkv, wo)), h, scale, causal, save_p=True)
        pairs = [(got, want)]
        assert float((p - wp).abs().max()) > 1e-6  # the card's P gate
    elif case == "ffn_fwd":
        x, w1, b1, w2, b2, _ = _t(*_ffn_inputs(b, t, d, f, seed=12))
        pairs = [(KFF.ffn_block_plain(*map(_tf32, (x, w1, b1, w2, b2))),
                  KFF.ffn_block_plain(x, w1, b1, w2, b2))]
    else:
        x, w1, b1, w2, _, g = _t(*_ffn_inputs(b, t, d, f, seed=12))
        want = KFF.ffn_block_bwd_plain(x, w1, b1, w2, g)
        got = KFF.ffn_block_bwd_plain(*map(_tf32, (x, w1, b1, w2, g)))
        pairs = list(zip(got, want))
    worst = max(float((a - w).abs().max()) / float(w.abs().max())
                for a, w in pairs)
    assert worst > FUSED_RTOL, worst


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_bwd_plain_is_the_reference_vjp(causal):
    """The plain backward fed the plain forward's fp32 P is the vjp of
    `attention_block_reference`."""
    x, wqkv, wo, g = _attn_inputs(seed=4)
    _, p = KAB.attention_block_fwd_plain(*_t(x, wqkv, wo), HEADS, SCALE,
                                         causal, save_p=True)
    got = KAB.attention_block_bwd_plain(*_t(x, wqkv, wo), p,
                                        torch.from_numpy(g), HEADS, SCALE,
                                        causal)
    _, want = _attn_reference_vjp(x, wqkv, wo, g, causal)
    for name, a, b in zip(("dx", "dwqkv", "dwo"), got, want):
        _close_to_scale(a.numpy(), b, name=name)


def _row_sums(x, wqkv, wo, g, p):
    """On the same P [B,H,T,T]: the reference's row = sum(dP * P)
    (`_bwd_impl`'s jnp expression, dP = dctx v^T per head) and the
    backward kernel's delta = rowsum(dctx * ctx) with ctx = P v (torch):
    both [B,H,T]."""
    d = x.shape[-1]
    dh = d // HEADS
    xj, wj, woj, gj, pj = map(jnp.asarray, (x, wqkv, wo, g, p))
    qkv, dctx = xj @ wj, gj @ woj.T
    rows = []
    for h in range(HEADS):
        vh = qkv[..., 2 * d + h * dh:2 * d + (h + 1) * dh]
        dpn = dctx[..., h * dh:(h + 1) * dh] @ jnp.swapaxes(vh, -1, -2)
        rows.append(jnp.sum(dpn * pj[:, h], axis=-1))
    want = np.stack([np.asarray(r) for r in rows], axis=1)
    xt, wt, wot, gt, pt = _t(x, wqkv, wo, g, p)
    ctx = pt @ KAB._heads((xt @ wt).split(d, dim=2)[2], HEADS)
    got = (KAB._heads(gt @ wot.T, HEADS) * ctx).sum(-1)
    return got.numpy(), want


@pytest.mark.parametrize("causal", [False, True])
def test_backward_row_sum_is_the_references(interpret, causal):
    """The attention_block backward kernel takes the reference's row sum
    rowsum(dP * P) (`_bwd_impl`, attention_block.py:214) as
    rowsum(dctx * ctx), ctx = P v recomputed from the same P, so that it
    needs no T-wide row of dP. The two agree within fp32 rounding on the
    port's plain forward's P and on the JAX kernel's own saved P
    (interpret mode, bf16, widened)."""
    x, wqkv, wo, g = _attn_inputs(seed=5)
    _, p_port = KAB.attention_block_fwd_plain(*_t(x, wqkv, wo), HEADS,
                                              SCALE, causal, save_p=True)
    _, p_jax = JAB._fwd_impl(jnp.asarray(x), jnp.asarray(wqkv),
                             jnp.asarray(wo), HEADS, SCALE, causal,
                             save_p=True)
    for p in (p_port.numpy(), np.asarray(p_jax.astype(jnp.float32))):
        got, want = _row_sums(x, wqkv, wo, g, p)
        assert got.shape == want.shape == (4, HEADS, 16)
        _close_to_scale(got, want, rtol=1e-6, name="row")


def test_usable_takes_base_width_the_reference_refuses(interpret):
    """The reference's VMEM estimate refuses Transformer-base's width
    (d 512; ffn_block at every shape); the port keeps only the structural
    conditions and its kernels' head-width limit."""
    for b, t in ((64, 256), (32, 512)):
        x = jnp.zeros((b, t, 512))
        assert not JAB.usable(x, jnp.zeros((512, 1536)), 8)
        assert not JFB.usable(x, jnp.zeros((512, 2048)))
        xt = torch.empty(b, t, 512, device="meta")
        assert KAB.usable(xt, torch.empty(512, 1536, device="meta"), 8)
        assert KFF.usable(xt, torch.empty(512, 2048, device="meta"))
    x = torch.empty(2, 16, 64)
    assert KAB.usable(x, torch.empty(64, 192), 2)       # Dh 32
    assert not KAB.usable(x, torch.empty(64, 192), 3)   # D % H
    assert not KAB.usable(x, torch.empty(64, 192), 16)  # Dh 4
    assert not KAB.usable(torch.empty(2, 16, 512), torch.empty(512, 1536),
                          2)                            # Dh 256 > 128
    assert not KAB.usable(torch.empty(2, 520, 64), torch.empty(64, 192), 2)
    assert not KAB.usable(torch.empty(2, 12, 64), torch.empty(64, 192), 2)
    assert not KAB.usable(x.double(), torch.empty(64, 192).double(), 2)
    assert KFF.usable(x, torch.empty(64, 96))
    assert not KFF.usable(x, torch.empty(64, 100))      # F % 8
    assert not KFF.usable(torch.empty(2, 12, 64), torch.empty(64, 96))


# ---------------------------------------------------------------------------
# the autograd Functions with their launches replaced by the plain
# versions (the kernels run only on the card)
# ---------------------------------------------------------------------------
def _plain_launches(monkeypatch):
    """Replace both blocks' launches and backward wrappers by their plain
    versions, recording each call: (block, "fwd", P saved?) or (block,
    "bwd"). Like a kernel launch, each reads the storage of its tensors
    (a tensor wrapped by torch.func has none)."""
    calls = []

    def touch(args):
        for a in args:
            if isinstance(a, torch.Tensor):
                a.data_ptr()

    def attn_fwd(x, wqkv, wo, n_heads, scale, causal, save_p):
        touch((x, wqkv, wo))
        calls.append(("attn", "fwd", save_p))
        return KAB.attention_block_fwd_plain(x, wqkv, wo, n_heads, scale,
                                             causal, save_p=save_p)

    def ffn_fwd(*a):
        touch(a)
        calls.append(("ffn", "fwd"))
        return KFF.ffn_block_plain(*a)

    def bwd(block, plain):
        def run(*a):
            touch(a)
            calls.append((block, "bwd"))
            return plain(*a)
        return run

    monkeypatch.setattr(KAB, "_attention_block_launch", attn_fwd)
    monkeypatch.setattr(KAB, "attention_block_bwd",
                        bwd("attn", KAB.attention_block_bwd_plain))
    monkeypatch.setattr(KFF, "_ffn_block_launch", ffn_fwd)
    monkeypatch.setattr(KFF, "ffn_block_bwd",
                        bwd("ffn", KFF.ffn_block_bwd_plain))
    return calls


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_function_vjp_matches_reference(monkeypatch,
                                                        causal):
    """`torch.func.vjp` through the card's path under the Executor's
    no_grad: the forward launch saves P once, the backward launch runs
    once per vjp, and the grads are `jax.vjp` of
    `attention_block_reference`. Without a vjp the path is the primal
    launch, with no P."""
    calls = _plain_launches(monkeypatch)
    x, wqkv, wo, g = _attn_inputs(seed=5)

    def on_card(*a):
        return KAB.on_card(KAB.AttentionBlockFn, KAB._attention_block_launch,
                           *a, HEADS, SCALE, causal)

    with torch.no_grad():
        primal = on_card(*_t(x, wqkv, wo))
        assert calls == [("attn", "fwd", False)]
        out, vjp = torch.func.vjp(on_card, *_t(x, wqkv, wo))
        assert calls[1:] == [("attn", "fwd", True)]
        got = vjp(torch.from_numpy(g))
        assert calls[2:] == [("attn", "bwd")]
    want_out, want = _attn_reference_vjp(x, wqkv, wo, g, causal)
    for o in (primal, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_out), rtol=0,
                                   atol=2e-5)
    for name, a, b in zip(("dx", "dwqkv", "dwo"), got, want):
        _close_to_scale(a.numpy(), b, name=name)


def test_ffn_block_function_vjp_matches_reference(monkeypatch):
    calls = _plain_launches(monkeypatch)
    x, w1, b1, w2, b2, g = _ffn_inputs(seed=6)
    with torch.no_grad():
        primal = KFF._on_card(*_t(x, w1, b1, w2, b2))
        assert calls == [("ffn", "fwd")]
        out, vjp = torch.func.vjp(KFF._on_card, *_t(x, w1, b1, w2, b2))
        got = vjp(torch.from_numpy(g))
        assert calls[1:] == [("ffn", "fwd"), ("ffn", "bwd")]
    want_out, want = _ffn_reference_vjp(x, w1, b1, w2, b2, g)
    for o in (primal, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_out), rtol=0,
                                   atol=2e-5)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _close_to_scale(a.numpy(), b, name=name)


def _build_op(pkg, op_type, inputs, attrs):
    """One op in a fresh Program of `pkg`, inputs named by slot."""
    blk = pkg.Program().global_block
    for slot, a in inputs.items():
        blk.create_var(name=slot, shape=a.shape, dtype=str(a.dtype))
    return blk.append_op(op_type, {s: s for s in inputs}, {"Out": "Out"},
                         dict(attrs))


def _grads(pkg, registry, to_array, op, inputs, cot, run):
    env = {s: to_array(a) for s, a in inputs.items()}
    run(op, env)
    out = np.asarray(env["Out"])
    env["Out@GRAD"] = to_array(cot)
    (gop,) = registry.make_grad_ops(op)
    run(gop, env)
    return out, {n: np.asarray(env[n]) for n in gop.output_arg_names}


def _op_case(block):
    if block == "attn":
        x, wqkv, wo, g = _attn_inputs(b=2, t=8, seed=7)
        return ("attention_block", {"X": x, "WQKV": wqkv, "WO": wo},
                {"n_heads": HEADS, "scale": SCALE, "causal": True}, g)
    x, w1, b1, w2, b2, g = _ffn_inputs(b=2, t=8, seed=8)
    return ("ffn_block", {"X": x, "W1": w1, "B1": b1, "W2": w2, "B2": b2},
            {}, g)


@pytest.mark.parametrize("block", ["attn", "ffn"])
def test_fused_op_through_the_kernel_path(monkeypatch, block):
    """The op and its grad op as the Executor runs them (under no_grad),
    with the wrappers sent down their card path and the launches replaced
    by the plain versions: the forward op launches the primal kernel; the
    grad op recomputes the forward (attention_block: with P) and runs the
    backward once; outputs and grads equal the JAX package's op and grad
    op."""
    op_type, inputs, attrs, cot = _op_case(block)
    # built first: building infers shapes through the op's kernel
    pop = _build_op(pf, op_type, inputs, attrs)
    calls = _plain_launches(monkeypatch)
    monkeypatch.setattr(KAB, "attention_block", lambda *a: KAB.on_card(
        KAB.AttentionBlockFn, KAB._attention_block_launch, *a))
    monkeypatch.setattr(KFF, "ffn_block", KFF._on_card)

    def run(op, env):
        with torch.no_grad():
            p_registry.run_op(op, env, CPU)

    out, got = _grads(pf, p_registry, torch.from_numpy, pop, inputs, cot,
                      run)
    fwd = ("attn", "fwd", False) if block == "attn" else ("ffn", "fwd")
    rec = ("attn", "fwd", True) if block == "attn" else ("ffn", "fwd")
    assert calls == [fwd, rec, (block, "bwd")]
    want_out, want = _grads(jf, j_registry, jnp.asarray,
                            _build_op(jf, op_type, inputs, attrs), inputs,
                            cot, lambda op, env: j_registry.run_op(op, env))
    np.testing.assert_allclose(out, want_out, rtol=0, atol=2e-5)
    assert sorted(got) == sorted(want) and len(want) == len(inputs)
    for n in want:
        _close_to_scale(got[n], want[n], name=n)


# ---------------------------------------------------------------------------
# wrapper dispatch on the CPU and the meta device
# ---------------------------------------------------------------------------
def test_fused_wrappers_run_plain_on_cpu_and_answer_meta():
    x, wqkv, wo, g = _t(*_attn_inputs(b=2, t=8, seed=9))
    fx, w1, b1, w2, b2, fg = _t(*_ffn_inputs(b=2, t=8, seed=10))
    counters = (KAB.attention_block, KAB.attention_block_bwd, KFF.ffn_block,
                KFF.ffn_block_bwd)
    before = [k.launches for k in counters]
    out, p = KAB.attention_block_fwd_plain(x, wqkv, wo, HEADS, SCALE, True,
                                           save_p=True)
    torch.testing.assert_close(
        KAB.attention_block(x, wqkv, wo, HEADS, SCALE, True), out, rtol=0,
        atol=0)
    for a, b in zip(KAB.attention_block_bwd(x, wqkv, wo, p, g, HEADS,
                                            SCALE, True),
                    KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, HEADS,
                                                  SCALE, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(KFF.ffn_block(fx, w1, b1, w2, b2),
                               KFF.ffn_block_plain(fx, w1, b1, w2, b2),
                               rtol=0, atol=0)
    for a, b in zip(KFF.ffn_block_bwd(fx, w1, b1, w2, fg),
                    KFF.ffn_block_bwd_plain(fx, w1, b1, w2, fg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert [k.launches for k in counters] == before
    meta = torch.device("meta")
    x = torch.empty(7, 256, 512, device=meta)
    wqkv, wo = (torch.empty(512, n, device=meta) for n in (1536, 512))
    p = torch.empty(7, 8, 256, 256, device=meta)
    assert KAB.attention_block(x, wqkv, wo, 8, 0.125).shape == x.shape
    assert [t.shape for t in KAB.attention_block_bwd(
        x, wqkv, wo, p, x, 8, 0.125)] == [x.shape, wqkv.shape, wo.shape]
    w1, b1 = torch.empty(512, 2048, device=meta), torch.empty(2048,
                                                              device=meta)
    w2, b2 = torch.empty(2048, 512, device=meta), torch.empty(512,
                                                              device=meta)
    assert KFF.ffn_block(x, w1, b1, w2, b2).shape == x.shape
    assert [t.shape for t in KFF.ffn_block_bwd(x, w1, b1, w2, x)] == [
        x.shape, w1.shape, b1.shape, w2.shape, b2.shape]


# ---------------------------------------------------------------------------
# Transformer training with the knob, in both packages
# ---------------------------------------------------------------------------
def _build(pkg, T, monkeypatch, fused):
    if fused:
        monkeypatch.setenv(KNOB, "1")
    else:
        monkeypatch.delenv(KNOB, raising=False)
    with (j_unique_name if pkg is jf else p_unique_name).guard():
        prog = T.build_program(warmup_steps=WARMUP, **CFG)
    monkeypatch.delenv(KNOB, raising=False)
    return prog


def _op_list(prog):
    return [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()),
             {k: v for k, v in op.attrs.items() if not k.startswith("__")})
            for op in prog.global_block.ops
            if op.type in ("attention_block", "ffn_block")] + \
        [(op.type, sorted(op.inputs.items()), sorted(op.outputs.items()))
         for op in prog.global_block.ops]


def _persistables(startup):
    return [n for n, v in startup.global_block.vars.items() if v.persistable]


def test_both_packages_build_the_same_fused_program(monkeypatch):
    jmain, jstart, _ = _build(jf, JT, monkeypatch, fused=True)
    pmain, pstart, _ = _build(pf, PT, monkeypatch, fused=True)
    assert _op_list(pmain) == _op_list(jmain)
    assert _persistables(pstart) == _persistables(jstart)
    types = [op.type for op in pmain.global_block.ops]
    assert (types.count("attention_block"), types.count("ffn_block"),
            types.count("attention")) == (4, 4, 2)
    assert types.count("attention_block_grad") == 4
    assert "relu" not in types
    causal = [op.attrs["causal"] for op in pmain.global_block.ops
              if op.type == "attention_block"]
    assert causal == [False, False, True, True]


def _train(main, start, cost, state, feed, steps, fetch):
    exe = pf.Executor(pf.CPUPlace())
    scope = pf.Scope()
    pf.load_numpy_params(scope, state, pf.CPUPlace())
    out = []
    for step in range(steps):
        res = exe.run(main, feed=feed,
                      fetch_list=[cost] + (fetch if step == 0 else []),
                      scope=scope)
        out.append(res)
    return out


def _feed(seed=0):
    r = np.random.RandomState(seed)
    return {k: r.randint(1, CFG["vocab"], (8, CFG["seq_len"])).astype(
        "int64") for k in ("src_ids", "tgt_ids", "label")}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_fused_training_matches_reference(monkeypatch):
    """3 Adam steps of the fused program in both packages from the same
    weights: losses within 1e-5 relative, every step-1 grad within 1e-5
    norm-wise."""
    jmain, jstart, jcost = _build(jf, JT, monkeypatch, fused=True)
    pmain, pstart, pcost = _build(pf, PT, monkeypatch, fused=True)
    jexe, jscope = jf.Executor(jf.CPUPlace()), jf.Scope()
    jexe.run(jstart, scope=jscope)
    names = _persistables(jstart)
    state = {n: np.asarray(jscope.find_var(n).get_tensor()) for n in names}
    grads = [p.name + "@GRAD" for p in pmain.all_parameters()]
    feed = _feed()
    jl = []
    for step in range(STEPS):
        res = jexe.run(jmain, feed=feed,
                       fetch_list=[jcost] + (grads if step == 0 else []),
                       scope=jscope)
        jl.append(float(np.asarray(res[0]).reshape(())))
        if step == 0:
            jgrads = [np.asarray(a) for a in res[1:]]
    pres = _train(pmain, pstart, pcost, state, feed, STEPS, grads)
    pl = [float(np.asarray(r[0]).reshape(())) for r in pres]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert jl[-1] < jl[0], jl
    for name, a, b in zip(grads, pres[0][1:], jgrads):
        assert _rel(a, b) <= 1e-5, name


def test_fused_matches_unfused_in_the_port(monkeypatch):
    """The same weights through the port's fused and unfused programs:
    the same parameters, losses within 1e-5 relative over 3 Adam steps,
    step-1 grads within 1e-5 norm-wise."""
    fmain, fstart, fcost = _build(pf, PT, monkeypatch, fused=True)
    umain, ustart, ucost = _build(pf, PT, monkeypatch, fused=False)
    names = _persistables(ustart)
    assert sorted(_persistables(fstart)) == sorted(names)
    exe, scope = pf.Executor(pf.CPUPlace()), pf.Scope()
    exe.run(ustart, scope=scope)
    state = pf.scope_to_numpy(scope, names)
    grads = [p.name + "@GRAD" for p in umain.all_parameters()]
    feed = _feed(seed=1)
    fres = _train(fmain, fstart, fcost, state, feed, STEPS, grads)
    ures = _train(umain, ustart, ucost, state, feed, STEPS, grads)
    np.testing.assert_allclose([float(r[0][0]) for r in fres],
                               [float(r[0][0]) for r in ures], rtol=1e-5,
                               atol=0)
    for name, a, b in zip(grads, fres[0][1:], ures[0][1:]):
        assert _rel(a, b) <= 1e-5, name


def test_decode_and_is_test_builds_stay_unfused(monkeypatch):
    monkeypatch.setenv(KNOB, "1")
    with p_unique_name.guard():
        prog = PD.build_incremental_decode_program(
            seq_len=8, d_model=32, n_heads=2, n_layers=1, d_inner=64,
            vocab=64, max_out_len=4, start_id=0, end_id=1)[0]
        main, startup = pf.Program(), pf.Program()
        with pf.program_guard(main, startup):
            x = pf.layers.data("x", shape=[8, 32], dtype="float32")
            PT.multi_head_attention(x, x, 32, 2, 0.0, causal=True,
                                    is_test=True, name="t")
            PT._ffn(x, 32, 64, 0.0, True, name="t")
    for p in (prog, main):
        types = [op.type for b in p.blocks for op in b.ops]
        assert "attention_block" not in types and "ffn_block" not in types
    assert "attention" in [op.type for b in prog.blocks for op in b.ops]
