"""The bf16 contracts of the fused blocks #10-#13 (attention_block,
ffn_block): their plain versions in bf16 against the JAX package, the
fused Transformer under AMP against the JAX package's, and (marked
``gpu``) the bf16 kernels against their plain versions on the card.

The contract, the TPU kernels': x and the weights (and g) bf16 in memory,
all arithmetic fp32, the intermediates (qkv, ctx, P, h, dh, dqkv, dctx)
fp32, the output and every gradient rounded once to the input's dtype.
The port keeps P in fp32 where the Pallas kernel saves it in bf16: at
Transformer-base's width the JAX package's VMEM gate refuses its kernel
and it differentiates `attention_block_reference`, whose P is fp32.

Tolerances:
- plain versions against ``jax.vjp`` of `attention_block_reference` /
  `ffn_block_reference` on the same bf16 inputs: both compute in fp32
  and round once, so they differ by at most one bf16 rounding (one ulp
  at the largest |value|: `_ulps`), in the few elements whose fp32
  values straddle a rounding boundary: at most 0.1% of them.
- against the Pallas kernels in interpret mode: 2^-7 of the largest
  |grad|. The Pallas attention backward takes its gradient from a bf16
  P, which moves 39-43% of the gradients' elements by up to 0.45-0.54% of
  the largest |grad|; the FFN kernel has no such residual.
- the fused Transformer under AMP: ``torch_amp_setup.py``'s limits (3
  Adam steps' losses within 1e-4 relative of the JAX package's bf16 run,
  and closer than either package's bf16-to-fp32 gap).
- kernels against plain versions on the card: one bf16 rounding (one
  ulp at the largest |plain|) in at most 5% of the elements, the ReLU masks of
  the FFN backward pinned to the kernels' (the forward kernel's hidden,
  which the backward recomputes with one code path), and (FFN) no further
  from the float64 oracle than twice the plain version.
- the FFN kernels keep h and dh as two bf16 planes (hi + lo):
  `ffn_block_planes_plain` computes that on the CPU and must pass the
  card's gate against ``jax.vjp(ffn_block_reference)`` (one ulp at the
  largest |value| in at most 5% of the elements, at most twice the
  reference's distance to float64); with either intermediate as one bf16
  term it must fail it.
- one product of the FFN kernels' engine, each of its six operand
  layouts, against float64 on the planes' exact values: within
  `PRODUCT_REL` of the largest row-by-column sum of |products| at a
  depth of 40 (ragged), 2048 and 32768 (a weight gradient's at batch 128
  before its split). The kernels' groups of 256 terms, each added to the
  running sum in fp32, keep well inside it; one wgmma accumulator over
  32768 terms must miss it (a control). The planes-only epilogue (the
  attention block's qkv and dctx, `SPLIT_LAYOUT`) the same, beyond the
  planes' own rounding (2^-17 of each value).
- the attention block's bf16 kernels keep ctx (and in the backward qkv,
  dctx and dqkv) as two bf16 planes, the forward's scores on fp32 q and
  k: `attention_block_planes_plain` computes that on the CPU and must
  pass the card's gate against ``jax.vjp(attention_block_reference)``,
  its P within `P_TOL` of float64, and stay within 2^-7 of the largest
  |value| of the Pallas kernels in interpret mode; with q and k as planes
  its P must miss `P_TOL`, with dqkv as one bf16 term its gradients the
  gate. On the card the kernels hold to it and to the fp32 plain version
  at ragged shapes, bit for bit on a second launch.

The JAX package is imported inside the tests that compare with it, so
the ``gpu`` tests also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_bf16.py
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import attention_block as KAB
from paddle_tpu_torch.ops.kernels import bf16_planes as KBP
from paddle_tpu_torch.ops.kernels import ffn_block as KFF

BF = torch.bfloat16
REF_SHARE = 1e-3
KERNEL_REL = 2 ** -7
CARD_SHARE = 0.05
PRODUCT_REL = 2 ** -21
PLANES_REL = 2 ** -17  # hi + lo against the fp32 value they stand for
P_TOL = 1e-6  # a saved P against float64 (chip_smoke.py's)
KNOB = "PADDLE_TPU_FUSE_ATTN_BLOCK"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jref():
    """The JAX package's fused-block modules, on the CPU, Pallas kernels
    in interpret mode (as its own tests run them there)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu.ops.pallas import attention as j_attn
    from paddle_tpu.ops.pallas import attention_block as JAB
    from paddle_tpu.ops.pallas import ffn_block as JFB

    j_attn.force_interpret(True)
    yield jax, JAB, JFB
    j_attn.force_interpret(False)


def _bf16_arrays(seed, *shapes_scales):
    """numpy fp32 arrays rounded to bf16 values, one per (shape, scale)."""
    r = np.random.RandomState(seed)
    return [torch.from_numpy((r.randn(*s) * sc).astype(np.float32)).to(BF)
            for s, sc in shapes_scales]


def _attn_case(b=4, t=16, d=32, seed=0):
    return _bf16_arrays(seed, ((b, t, d), 1.0), ((d, 3 * d), d ** -0.5),
                        ((d, d), d ** -0.5), ((b, t, d), 1.0))


def _ffn_case(b=4, t=16, d=32, f=64, seed=0):
    return _bf16_arrays(seed, ((b, t, d), 1.0), ((d, f), d ** -0.5),
                        ((f,), 0.1), ((f, d), f ** -0.5), ((d,), 0.1),
                        ((b, t, d), 1.0))


def _gate(got, want):
    """(max |got - want| over the largest |want|, share of elements that
    differ)."""
    g, w = got.float(), want.float()
    return (float((g - w).abs().max()) / float(w.abs().max()),
            float((g != w).float().mean()))


def _ulps(got, want):
    """(max |got - want| in bf16 ulps of the largest |want|, share of
    elements that differ). Both sides round fp32 values once, so an
    element whose two fp32 values straddle a rounding boundary moves by
    one ulp of itself, at most one ulp of the largest |want|: 2^-8 to
    2^-7 of it, by where it lies in its binade."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    ulp = 2.0 ** (math.frexp(top)[1] - 8) if top > 0 else 2.0 ** -133
    return (float((g - w).abs().max()) / ulp,
            float((g != w).float().mean()))


def _from_jax(x):
    return torch.from_numpy(np.array(np.asarray(x).astype(np.float32)))


def _to_jax(jnp, t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


HEADS, SCALE = 4, (32 // 4) ** -0.5


def _plain_attn_vjp(x, wqkv, wo, g, causal):
    out, vjp = torch.func.vjp(
        lambda *a: KAB.attention_block_plain(*a, HEADS, SCALE, causal),
        x, wqkv, wo)
    return (out, *vjp(g))


def _plain_ffn_vjp(x, w1, b1, w2, b2, g):
    out, vjp = torch.func.vjp(KFF.ffn_block_plain, x, w1, b1, w2, b2)
    return (out, *vjp(g))


# ---------------------------------------------------------------------------
# plain versions in bf16 against the JAX package (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_bf16_plain_matches_reference_vjp(jref, causal):
    jax, JAB, _ = jref
    import jax.numpy as jnp

    x, wqkv, wo, g = _attn_case(seed=1)
    got = _plain_attn_vjp(x, wqkv, wo, g, causal)
    out, vjp = jax.vjp(
        lambda *a: JAB.attention_block_reference(*a, HEADS, SCALE, causal),
        *(_to_jax(jnp, t) for t in (x, wqkv, wo)))
    want = (out, *vjp(_to_jax(jnp, g)))
    for name, a, w in zip(("out", "dx", "dwqkv", "dwo"), got, want):
        assert a.dtype == BF and w.dtype == jnp.bfloat16, name
        ulps, share = _ulps(a, _from_jax(w))
        assert ulps <= 1 and share <= REF_SHARE, (name, ulps, share)


def test_ffn_block_bf16_plain_matches_reference_vjp(jref):
    jax, _, JFB = jref
    import jax.numpy as jnp

    x, w1, b1, w2, b2, g = _ffn_case(seed=2)
    got = _plain_ffn_vjp(x, w1, b1, w2, b2, g)
    # the kernel's backward computes the same five grads
    bwd = KFF.ffn_block_bwd_plain(x, w1, b1, w2, g)
    out, vjp = jax.vjp(JFB.ffn_block_reference,
                       *(_to_jax(jnp, t) for t in (x, w1, b1, w2, b2)))
    want = (out, *vjp(_to_jax(jnp, g)))
    for name, a, w in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got,
                          want):
        assert a.dtype == BF, name
        ulps, share = _ulps(a, _from_jax(w))
        assert ulps <= 1 and share <= REF_SHARE, (name, ulps, share)
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2"), bwd, got[1:]):
        assert a.dtype == BF, name
        ulps, share = _ulps(a, w)
        assert ulps <= 1 and share <= REF_SHARE, (name, ulps, share)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_bf16_plain_matches_pallas_interpret(jref, causal):
    """Forward and backward against `_fwd_impl` / `_bwd_impl` in
    interpret mode on the same bf16 inputs; the Pallas backward reads its
    own bf16 P, the port's backward the fp32 P of its plain forward."""
    _, JAB, _ = jref
    import jax.numpy as jnp

    x, wqkv, wo, g = _attn_case(seed=3)
    jx = [_to_jax(jnp, t) for t in (x, wqkv, wo)]
    want, want_p = JAB._fwd_impl(*jx, HEADS, SCALE, causal, save_p=True)
    assert want_p.dtype == jnp.bfloat16
    want_g = JAB._bwd_impl(*jx, want_p, _to_jax(jnp, g), HEADS, SCALE,
                           causal)
    out, p = KAB.attention_block_fwd_plain(x, wqkv, wo, HEADS, SCALE, causal,
                                           save_p=True)
    assert out.dtype == BF and p.dtype == torch.float32
    ulps, share = _ulps(out, _from_jax(want))
    assert ulps <= 1, (ulps, share)
    got = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, HEADS, SCALE,
                                        causal)
    for name, a, w in zip(("dx", "dwqkv", "dwo"), got, want_g):
        assert a.dtype == BF, name
        rel, _ = _gate(a, _from_jax(w))
        assert rel <= KERNEL_REL, (name, rel)


def test_ffn_block_bf16_plain_matches_pallas_interpret(jref):
    _, _, JFB = jref
    import jax.numpy as jnp

    x, w1, b1, w2, b2, g = _ffn_case(seed=4)
    jx = [_to_jax(jnp, t) for t in (x, w1, b1, w2, b2)]
    rel, _ = _gate(KFF.ffn_block_plain(x, w1, b1, w2, b2),
                   _from_jax(JFB._fwd_impl(*jx)))
    assert rel <= KERNEL_REL, rel
    want = JFB._bwd_impl(*jx, _to_jax(jnp, g))
    got = KFF.ffn_block_bwd_plain(x, w1, b1, w2, g)
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.dtype == BF, name
        rel, _ = _gate(a, _from_jax(w))
        assert rel <= KERNEL_REL, (name, rel)


def _f64_ffn(x, w1, b1, w2, b2, g, mask=None):
    """out and the five grads in float64; the ReLU mask (pre > 0 unless
    given) pinned for the backward."""
    d = w1.shape[0]
    x2, g2 = x.reshape(-1, d).double(), g.reshape(-1, d).double()
    pre = x2 @ w1.double() + b1.double()
    mask = pre > 0 if mask is None else mask
    h = torch.relu(pre)
    dh = torch.where(mask, g2 @ w2.double().T, 0.0)
    return ((h @ w2.double() + b2.double()).reshape(x.shape),
            (dh @ w1.double().T).reshape(x.shape), x2.T @ dh, dh.sum(0),
            (h * mask).T @ g2, g2.sum(0))


def _card_ok(got, want, oracle):
    """The card's bf16 gate: one ulp at the largest |want| in at most
    CARD_SHARE of the elements, and no further from the float64 oracle
    than twice `want`."""
    ulps, share = _ulps(got, want)
    far = float((got.double() - oracle).abs().max())
    near = float((want.double() - oracle).abs().max())
    return ulps <= 1 and share <= CARD_SHARE and far <= 2 * max(near, 1e-30)


@pytest.mark.parametrize("h_terms,dh_terms,ok", [(2, 2, True),
                                                 (1, 2, False),
                                                 (2, 1, False),
                                                 (1, 1, False)])
def test_ffn_block_planes_plain_against_reference_vjp(jref, h_terms,
                                                       dh_terms, ok):
    """h and dh as two bf16 planes (the bf16 kernels' design) pass the
    card's gate against ``jax.vjp(ffn_block_reference)``; with either as
    one bf16 term the gate sees it."""
    jax, _, JFB = jref
    import jax.numpy as jnp

    x, w1, b1, w2, b2, g = _ffn_case(2, 64, 64, 128, seed=7)
    out, grads = KFF.ffn_block_planes_plain(x, w1, b1, w2, b2, g, h_terms,
                                            dh_terms)
    ref, vjp = jax.vjp(JFB.ffn_block_reference,
                       *(_to_jax(jnp, t) for t in (x, w1, b1, w2, b2)))
    want = (ref, *vjp(_to_jax(jnp, g)))
    oracle = _f64_ffn(x, w1, b1, w2, b2, g)
    passed = [_card_ok(a, _from_jax(w).to(BF), o)
              for a, w, o in zip((out, *grads), want, oracle)]
    assert all(a.dtype == BF for a in (out, *grads))
    assert all(passed) == ok, passed


def _f64_attn(x, wqkv, wo, g, h, scale, causal):
    """The attention block's output, P and grads in float64 (autograd of
    `attention_block_reference`'s composition)."""
    b, t, d = x.shape
    xs = [z.double().requires_grad_() for z in (x, wqkv, wo)]
    q, k, v = (z.reshape(b, t, h, -1).transpose(1, 2)
               for z in (xs[0] @ xs[1]).split(d, dim=2))
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    p = torch.softmax(s, -1)
    out = (p @ v).transpose(1, 2).reshape(b, t, d) @ xs[2]
    grads = torch.autograd.grad(out, xs, g.double())
    return out.detach(), p.detach(), grads


PLANES_CASE = dict(b=2, t=64, d=64, h=2)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_planes_plain_against_reference_vjp(jref, causal):
    """ctx (and in the backward qkv, dctx, dqkv) as two bf16 planes, the
    scores on fp32 q and k (the bf16 kernels' design), pass the card's
    gate against ``jax.vjp(attention_block_reference)``, P within P_TOL
    of float64."""
    jax, JAB, _ = jref
    import jax.numpy as jnp

    b, t, d, h = PLANES_CASE.values()
    x, wqkv, wo, g = _attn_case(b, t, d, seed=12)
    scale = (d // h) ** -0.5
    out, p, grads = KAB.attention_block_planes_plain(x, wqkv, wo, g, h,
                                                     scale, causal)
    ref, vjp = jax.vjp(
        lambda *a: JAB.attention_block_reference(*a, h, scale, causal),
        *(_to_jax(jnp, z) for z in (x, wqkv, wo)))
    want = (ref, *vjp(_to_jax(jnp, g)))
    o64, p64, g64 = _f64_attn(x, wqkv, wo, g, h, scale, causal)
    passed = [_card_ok(a, _from_jax(w).to(BF), o)
              for a, w, o in zip((out, *grads), want, (o64, *g64))]
    assert all(a.dtype == BF for a in (out, *grads))
    assert all(passed), passed
    assert p.dtype == torch.float32
    assert float((p.double() - p64).abs().max()) <= P_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_planes_plain_matches_pallas_interpret(jref, causal):
    """The planes design against `_fwd_impl` / `_bwd_impl` in interpret
    mode, each backward from its own forward's P (the Pallas one bf16)."""
    _, JAB, _ = jref
    import jax.numpy as jnp

    x, wqkv, wo, g = _attn_case(seed=13)
    jx = [_to_jax(jnp, t) for t in (x, wqkv, wo)]
    want, want_p = JAB._fwd_impl(*jx, HEADS, SCALE, causal, save_p=True)
    want_g = JAB._bwd_impl(*jx, want_p, _to_jax(jnp, g), HEADS, SCALE,
                           causal)
    out, _, grads = KAB.attention_block_planes_plain(x, wqkv, wo, g, HEADS,
                                                     SCALE, causal)
    for name, a, w in zip(("out", "dx", "dwqkv", "dwo"), (out, *grads),
                          (want, *want_g)):
        assert a.dtype == BF, name
        rel, _ = _gate(a, _from_jax(w))
        assert rel <= KERNEL_REL, (name, rel)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("control", ["q and k as planes",
                                     "dqkv as one bf16 term"])
def test_attention_block_planes_controls_fail(causal, control):
    """Two designs the bf16 kernels must not take, planted in the plain
    version: q and k as two planes in the scores put P over P_TOL from
    float64; dqkv as one bf16 term moves the gradients past the card's
    gate (against the fp32 plain version, which passes it)."""
    b, t, d, h = PLANES_CASE.values()
    x, wqkv, wo, g = _attn_case(b, t, d, seed=14)
    scale = (d // h) ** -0.5
    o64, p64, g64 = _f64_attn(x, wqkv, wo, g, h, scale, causal)
    if control == "q and k as planes":
        _, p, _ = KAB.attention_block_planes_plain(x, wqkv, wo, g, h, scale,
                                                   causal, qk_planes=True)
        assert float((p.double() - p64).abs().max()) > P_TOL
        return
    _, p, grads = KAB.attention_block_planes_plain(x, wqkv, wo, g, h, scale,
                                                   causal, dqkv_terms=1)
    want = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h, scale)
    assert all(_card_ok(w, w, o) for w, o in zip(want, g64))
    assert not all(_card_ok(a, w, o) for a, w, o in zip(grads, want, g64))


def test_ffn_layout_products_plain():
    """The six operand layouts' plain products (the CPU path of
    `product_bf16`) equal A B on the planes' values."""
    r = np.random.RandomState(8)
    m, n, k = 24, 16, 40
    a = torch.from_numpy(r.randn(m, k).astype(np.float32))
    b = torch.from_numpy(r.randn(k, n).astype(np.float32))
    for layout, (_, _, _, pa, pb) in enumerate(KBP.PRODUCT_LAYOUTS):
        am, bm = KBP.layout_operands(layout, a, b)
        assert am.dtype == BF and am.shape[0] == pa and bm.shape[0] == pb
        want = KBP.planes_sum(a, pa) @ KBP.planes_sum(b, pb)
        got = KBP.product_bf16(layout, am, bm, m, n, k)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), layout


def test_fused_transformer_under_amp_matches_reference(tmp_path,
                                                       monkeypatch):
    """The Transformer of ``torch_amp_setup.py`` built with the fused
    blocks (4 attention_block ops, one in each of its 2+2 layers' self
    attention, and 4 ffn_block ops) at seq 64, under AMP in both
    packages."""
    import paddle_tpu_torch as pf
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.models import transformer as PT
    from torch_amp_setup import AMP_CFG, check_amp_training

    monkeypatch.setenv(KNOB, "1")
    with unique_name.guard():
        main, _, _ = PT.build_program(warmup_steps=100, seq_len=64,
                                      **AMP_CFG)
    types = [op.type for op in main.global_block.ops]
    assert types.count("attention_block") == 4
    assert types.count("ffn_block") == 4
    assert isinstance(main, pf.Program)
    check_amp_training(64, tmp_path)


def test_block_wrappers_take_bf16_and_refuse_mixed_dtypes():
    """The wrappers' card-path checks (reached on the CPU through the
    check itself): bf16 inputs pass, mixed fp32/bf16 inputs, a bf16 P,
    dtypes the kernels have no instance of and bf16 inputs off a 16-byte
    boundary are refused."""
    x, wqkv, wo, g = _attn_case()
    KAB._check("attention_block", x, wqkv, wo, HEADS)
    p = torch.zeros(4, HEADS, 16, 16)
    KAB._check("attention_block_bwd", x, wqkv, wo, HEADS, p, g)
    with pytest.raises(TypeError):
        KAB._check("attention_block", x, wqkv.float(), wo, HEADS)
    with pytest.raises(TypeError, match="saved P"):
        KAB._check("attention_block_bwd", x, wqkv, wo, HEADS, p.to(BF), g)
    with pytest.raises(TypeError):
        KAB._check("attention_block", x.half(), wqkv.half(), wo.half(),
                   HEADS)
    fx, w1, b1, w2, b2, fg = _ffn_case()
    assert KFF._check("ffn_block", fx, w1, b1, w2, b2, True) == (64, 32, 64)
    with pytest.raises(TypeError):
        KFF._check("ffn_block_bwd", fx, w1, b1.float(), w2, fg, False)
    # a bf16 view whose rows start 2 bytes past a 16-byte boundary
    off = torch.zeros(fx.numel() + 8, dtype=BF)[1:1 + fx.numel()]
    with pytest.raises(ValueError, match="16-byte"):
        KFF._check("ffn_block", off.view(fx.shape), w1, b1, w2, b2, True)
    # a bias off the boundary is read element by element: taken
    b1_off = torch.zeros(b1.numel() + 8, dtype=BF)[1:1 + b1.numel()]
    KFF._check("ffn_block", fx, w1, b1_off, w2, b2, True)
    with pytest.raises(TypeError):
        KFF._check("ffn_block", fx, w1, b1, w2, b2.float(), True)


# ---------------------------------------------------------------------------
# on the card: the bf16 kernels against their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_fused_bf16.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_gate(name, got, want):
    ulps, share = _ulps(got, want)
    assert got.dtype == want.dtype, name
    assert bool(torch.isfinite(got.float()).all()), name
    assert ulps <= 1 and share <= CARD_SHARE, (name, ulps, share)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,h,causal", [(4, 16, 32, 4, True),
                                            (2, 200, 256, 2, False),
                                            (8, 256, 512, 8, True)])
def test_attention_block_bf16_kernel_matches_plain(cuda, b, t, d, h,
                                                   causal):
    x, wqkv, wo, g = (z.to(cuda) for z in _attn_case(b, t, d, seed=5))
    scale = (d // h) ** -0.5
    fwd0, bwd0 = KAB.attention_block.launches, \
        KAB.attention_block_bwd.launches
    out, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                         True)
    wout, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale, causal,
                                             save_p=True)
    got = KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
    want = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h, scale)
    torch.cuda.synchronize()
    assert KAB.attention_block.launches == fwd0 + 1
    assert KAB.attention_block_bwd.launches == bwd0 + 1
    _card_gate("out", out, wout)
    assert p.dtype == torch.float32
    assert float((p - wp).abs().max()) <= 1e-5
    for name, a, w in zip(("dx", "dwqkv", "dwo"), got, want):
        _card_gate(name, a, w)


def _ffn_kernel_planes(x, w1, b1, w2, g=None):
    """The forward kernel's hidden planes summed in fp32, or (g given) the
    backward kernel's dh planes, through the C entries, whose scratch is
    the caller's."""
    d, f = w1.shape
    n = x.numel() // d
    h = torch.empty(n, f, device=x.device)
    st = torch.cuda.current_stream().cuda_stream
    if g is None:
        assert KFF._kernel("ffn_block_fwd", 7, False, BF)(
            *(z.data_ptr() for z in (x, w1, b1, w2, x.new_zeros(d),
                                     torch.empty_like(x), h)),
            n, d, f, st) == 0
    else:
        grads = (torch.empty_like(x), torch.empty_like(w1),
                 torch.empty_like(b1), torch.empty_like(w2), x.new_empty(d))
        ws = torch.empty(max(KFF.WORKSPACE_FLOATS, f), device=x.device)
        assert KFF._kernel("ffn_block_bwd", 12, True, BF)(
            *(z.data_ptr() for z in (x, w1, b1, w2, g, *grads, h, ws)),
            ws.numel(), n, d, f, st) == 0
    hi, lo = KBP.scratch_planes(h, n, f)
    return hi.float() + lo.float()


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,f", [(4, 16, 32, 64), (2, 200, 256, 1024),
                                     (1, 200, 40, 72), (8, 256, 512, 2048)])
def test_ffn_block_bf16_kernel_matches_plain(cuda, b, t, d, f):
    x, w1, b1, w2, b2, g = (z.to(cuda) for z in _ffn_case(b, t, d, f,
                                                          seed=6))
    fwd0, bwd0 = KFF.ffn_block.launches, KFF.ffn_block_bwd.launches
    out = KFF._ffn_block_launch(x, w1, b1, w2, b2)
    got = KFF.ffn_block_bwd(x, w1, b1, w2, g)
    again = (KFF._ffn_block_launch(x, w1, b1, w2, b2),
             *KFF.ffn_block_bwd(x, w1, b1, w2, g))
    torch.cuda.synchronize()
    assert KFF.ffn_block.launches == fwd0 + 2
    assert KFF.ffn_block_bwd.launches == bwd0 + 2
    assert all(torch.equal(u, v) for u, v in zip((out, *got), again))
    # the plain backward with its ReLU masks pinned to the kernels' (the
    # forward's hidden planes, hi + lo > 0, which the backward recomputes
    # with one code path)
    x2, g2 = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    mask = _ffn_kernel_planes(x, w1, b1, w2) > 0
    # the backward's recompute: under a cotangent of ones dh is W2's row
    # sum wherever its mask is on
    assert float(w2.double().sum(1).abs().min()) > 0
    kmask = _ffn_kernel_planes(x, w1, b1, w2, torch.ones_like(x)) != 0
    assert int((mask != kmask).sum()) == 0
    dh = torch.where(mask, g2 @ w2.float().T, 0.0)
    want = (KFF.ffn_block_plain(x, w1, b1, w2, b2),
            (dh @ w1.float().T).reshape(x.shape).to(BF),
            (x2.T @ dh).to(BF), dh.sum(0).to(BF),
            (torch.relu(x2 @ w1.float() + b1.float()).T @ g2).to(BF),
            g2.sum(0).to(BF))
    oracle = _f64_ffn(x, w1, b1, w2, b2, g, mask)
    for name, a, w, o in zip(("out", "dx", "dw1", "db1", "dw2", "db2"),
                             (out, *got), want, oracle):
        _card_gate(name, a, w)
        assert _card_ok(a, w, o), name


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(200, 72, 40), (256, 384, 2048),
                                   (128, 256, 32768)])
@pytest.mark.parametrize("layout", range(6))
def test_ffn_layout_product_against_float64(cuda, layout, m, n, k):
    """One product of the bf16 FFN kernels' engine in each operand layout
    (`KBP.PRODUCT_LAYOUTS`), unsplit, against float64 on the planes'
    exact values."""
    r = np.random.RandomState(9 + layout)
    a = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(cuda)
    b = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(cuda)
    am, bm = KBP.layout_operands(layout, a, b)
    got = KBP.product_bf16(layout, am, bm, m, n, k)
    torch.cuda.synchronize()
    _, ta, tb, _, _ = KBP.PRODUCT_LAYOUTS[layout]
    a64, b64 = am.double().sum(0), bm.double().sum(0)
    a64, b64 = a64.T if ta else a64, b64 if tb else b64.T
    want = a64 @ b64
    scale = float((a64.abs() @ b64.abs()).max())
    err = float((got.double() - want).abs().max()) / scale
    assert err <= PRODUCT_REL, (KBP.PRODUCT_LAYOUTS[layout][0], err)
    if k > 4096:
        # one accumulator over all of k loses bits: the check sees it
        one = KBP.product_bf16(layout, am, bm, m, n, k, group=0)
        assert float((one.double() - want).abs().max()) / scale > \
            PRODUCT_REL, KBP.PRODUCT_LAYOUTS[layout][0]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,h,causal", [(3, 8, 64, 2, True),
                                            (1, 264, 96, 3, True),
                                            (2, 264, 256, 4, True),
                                            (2, 264, 256, 2, True),
                                            (4, 8, 512, 4, True),
                                            (2, 264, 256, 4, False)])
def test_attention_block_bf16_planes_kernel_matches_plain(cuda, b, t, d, h,
                                                          causal):
    """The bf16 kernels (products on wgmma, ctx, qkv, dctx and dqkv as
    planes) at ragged shapes: T 8 and 264, Dh 32, 64 and 128. Within one
    bf16 rounding of `attention_block_planes_plain` and of the fp32 plain
    version, P within P_TOL of float64, the same bits on a second launch
    and the output the same with P and without."""
    x, wqkv, wo, g = (z.to(cuda) for z in _attn_case(b, t, d, seed=15))
    scale = (d // h) ** -0.5
    runs = [KAB._attention_block_launch(x, wqkv, wo, h, scale, causal, True)
            for _ in range(2)]
    primal = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                         False)
    out, p = runs[0]
    grads = [KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
             for _ in range(2)]
    pout, _, pgrads = KAB.attention_block_planes_plain(x, wqkv, wo, g, h,
                                                       scale, causal, p=p)
    wout = KAB.attention_block_plain(x, wqkv, wo, h, scale, causal)
    wgrads = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h, scale)
    _, p64, _ = _f64_attn(x, wqkv, wo, g, h, scale, causal)
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1]) and torch.equal(primal, out)
    assert all(torch.equal(u, v) for u, v in zip(*grads))
    assert float((p.double() - p64).abs().max()) <= P_TOL
    for name, a, w, pw in zip(("out", "dx", "dwqkv", "dwo"),
                              (out, *grads[0]), (wout, *wgrads),
                              (pout, *pgrads)):
        _card_gate(name, a, pw)
        _card_gate(name, a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(200, 72, 40), (256, 1536, 512),
                                   (128, 256, 32768)])
def test_split_layout_product_against_float64(cuda, m, n, k):
    """The engine's planes-only epilogue (`SPLIT_LAYOUT`: x W1's layout,
    C as hi + lo bf16 planes, as the attention block writes qkv and dctx)
    against float64: within PRODUCT_REL of the largest row-by-column sum
    of |products| beyond the planes' own rounding."""
    r = np.random.RandomState(30)
    a = torch.from_numpy(r.randn(m, k).astype(np.float32)).to(cuda)
    b = torch.from_numpy(r.randn(k, n).astype(np.float32)).to(cuda)
    am, bm = KBP.layout_operands(KBP.SPLIT_LAYOUT, a, b)
    got = KBP.product_bf16(KBP.SPLIT_LAYOUT, am, bm, m, n, k)
    torch.cuda.synchronize()
    # A K-major [m][k], B MN-major [k][n]
    a64, b64 = am.double().sum(0), bm.double().sum(0)
    want = a64 @ b64
    scale = float((a64.abs() @ b64.abs()).max())
    over = ((got.double() - want).abs() - PLANES_REL * want.abs()).clamp(0)
    assert float(over.max()) / scale <= PRODUCT_REL
