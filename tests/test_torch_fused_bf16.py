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
  which the backward recomputes with one code path).

The JAX package is imported inside the tests that compare with it, so
the ``gpu`` tests also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_fused_bf16.py
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import attention_block as KAB
from paddle_tpu_torch.ops.kernels import ffn_block as KFF

BF = torch.bfloat16
REF_SHARE = 1e-3
KERNEL_REL = 2 ** -7
CARD_SHARE = 0.05
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


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,f", [(4, 16, 32, 64), (2, 200, 256, 1024),
                                     (8, 256, 512, 2048)])
def test_ffn_block_bf16_kernel_matches_plain(cuda, b, t, d, f):
    x, w1, b1, w2, b2, g = (z.to(cuda) for z in _ffn_case(b, t, d, f,
                                                          seed=6))
    fwd0, bwd0 = KFF.ffn_block.launches, KFF.ffn_block_bwd.launches
    out = KFF._ffn_block_launch(x, w1, b1, w2, b2)
    got = KFF.ffn_block_bwd(x, w1, b1, w2, g)
    torch.cuda.synchronize()
    assert KFF.ffn_block.launches == fwd0 + 1
    assert KFF.ffn_block_bwd.launches == bwd0 + 1
    _card_gate("out", out, KFF.ffn_block_plain(x, w1, b1, w2, b2))
    # the plain backward with its ReLU masks pinned to the kernels' (the
    # forward's hidden, which the backward recomputes with one code path)
    x2, g2 = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    n = x2.shape[0]
    h = torch.empty(n, f, device=cuda)
    assert KFF._kernel("ffn_block_fwd", 7, False, BF)(
        *(z.data_ptr() for z in (x, w1, b1, w2, b2, torch.empty_like(x),
                                 h)),
        n, d, f, torch.cuda.current_stream().cuda_stream) == 0
    mask = h > 0
    dh = torch.where(mask, g2 @ w2.float().T, 0.0)
    want = ((dh @ w1.float().T).reshape(x.shape).to(BF),
            (x2.T @ dh).to(BF), dh.sum(0).to(BF),
            (torch.relu(x2 @ w1.float() + b1.float()).T @ g2).to(BF),
            g2.sum(0).to(BF))
    for name, a, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        _card_gate(name, a, w)
