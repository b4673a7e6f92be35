"""The bf16 attention kernels #2 (flash forward) and #6 (sdpa_short
backward) on wgmma (``csrc/attn_wgmma.cuh``): the arithmetic of their
design in PyTorch (`flash_attention_tiles_plain`,
`sdpa_short_bwd_tiles_plain`) against the JAX package's Pallas kernels in
interpret mode on bf16 inputs, with the card's gates; the designs that
must fail them; and (marked ``gpu``) the kernels' operand forms against
float64 on the card.

The gates are the card's (chip_smoke.py `_bf16_ok`): within 2^-8 of the
largest |reference| in at most 5% of the elements (both sides compute in
fp32 from the same bf16 values and round once), lse within 1e-5. The JAX
package is imported inside the tests that compare with it, so the ``gpu``
tests also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_attn_wgmma.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import attention as KA

BF16_REL = 2 ** -8
BF16_SHARE = 0.05
LSE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randn(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _bf16(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(
        torch.bfloat16)


def _gate(got, want):
    """(max |got - want| over the largest |want|, the share of elements
    that differ)."""
    g, w = got.float(), want.float()
    return (float((g - w).abs().max()) / float(w.abs().max()),
            float((g != w).float().mean()))


def _passes(got, want):
    rel, share = _gate(got, want)
    return bool(torch.isfinite(got.float()).all()) and rel <= BF16_REL \
        and share <= BF16_SHARE


def _pallas():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu.ops.pallas import attention as jattn

    return jattn


def _jnp_bf16(*xs):
    import jax.numpy as jnp

    return [jnp.asarray(x, dtype=jnp.bfloat16) for x in xs]


def _torch(x):
    import jax.numpy as jnp

    return torch.from_numpy(np.array(x.astype(jnp.float32)))


def _key_tile(d):
    return 128 if d == 64 else 64


# ---------------------------------------------------------------------------
# #2: the flash forward's design against `_flash_fwd_impl`
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tq,tk,d,causal", [
    (264, 264, 64, False),   # T not a multiple of the key tile
    (264, 264, 64, True),
    (136, 264, 64, True),    # causal with tq < tk, bottom-right aligned
    (200, 136, 128, False),  # d 128 (64-key tiles), tq > tk
    (136, 264, 128, True),
])
def test_flash_tiles_plain_matches_pallas_interpret(tq, tk, d, causal):
    """128-key tiles (64 at d 128), P as hi/lo planes and the lse, on bf16
    inputs, against the Pallas kernel in interpret mode."""
    jattn = _pallas()
    q, k, v = (_randn(1, 2, t, d, seed=60 + i)
               for i, t in enumerate((tq, tk, tk)))
    jattn.force_interpret(True)
    try:
        out, lse = jattn._flash_fwd_impl(*_jnp_bf16(q, k, v), d ** -0.5,
                                         causal)
    finally:
        jattn.force_interpret(False)
    got, glse = KA.flash_attention_tiles_plain(
        _bf16(q), _bf16(k), _bf16(v), d ** -0.5, causal, _key_tile(d))
    assert got.dtype == torch.bfloat16 and glse.dtype == torch.float32
    assert _passes(got, _torch(out)), _gate(got, _torch(out))
    np.testing.assert_allclose(glse.numpy(), np.asarray(lse), rtol=0,
                               atol=LSE_TOL)


def test_flash_tiles_plain_fully_masked_rows():
    """Causal with tq > tk: the rows that see no key give the mean of v
    and an lse of -FLT_MAX (the port's C5 rule, `flash_attention_plain`;
    the Pallas kernel writes zeros there), the others agree with the
    Pallas kernel."""
    jattn = _pallas()
    tq, tk, d = 200, 64, 64
    q, k, v = (_randn(1, 2, t, d, seed=70 + i)
               for i, t in enumerate((tq, tk, tk)))
    tq_, tk_, tv_ = _bf16(q), _bf16(k), _bf16(v)
    got, glse = KA.flash_attention_tiles_plain(tq_, tk_, tv_, 0.125, True)
    want, wlse = KA.flash_attention_plain(tq_, tk_, tv_, 0.125, True,
                                          with_lse=True)
    blind = tq - tk
    assert _passes(got, want), _gate(got, want)
    torch.testing.assert_close(got[:, :, :blind].float(), tv_.float().mean(
        2, keepdim=True).expand(-1, -1, blind, -1), rtol=0, atol=2 ** -8)
    assert bool((glse[:, :, :blind] == -KA.FLT_MAX).all())
    torch.testing.assert_close(glse, wlse, rtol=0, atol=LSE_TOL)
    jattn.force_interpret(True)
    try:
        out, lse = jattn._flash_fwd_impl(*_jnp_bf16(q, k, v), 0.125, True)
    finally:
        jattn.force_interpret(False)
    seen = got[:, :, blind:]
    assert _passes(seen, _torch(out)[:, :, blind:])
    np.testing.assert_allclose(glse[:, :, blind:].numpy(),
                               np.asarray(lse)[:, :, blind:], rtol=0,
                               atol=LSE_TOL)


@pytest.mark.parametrize("d,causal", [(64, True), (128, False)])
def test_flash_tiles_plain_ragged_t(d, causal):
    """T 300, which the Pallas kernel does not take (no block divides it):
    against the port's plain version, the TPU kernel's function."""
    q, k, v = (_bf16(_randn(1, 2, 300, d, seed=80 + i)) for i in range(3))
    got, glse = KA.flash_attention_tiles_plain(q, k, v, d ** -0.5, causal,
                                               _key_tile(d))
    want, wlse = KA.flash_attention_plain(q, k, v, d ** -0.5, causal,
                                          with_lse=True)
    assert _passes(got, want), _gate(got, want)
    torch.testing.assert_close(glse, wlse, rtol=0, atol=LSE_TOL)


def test_flash_tiles_plain_fails_with_p_as_one_bf16_term():
    """The planted design: P rounded to one bf16 term before P v moves
    the output by ~2^-9 of itself before its rounding, so a share of the
    elements far above the gate's differs."""
    jattn = _pallas()
    q, k, v = (_randn(1, 2, 512, 64, seed=90 + i) for i in range(3))
    jattn.force_interpret(True)
    try:
        out, _ = jattn._flash_fwd_impl(*_jnp_bf16(q, k, v), 0.125, False)
    finally:
        jattn.force_interpret(False)
    good, _ = KA.flash_attention_tiles_plain(_bf16(q), _bf16(k), _bf16(v),
                                             0.125, False)
    bad, _ = KA.flash_attention_tiles_plain(_bf16(q), _bf16(k), _bf16(v),
                                            0.125, False, p_terms=1)
    assert _passes(good, _torch(out))
    assert not _passes(bad, _torch(out)), _gate(bad, _torch(out))


# ---------------------------------------------------------------------------
# #6: the sdpa_short backward's design against `_sdpa_short_bwd_impl`
# ---------------------------------------------------------------------------
def _sdpa_case(t, d, causal, seed):
    q, k, v, g = (_randn(1, 4, t, d, seed=seed + i) for i in range(4))
    _, p = KA.sdpa_short_plain(_bf16(q), _bf16(k), _bf16(v), d ** -0.5,
                               causal, save_p=True)
    return q, k, v, g, p


def _pallas_sdpa_bwd(q, k, v, p, g, scale, causal):
    import jax.numpy as jnp

    jattn = _pallas()
    jattn.force_interpret(True)
    try:
        grads = jattn._sdpa_short_bwd_impl(
            *_jnp_bf16(q, k, v), jnp.asarray(p.float().numpy(),
                                             dtype=jnp.bfloat16),
            *_jnp_bf16(g), scale, causal)
    finally:
        jattn.force_interpret(False)
    return [_torch(x) for x in grads]


@pytest.mark.parametrize("t,d,causal", [(264, 64, False), (264, 64, True),
                                        (300, 64, True), (300, 128, False),
                                        (512, 128, True)])
def test_sdpa_bwd_tiles_plain_matches_pallas_interpret(t, d, causal):
    """Delta's sweep over 128-key tiles, dS as planes in dq and dk, dv over
    64-row query tiles, from the saved bf16 P, against the Pallas kernel
    in interpret mode; ragged T (264, 300) and d 128 included."""
    q, k, v, g, p = _sdpa_case(t, d, causal, seed=100 + t + d)
    want = _pallas_sdpa_bwd(q, k, v, p, g, d ** -0.5, causal)
    got = KA.sdpa_short_bwd_tiles_plain(_bf16(q), _bf16(k), _bf16(v), p,
                                        _bf16(g), d ** -0.5, causal)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16, name
        assert _passes(a, w), (name, _gate(a, w))


def test_sdpa_bwd_tiles_plain_fails_with_ds_as_one_bf16_term():
    """The planted design: dS as one bf16 term in dq and dk fails the gate
    (dv, which takes P alone, still passes)."""
    q, k, v, g, p = _sdpa_case(512, 64, False, seed=140)
    want = _pallas_sdpa_bwd(q, k, v, p, g, 0.125, False)
    args = (_bf16(q), _bf16(k), _bf16(v), p, _bf16(g), 0.125, False)
    good = KA.sdpa_short_bwd_tiles_plain(*args)
    bad = KA.sdpa_short_bwd_tiles_plain(*args, ds_terms=1)
    assert all(_passes(a, w) for a, w in zip(good, want))
    assert not _passes(bad[0], want[0]), _gate(bad[0], want[0])
    assert not _passes(bad[1], want[1]), _gate(bad[1], want[1])
    assert _passes(bad[2], want[2])


# ---------------------------------------------------------------------------
# the operand forms
# ---------------------------------------------------------------------------
def _form_operands(form, n, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(64, 128, generator=gen)
    b = torch.randn(128, n, generator=gen)
    _, ta, tb, planes = KA.WGMMA_FORMS[form]
    am = a if planes else (a.T if ta else a).contiguous().to(torch.bfloat16)
    bm = (b if tb else b.T).contiguous().to(torch.bfloat16)
    return am.to(device), bm.to(device)


def _form_f64(form, am, bm):
    _, ta, tb, _ = KA.WGMMA_FORMS[form]
    a64, b64 = am.double(), bm.double()
    return (a64.T if ta else a64) @ (b64 if tb else b64.T)


@pytest.mark.parametrize("form", range(len(KA.WGMMA_FORMS)))
@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_form_plain_is_the_product(form, n):
    """On the CPU each form is the product of its operands as they lie
    (form 2's A through its hi/lo planes, within 2^-17 of each value)."""
    am, bm = _form_operands(form, n, "cpu", seed=form + n)
    got = KA.wgmma_form_bf16(form, am, bm)
    want = _form_f64(form, am, bm)
    scale = float((_form_f64(form, am.abs(), bm.abs())).max())
    assert got.shape == (64, n) and got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) / scale <= 2 ** -16


@pytest.mark.gpu
@pytest.mark.parametrize("form", range(len(KA.WGMMA_FORMS)))
@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_forms_match_float64_on_the_card(form, n):
    """Each operand form of the attention kernels (SS K-major, SS MN-major,
    RS planes with B MN-major) at n 64 and 128, against float64 on the
    operands' exact values: within 2^-21 of the largest row-by-column
    sum of |products| (form 2: beyond the planes' own 2^-17 of each
    value); the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    am, bm = _form_operands(form, n, "cuda", seed=form + n)
    got = KA.wgmma_form_bf16(form, am, bm)
    again = KA.wgmma_form_bf16(form, am, bm)
    torch.cuda.synchronize()
    want = _form_f64(form, am, bm)
    err = (got.double() - want).abs()
    if KA.WGMMA_FORMS[form][3]:
        err = (err - 2 ** -17 * _form_f64(form, am.abs(), bm.abs())).clamp(
            min=0)
    scale = float(_form_f64(form, am.abs(), bm.abs()).max())
    assert float(err.max()) / scale <= 2 ** -21, float(err.max()) / scale
    assert torch.equal(got, again)
