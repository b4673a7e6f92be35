"""The bf16 attention kernels on wgmma (``csrc/attn_wgmma.cuh``): #2 (flash
forward), #5 (sdpa_short forward, with and without P), #3 (flash dq), #4
(flash dk/dv) and #6 (sdpa_short backward). The arithmetic of their
designs in PyTorch (`flash_attention_tiles_plain`,
`sdpa_short_tiles_plain`, `flash_bwd_dq_tiles_plain`,
`flash_bwd_dkv_tiles_plain`, `sdpa_short_bwd_tiles_plain`) against the
JAX package's Pallas kernels in interpret mode on bf16 inputs, with the
card's gates; the designs that must fail them; and (marked ``gpu``) the
kernels' operand forms against float64 and #3's kernel against its
design on the card.

The gates are the card's (chip_smoke.py `_bf16_ulp_ok`): within one bf16
ulp of the largest |reference| (2^-8 to 2^-7 of it, by where it lies in
its binade) in at most 5% of the elements (both sides compute in fp32
from the same bf16 values and round once), lse within 1e-5. The JAX
package is imported inside the tests that compare with it, so the ``gpu``
tests also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_attn_wgmma.py
"""
import functools
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import attention as KA

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
    """(max |got - want| in bf16 ulps of the largest |want|, the share of
    elements that differ). Both sides round fp32 values once, so an
    element whose two fp32 values straddle a rounding boundary moves by
    one ulp of itself, at most one ulp of the largest |want|."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    ulp = 2.0 ** (math.frexp(top)[1] - 8) if top > 0 else 2.0 ** -133
    return (float((g - w).abs().max()) / ulp,
            float((g != w).float().mean()))


def _passes(got, want):
    ulps, share = _gate(got, want)
    return bool(torch.isfinite(got.float()).all()) and ulps <= 1.0 \
        and share <= BF16_SHARE


@pytest.mark.parametrize("top", [0.5078125, 0.44921875, 1.0, 3.0])
def test_one_ulp_gate(top):
    """The gate's measure: one rounding of the largest element at its
    binade's low end passes (it exceeds 2^-8 of the largest there, the
    gate's former measure), two ulps fail, and one ulp in more than 5%
    of the elements fails."""
    want = (torch.linspace(-0.9, 0.9, 999) * top).to(torch.bfloat16)
    want = torch.cat([torch.tensor([top], dtype=torch.bfloat16), want])
    ulp = 2.0 ** (math.frexp(top)[1] - 8)
    for n_ulps, ok in ((1, True), (2, False)):
        got = want.clone()
        got[0] = top + n_ulps * ulp
        assert float(got[0]) == top + n_ulps * ulp  # a bf16 value
        assert _passes(got, want) is ok, (n_ulps, _gate(got, want))
    assert ulp > 2 ** -8 * top
    many = want.clone()  # one ulp of itself in every tenth element
    many.view(torch.int16)[::10] += 1
    assert _gate(many, want)[0] <= 1.0
    assert not _passes(many, want)


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
# #5: the sdpa_short forward's design against `_sdpa_short_fwd_impl`
# ---------------------------------------------------------------------------
def _pallas_sdpa_fwd(q, k, v, scale, causal):
    jattn = _pallas()
    jattn.force_interpret(True)
    try:
        out, p = jattn._sdpa_short_fwd_impl(*_jnp_bf16(q, k, v), scale,
                                            causal, save_p=True)
    finally:
        jattn.force_interpret(False)
    return _torch(out), _torch(p)


@pytest.mark.parametrize("t,d,causal", [(264, 64, False), (264, 128, True),
                                        (300, 64, True), (300, 128, False),
                                        (512, 64, True), (512, 128, False)])
def test_sdpa_tiles_plain_matches_pallas_interpret(t, d, causal):
    """#2's key loop for the output, then the P sweep with the final max
    and sum, on bf16 inputs (8 heads: the Pallas kernel's group), against
    the Pallas kernel in interpret mode: out and the saved bf16 P within
    one bf16 ulp of the largest in at most 5% of the elements; ragged T
    (264 by TMA on the card, 300 by 2-byte stores), d 128's 64-key tiles;
    P 0 above the diagonal under causal masking."""
    q, k, v = (_randn(1, 8, t, d, seed=160 + t + d + i) for i in range(3))
    want, wp = _pallas_sdpa_fwd(q, k, v, d ** -0.5, causal)
    got, p = KA.sdpa_short_tiles_plain(_bf16(q), _bf16(k), _bf16(v),
                                       d ** -0.5, causal, _key_tile(d))
    assert got.dtype == p.dtype == torch.bfloat16
    assert p.shape == (8, t, t)
    assert _passes(got, want), _gate(got, want)
    assert _passes(p, wp), _gate(p, wp)
    # the output is #2's: the same bits as the flash design's
    flash, _ = KA.flash_attention_tiles_plain(_bf16(q), _bf16(k), _bf16(v),
                                              d ** -0.5, causal, _key_tile(d))
    assert torch.equal(got, flash)
    if causal:
        assert bool((p.float().triu(1) == 0).all())


def test_sdpa_tiles_plain_fails_with_p_from_the_running_max():
    """The planted design: P written during the key loop, each tile's P
    normalized by the running max after that tile instead of the row's
    final one, fails the gate on P (the output is the same)."""
    q, k, v = (_randn(1, 8, 512, 64, seed=190 + i) for i in range(3))
    want, wp = _pallas_sdpa_fwd(q, k, v, 0.125, False)
    args = (_bf16(q), _bf16(k), _bf16(v), 0.125, False)
    good = KA.sdpa_short_tiles_plain(*args)
    bad = KA.sdpa_short_tiles_plain(*args, p_max="running")
    assert _passes(good[1], wp) and torch.equal(good[0], bad[0])
    assert not _passes(bad[1], wp), _gate(bad[1], wp)


# ---------------------------------------------------------------------------
# #4 and #3: the flash dk/dv and dq designs against `_flash_bwd_impl`
# ---------------------------------------------------------------------------
def _flash_bwd_case(tq, tk, d, causal, seed):
    q, g = (_randn(1, 2, tq, d, seed=seed + i) for i in (0, 3))
    k, v = (_randn(1, 2, tk, d, seed=seed + i) for i in (1, 2))
    return q, k, v, g


@functools.lru_cache(maxsize=None)
def _pallas_flash_bwd(tq, tk, d, causal, seed, scale):
    """The Pallas forward's out and lse and `_flash_bwd_impl`'s (dq, dk,
    dv) in interpret mode on the bf16 case's inputs, as torch tensors
    (fp32 values), with delta = rowsum(dO out) in fp32 as the JAX package
    takes it; computed once a case, for #4's and #3's tests alike."""
    jattn = _pallas()
    jq, jk, jv, jg = _jnp_bf16(*_flash_bwd_case(tq, tk, d, causal, seed))
    jattn.force_interpret(True)
    try:
        out, lse = jattn._flash_fwd_impl(jq, jk, jv, scale, causal)
        grads = jattn._flash_bwd_impl(jq, jk, jv, out, lse, jg, scale,
                                      causal)
    finally:
        jattn.force_interpret(False)
    g = _bf16(_flash_bwd_case(tq, tk, d, causal, seed)[3])
    delta = KA.flash_delta(_torch(out).to(torch.bfloat16), g)
    return (torch.from_numpy(np.array(lse)), delta,
            *(_torch(x) for x in grads))


FLASH_BWD_SHAPES = [
    (264, 264, 64, False),   # 64-row query tiles over a ragged T
    (512, 512, 64, True),
    (512, 512, 128, False),  # d 128: both warpgroups on the same keys
    (264, 512, 128, True),   # causal with tq < tk, bottom-right aligned
    (512, 264, 64, False),   # tq > tk
]


@pytest.mark.parametrize("tq,tk,d,causal", FLASH_BWD_SHAPES)
def test_flash_dkv_tiles_plain_matches_pallas_interpret(tq, tk, d, causal):
    """P recomputed from the forward's lse over 64-row query tiles, P and
    dS as planes in chains of two tiles, against `_flash_bwd_impl`'s dk
    and dv in interpret mode (the same bf16 q, k, v, dO, the Pallas
    forward's out and lse; delta = rowsum(dO out) in fp32 as the JAX
    package takes it)."""
    seed, scale = 200 + tq + d, d ** -0.5
    lse, delta, _, wdk, wdv = _pallas_flash_bwd(tq, tk, d, causal, seed,
                                                scale)
    q, k, v, g = (_bf16(x) for x in _flash_bwd_case(tq, tk, d, causal,
                                                    seed))
    dk, dv = KA.flash_bwd_dkv_tiles_plain(q, k, v, g, lse, delta, scale,
                                          causal)
    for name, a, w in (("dk", dk, wdk), ("dv", dv, wdv)):
        assert a.dtype == torch.bfloat16, name
        assert _passes(a, w), (name, _gate(a, w))


@pytest.mark.parametrize("tq,tk,d,causal", FLASH_BWD_SHAPES)
def test_flash_dq_tiles_plain_matches_pallas_interpret(tq, tk, d, causal):
    """#3's design: P recomputed from the forward's lse over 64-key tiles,
    dS as planes in a fresh chain a tile, dq scaled once, against
    `_flash_bwd_impl`'s dq in interpret mode on the same inputs as #4's
    test."""
    seed, scale = 200 + tq + d, d ** -0.5
    lse, delta, wdq, _, _ = _pallas_flash_bwd(tq, tk, d, causal, seed,
                                              scale)
    q, k, v, g = (_bf16(x) for x in _flash_bwd_case(tq, tk, d, causal,
                                                    seed))
    dq = KA.flash_bwd_dq_tiles_plain(q, k, v, g, lse, delta, scale, causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == q.shape
    assert _passes(dq, wdq), _gate(dq, wdq)


FLASH_PLAIN_SHAPES = [
    (300, 300, 128, False),  # T 300: no Pallas block divides it
    (301, 264, 64, True),    # an odd tq: lse rows off 16 bytes on the card
    (200, 72, 64, True),     # 128 rows that see no key: P = 1/tk, dS = 0
]


def _flash_plain_case(tq, tk, d, causal):
    q, k, v, g = (_bf16(x) for x in _flash_bwd_case(tq, tk, d, causal,
                                                    seed=230 + tq))
    scale = d ** -0.5
    out, lse = KA.flash_attention_plain(q, k, v, scale, causal,
                                        with_lse=True)
    return q, k, v, g, out, lse, KA.flash_delta(out, g), scale


@pytest.mark.parametrize("tq,tk,d,causal", FLASH_PLAIN_SHAPES)
def test_flash_dkv_tiles_plain_matches_plain(tq, tk, d, causal):
    """Shapes the Pallas kernel does not take (T 300, an odd tq) and fully
    masked rows (causal, tq > tk: the port's C5 rule, which the Pallas
    kernel does not follow): against the port's plain version, the TPU
    kernel's function, from the plain forward's out and lse."""
    q, k, v, g, out, lse, delta, scale = _flash_plain_case(tq, tk, d,
                                                           causal)
    got = KA.flash_bwd_dkv_tiles_plain(q, k, v, g, lse, delta, scale,
                                       causal)
    want = KA.flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale, causal)
    for name, a, w in zip(("dk", "dv"), got, want):
        assert _passes(a, w), (name, _gate(a, w))
    if tq > tk and causal:
        # dO on the rows that see no key alone: dv = their sum / tk, dk 0
        g2 = g.clone()
        g2[:, :, tq - tk:] = 0
        dk2, dv2 = KA.flash_bwd_dkv_tiles_plain(
            q, k, v, g2, lse, KA.flash_delta(out, g2), scale, True)
        blind = (g2.float().sum(2, keepdim=True) / tk).expand_as(dv2)
        assert _passes(dv2, blind.to(torch.bfloat16)), _gate(dv2, blind)
        assert bool((dk2 == 0).all())


@pytest.mark.parametrize("tq,tk,d,causal", FLASH_PLAIN_SHAPES)
def test_flash_dq_tiles_plain_matches_plain(tq, tk, d, causal):
    """#3's design at the shapes the Pallas kernel does not take and with
    rows that see no key (causal, tq > tk): against the port's plain
    version from the plain forward's out and lse; those rows' dq is 0
    exactly, whatever their lse (-FLT_MAX)."""
    q, k, v, g, _, lse, delta, scale = _flash_plain_case(tq, tk, d, causal)
    got = KA.flash_bwd_dq_tiles_plain(q, k, v, g, lse, delta, scale, causal)
    want = KA.flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal)
    assert _passes(got, want), _gate(got, want)
    if tq > tk and causal:
        blind = tq - tk
        assert bool((lse[:, :, :blind] == -KA.FLT_MAX).all())
        assert bool((got[:, :, :blind] == 0).all())
        assert bool((got[:, :, blind:] != 0).any())


def _pallas_fault_case():
    q, k, v, g = (_bf16(x) for x in _flash_bwd_case(1024, 1024, 64, False,
                                                    seed=260))
    return (q, k, v, g, *_pallas_flash_bwd(1024, 1024, 64, False, 260,
                                           0.125))


def test_flash_dkv_tiles_plain_fails_with_p_as_one_bf16_term():
    """The planted design: P^T fed to dv as one bf16 term fails the gate
    on dv (dk, from dS's planes, still passes)."""
    q, k, v, g, lse, delta, _, wdk, wdv = _pallas_fault_case()
    args = (q, k, v, g, lse, delta, 0.125, False)
    good = KA.flash_bwd_dkv_tiles_plain(*args)
    bad = KA.flash_bwd_dkv_tiles_plain(*args, p_terms=1)
    assert _passes(good[0], wdk) and _passes(good[1], wdv)
    assert _passes(bad[0], wdk)
    assert not _passes(bad[1], wdv), _gate(bad[1], wdv)


def test_flash_dq_tiles_plain_fails_with_ds_as_one_bf16_term():
    """The planted design: dS fed to dq as one bf16 term moves dq by ~2^-9
    of itself before its rounding and fails the gate; two planes pass."""
    q, k, v, g, lse, delta, wdq, _, _ = _pallas_fault_case()
    args = (q, k, v, g, lse, delta, 0.125, False)
    good = KA.flash_bwd_dq_tiles_plain(*args)
    bad = KA.flash_bwd_dq_tiles_plain(*args, ds_terms=1)
    assert _passes(good, wdq), _gate(good, wdq)
    assert not _passes(bad, wdq), _gate(bad, wdq)


@pytest.mark.gpu
@pytest.mark.parametrize("tq,tk,d,causal", [
    (1024, 1024, 64, False),
    (1024, 1024, 64, True),
    (301, 264, 64, True),    # an odd tq: lse and delta rows off 16 bytes
    (264, 300, 128, False),  # tq != tk, ragged tiles, d 128
    (333, 200, 128, True),   # causal with tq > tk: rows that see no key
    (200, 72, 64, True),
    (100, 40, 256, True),    # d 256: the mma.sync body, by dispatch
])
def test_flash_dq_kernel_matches_its_design_on_the_card(tq, tk, d, causal):
    """bf16 #3 on the card against its design's arithmetic
    (`flash_bwd_dq_tiles_plain`) and the function (`flash_bwd_dq_plain`),
    both within one bf16 ulp of the largest in at most 5% of the
    elements, from the plain forward's out and lse; the same bits on a
    second launch; 0 exactly on the rows that see no key; one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v, g = (_bf16(x).cuda() for x in _flash_bwd_case(
        tq, tk, d, causal, seed=300 + tq + d))
    scale = d ** -0.5
    out, lse = KA.flash_attention_plain(q, k, v, scale, causal,
                                        with_lse=True)
    delta = KA.flash_delta(out, g)
    before = KA.flash_bwd_dq.launches
    got = KA.flash_bwd_dq(q, k, v, g, lse, delta, scale, causal)
    again = KA.flash_bwd_dq(q, k, v, g, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert KA.flash_bwd_dq.launches == before + 2
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    design = KA.flash_bwd_dq_tiles_plain(q, k, v, g, lse, delta, scale,
                                         causal)
    want = KA.flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal)
    assert _passes(got, design), _gate(got, design)
    assert _passes(got, want), _gate(got, want)
    if causal and tq > tk:
        assert bool((got[:, :, :tq - tk] == 0).all())


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
