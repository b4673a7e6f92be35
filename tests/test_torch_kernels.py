"""The port's kernels: plain versions against the JAX package, wrapper
dispatch on the CPU, and (marked ``gpu``) each CUDA kernel against its
plain version on the card.

Tolerances: fp32 throughout, about 1e-5 absolute; the implementations
sum in different orders, and nothing else differs. The JAX package is
imported inside the tests that compare with it, so the ``gpu`` tests
also run where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import kernels as K
from paddle_tpu_torch.ops.kernels import attention as KA
from paddle_tpu_torch.ops.kernels import attention_block as KAB
from paddle_tpu_torch.ops.kernels import ffn_block as KFF
from paddle_tpu_torch.ops.kernels import layer_norm as KL
from paddle_tpu_torch.ops.kernels import xent as KX

ATOL = 1e-5
# the reference's own xent test limit (tests/test_pallas_attention.py)
XENT_TOL = dict(rtol=2e-6, atol=2e-6)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs test files in parallel worker processes; keep
    torch's CPU thread pool small so these tests do not crowd the
    timing-sensitive tests of other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randn(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        "float32")


@pytest.fixture
def jax_ref():
    """The JAX package's pallas module, on the CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu.ops import pallas

    return pallas


# ---------------------------------------------------------------------------
# plain versions vs the JAX package (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(16, 96), (8, 512), (5, 300)])
def test_layer_norm_plain_matches_ln_ref(jax_ref, n, d):
    from paddle_tpu.ops.pallas import layer_norm as jln

    x = _randn(n, d, seed=1, scale=3.0) + 0.5
    s, b = _randn(d, seed=2), _randn(d, seed=3)
    want = np.asarray(jln._ln_ref(x, s, b, 1e-5))
    y, mean, var = KL.layer_norm_plain(torch.from_numpy(x),
                                       torch.from_numpy(s),
                                       torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), x.mean(1), rtol=0, atol=ATOL)
    np.testing.assert_allclose(var.numpy(), x.var(1), rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_short_plain_matches_pallas_interpret(jax_ref, causal):
    from paddle_tpu.ops.pallas import attention as jattn

    # B*H is a multiple of 8: the TPU kernel groups 8 heads a program
    q, k, v = (_randn(1, 8, 264, 64, seed=s) for s in (4, 5, 6))
    jattn.force_interpret(True)
    try:
        want = np.asarray(jattn.sdpa_short(q, k, v, 0.125, causal))
    finally:
        jattn.force_interpret(False)
    got = KA.sdpa_short_plain(*map(torch.from_numpy, (q, k, v)), 0.125,
                              causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, False), (64, 64, True),
                                          (32, 64, True)])
def test_flash_plain_matches_pallas_interpret(jax_ref, tq, tk, causal):
    from paddle_tpu.ops.pallas import attention as jattn

    q = _randn(1, 2, tq, 64, seed=7)
    k, v = _randn(1, 2, tk, 64, seed=8), _randn(1, 2, tk, 64, seed=9)
    jattn.force_interpret(True)
    try:
        want = np.asarray(jattn.flash_attention(q, k, v, 0.125, causal))
    finally:
        jattn.force_interpret(False)
    got = KA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   0.125, causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, False), (64, 64, True),
                                          (32, 64, True)])
def test_flash_lse_plain_matches_pallas_interpret(jax_ref, tq, tk, causal):
    """The per-row logsumexp that the forward writes for the backward
    (`_flash_fwd_impl`'s second output)."""
    from paddle_tpu.ops.pallas import attention as jattn

    q = _randn(1, 2, tq, 64, seed=7)
    k, v = _randn(1, 2, tk, 64, seed=8), _randn(1, 2, tk, 64, seed=9)
    jattn.force_interpret(True)
    try:
        want_out, want_lse = jattn._flash_fwd_impl(q, k, v, 0.125, causal)
    finally:
        jattn.force_interpret(False)
    out, lse = KA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                        0.125, causal, with_lse=True)
    assert lse.shape == (1, 2, tq) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, False), (64, 64, True),
                                          (32, 64, True)])
def test_flash_bwd_plain_matches_pallas_interpret(jax_ref, tq, tk, causal):
    """(dq, dk, dv) from the same (q, k, v, out, lse, g) as
    `_flash_bwd_impl` (its `_bwd_dq_kernel` and `_bwd_dkv_kernel`)."""
    from paddle_tpu.ops.pallas import attention as jattn

    q, g = _randn(1, 2, tq, 64, seed=7), _randn(1, 2, tq, 64, seed=10)
    k, v = _randn(1, 2, tk, 64, seed=8), _randn(1, 2, tk, 64, seed=9)
    jattn.force_interpret(True)
    try:
        out, lse = jattn._flash_fwd_impl(q, k, v, 0.125, causal)
        want = jattn._flash_bwd_impl(q, k, v, out, lse, g, 0.125, causal)
    finally:
        jattn.force_interpret(False)
    got = KA.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, np.array(out), np.array(lse), g)),
        0.125, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=name)


def _sdpa_interpret(causal, seed=4):
    """[1,8,264,64] inputs, `_sdpa_short_fwd_impl(save_p=True)` and
    `_sdpa_short_bwd_impl` in interpret mode: (q, k, v, g, out, bf16 P,
    (dq, dk, dv))."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import attention as jattn

    # B*H is a multiple of 8: the TPU kernels group 8 and 4 heads a program
    q, k, v, g = (_randn(1, 8, 264, 64, seed=seed + i) for i in range(4))
    jattn.force_interpret(True)
    try:
        out, p = jattn._sdpa_short_fwd_impl(q, k, v, 0.125, causal,
                                            save_p=True)
        grads = jattn._sdpa_short_bwd_impl(q, k, v, p, g, 0.125, causal)
    finally:
        jattn.force_interpret(False)
    return q, k, v, g, out, np.array(p.astype(jnp.float32)), grads


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_short_p_plain_matches_pallas_interpret(jax_ref, causal):
    """The saved probabilities: the TPU kernel rounds them to bf16, the
    port keeps fp32, so they agree within half a bf16 ulp (bf16 keeps 8
    significant bits: 2^-8 relative), plus 1e-6 for the two fp32
    softmaxes' summation order."""
    q, k, v, _, out, want_p, _ = _sdpa_interpret(causal)
    got, p = KA.sdpa_short_plain(*map(torch.from_numpy, (q, k, v)), 0.125,
                                 causal, save_p=True)
    assert p.shape == (8, 264, 264) and p.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(p.numpy(), want_p, rtol=2 ** -8 + 1e-6,
                               atol=0)
    if causal:
        assert (p.numpy()[:, np.triu_indices(264, 1)[0],
                          np.triu_indices(264, 1)[1]] == 0).all()


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_short_bwd_plain_matches_pallas_interpret(jax_ref, causal):
    """(dq, dk, dv) from the same bf16 P, cast to fp32 on the port's
    side, so only the summation order differs."""
    q, k, v, g, _, p, want = _sdpa_interpret(causal, seed=20)
    got = KA.sdpa_short_bwd_plain(*map(torch.from_numpy, (q, k, v, p, g)),
                                  0.125, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=name)


def _stages_bwd(q, k, v, p, g, scale):
    """The formulation of the attention stages (attn_bwd_from_p.cuh) with
    the forward's O, as the attention block's backward gives it: delta =
    rowsum(dO O), then the algebra of the stages that sdpa_short_bwd.cu
    shares with the attention block (sdpa_short_bwd.cu gives no O and
    takes delta as rowsum(dP P), as the plain version does)."""
    delta = (g * (p @ v)).sum(-1, keepdim=True)
    dp = g @ v.transpose(-1, -2)
    ds = p * (dp - delta)
    return (ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
            p.transpose(-1, -2) @ g)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_short_bwd_formulation_matches_pallas_interpret(jax_ref,
                                                             causal):
    """The attention stages given O take rowsum(dP P) as rowsum(dO (P v)),
    which the TPU kernel never forms: the same quantity, since both are
    sum_k P_ik sum_d dO_id v_kd. The formulation, on the port's fp32 P,
    against `_sdpa_short_bwd_impl` in interpret mode on the same P at
    [2,4,384,64], within the suite's 1e-5 (summation order only)."""
    from paddle_tpu.ops.pallas import attention as jattn

    q, k, v, g = (_randn(2, 4, 384, 64, seed=30 + i) for i in range(4))
    _, p = KA.sdpa_short_plain(*map(torch.from_numpy, (q, k, v)), 0.125,
                               causal, save_p=True)
    p = p.numpy()
    jattn.force_interpret(True)
    try:
        want = jattn._sdpa_short_bwd_impl(q, k, v, p, g, 0.125, causal)
    finally:
        jattn.force_interpret(False)
    got = _stages_bwd(*(torch.from_numpy(x) for x in (
        q, k, v, p.reshape(2, 4, 384, 384), g)), 0.125)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind,tq,tk,causal", [
    ("flash", 8, 4, True),      # rows 0..3 see no key
    ("flash", 6, 6, False), ("flash", 5, 9, True),
    ("sdpa_short", 6, 6, True), ("sdpa_short", 6, 6, False)])
def test_attention_bwd_plain_matches_autograd(kind, tq, tk, causal):
    """Each plain backward is the gradient of the port's forward,
    `reference_attention` (finfo.min masking) under torch autograd,
    fully masked rows included: there dv takes g / tk and dq and the
    row's share of dk are 0."""
    q = torch.from_numpy(_randn(2, 2, tq, 16, seed=30))
    k = torch.from_numpy(_randn(2, 2, tk, 16, seed=31))
    v = torch.from_numpy(_randn(2, 2, tk, 16, seed=32))
    g = torch.from_numpy(_randn(2, 2, tq, 16, seed=33))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(
        K.reference_attention(qr, kr, vr, 0.25, causal), (qr, kr, vr), g)
    if kind == "flash":
        out, lse = KA.flash_attention_plain(q, k, v, 0.25, causal,
                                            with_lse=True)
        got = KA.flash_attention_bwd_plain(q, k, v, out, lse, g, 0.25,
                                           causal)
    else:
        _, p = KA.sdpa_short_plain(q, k, v, 0.25, causal, save_p=True)
        got = KA.sdpa_short_bwd_plain(q, k, v, p, g, 0.25, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)
    if tq > tk and causal:
        # a cotangent on the blind rows alone: every key's dv is their
        # sum / tk, and no other grad moves
        gb = torch.zeros_like(g)
        gb[:, :, :tq - tk] = g[:, :, :tq - tk]
        dq, dk, dv = KA.flash_attention_bwd_plain(q, k, v, out, lse, gb,
                                                  0.25, causal)
        assert (dq == 0).all() and (dk == 0).all()
        torch.testing.assert_close(
            dv, gb.sum(2, keepdim=True).expand_as(dv) / tk, rtol=0,
            atol=1e-7)


@pytest.mark.parametrize("tq,tk,causal", [(6, 6, False), (6, 6, True),
                                          (8, 4, True)])
def test_reference_attention_matches_paddle_tpu(jax_ref, tq, tk, causal):
    q = _randn(2, 2, tq, 16, seed=10)
    k, v = _randn(2, 2, tk, 16, seed=11), _randn(2, 2, tk, 16, seed=12)
    want = np.asarray(jax_ref.reference_attention(q, k, v, 0.25, causal))
    got = K.reference_attention(*map(torch.from_numpy, (q, k, v)), 0.25,
                                causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.isfinite(got).all()
    if tq > tk and causal:
        # rows i < tq - tk see no key: the uniform average of v
        np.testing.assert_allclose(got[:, :, 0], v.mean(axis=2),
                                   rtol=0, atol=ATOL)


def _xent_inputs(n, v, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(n, v) * 2).astype("float32")
    lab = r.randint(0, v, (n,)).astype("int64")
    lab[::7] = -100  # ignored rows
    g = r.rand(n).astype("float32")
    return x, lab, g


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_xent_plain_matches_pallas_interpret(jax_ref, eps):
    from paddle_tpu.ops.pallas import attention as jattn
    from paddle_tpu.ops.pallas import xent as jxent

    x, lab, g = _xent_inputs(64, 256, seed=17)
    jattn.force_interpret(True)
    try:
        wloss, wlse = jxent.xent_forward(x, lab.astype("int32"), eps=eps)
        wdx = jxent.xent_backward(x, lab.astype("int32"), g, eps=eps)
    finally:
        jattn.force_interpret(False)
    tx, tlab, tg = map(torch.from_numpy, (x, lab, g))
    loss, lse = KX.xent_forward_plain(tx, tlab, eps)
    dx = KX.xent_backward_plain(tx, tlab, tg, eps)
    np.testing.assert_allclose(loss.numpy(), np.asarray(wloss), **XENT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse), **XENT_TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(wdx), **XENT_TOL)
    assert (loss.numpy()[lab == -100] == 0).all()
    assert (dx.numpy()[lab == -100] == 0).all()


def test_xent_plain_out_of_range_label_picks_zero():
    """A label outside [0, V) matches no column (the TPU kernel's
    `cols == lab` compare): the loss is lse, the grad is softmax·g."""
    x = torch.from_numpy(_randn(3, 10, seed=18))
    lab = torch.tensor([2, 10, -5])
    loss, lse = KX.xent_forward_plain(x, lab)
    torch.testing.assert_close(loss[1:], lse[1:], rtol=0, atol=0)
    dx = KX.xent_backward_plain(x, lab, torch.ones(3))
    # exp(x - lse) against softmax's exp / sum: an ulp apart
    torch.testing.assert_close(dx[1:], torch.softmax(x[1:], 1), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# wrapper dispatch on the CPU and the meta device
# ---------------------------------------------------------------------------
def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    x = torch.from_numpy(_randn(4, 40, seed=13))
    s, b = torch.ones(40), torch.zeros(40)
    q, k, v = (torch.from_numpy(_randn(1, 2, 300, 64, seed=i))
               for i in (14, 15, 16))
    before = (KL.layer_norm.launches, KA.sdpa_short.launches,
              KA.flash_attention.launches)
    for got, want in zip(KL.layer_norm(x, s, b),
                         KL.layer_norm_plain(x, s, b)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(KA.sdpa_short(q, k, v, 0.125, True),
                               KA.sdpa_short_plain(q, k, v, 0.125, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        KA.flash_attention(q, k, v, 0.125, True),
        KA.flash_attention_plain(q, k, v, 0.125, True), rtol=0, atol=0)
    assert (KL.layer_norm.launches, KA.sdpa_short.launches,
            KA.flash_attention.launches) == before
    x, lab, g = map(torch.from_numpy, _xent_inputs(8, 40, seed=19))
    before = KX.xent_forward.launches, KX.xent_backward.launches
    for got, want in zip(KX.xent_forward(x, lab, 0.1),
                         KX.xent_forward_plain(x, lab, 0.1)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(KX.xent_backward(x, lab, g, 0.1),
                               KX.xent_backward_plain(x, lab, g, 0.1),
                               rtol=0, atol=0)
    assert (KX.xent_forward.launches, KX.xent_backward.launches) == before


def test_wrappers_answer_meta_with_shapes_only():
    meta = torch.device("meta")
    x = torch.empty(7, 512, device=meta)
    y, mean, var = KL.layer_norm(x, torch.empty(512, device=meta),
                                 torch.empty(512, device=meta))
    assert y.shape == (7, 512) and mean.shape == var.shape == (7,)
    assert mean.dtype == torch.float32 and y.device == meta
    q = torch.empty(7, 8, 1024, 64, device=meta)
    assert KA.flash_attention(q, q, q, 0.125).shape == q.shape
    assert KA.sdpa_short(q[:, :, :512], q[:, :, :512], q[:, :, :512],
                         0.125).shape == (7, 8, 512, 64)
    x = torch.empty(7, 32000, device=meta)
    lab = torch.empty(7, dtype=torch.int64, device=meta)
    loss, lse = KX.xent_forward(x, lab)
    assert loss.shape == lse.shape == (7,) and loss.dtype == torch.float32
    assert KX.xent_backward(x, lab, loss).shape == x.shape


def test_backward_wrappers_run_plain_on_cpu_and_answer_meta():
    """The backward wrappers dispatch like the forward ones: the plain
    version on the CPU with no launch counted, shapes alone on meta."""
    q, k, v, g = (torch.from_numpy(_randn(1, 2, 40, 64, seed=i))
                  for i in range(40, 44))
    before = (KA.sdpa_short_bwd.launches, KA.flash_bwd_dq.launches,
              KA.flash_bwd_dkv.launches)
    _, p = KA.sdpa_short_plain(q, k, v, 0.125, True, save_p=True)
    for got, want in zip(KA.sdpa_short_bwd(q, k, v, p, g, 0.125, True),
                         KA.sdpa_short_bwd_plain(q, k, v, p, g, 0.125)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    out, lse = KA.flash_attention_plain(q, k, v, 0.125, True, with_lse=True)
    delta = KA.flash_delta(out, g)
    got = (KA.flash_bwd_dq(q, k, v, g, lse, delta, 0.125, True),
           *KA.flash_bwd_dkv(q, k, v, g, lse, delta, 0.125, True))
    for a, b in zip(got, KA.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                      0.125, True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (KA.sdpa_short_bwd.launches, KA.flash_bwd_dq.launches,
            KA.flash_bwd_dkv.launches) == before
    meta = torch.device("meta")
    q = torch.empty(7, 8, 1024, 64, device=meta)
    lse = torch.empty(7, 8, 1024, device=meta)
    assert KA.flash_bwd_dq(q, q, q, q, lse, lse, 0.125).shape == q.shape
    assert all(x.shape == q.shape for x in KA.flash_bwd_dkv(
        q, q, q, q, lse, lse, 0.125))
    p = torch.empty(56, 1024, 1024, device=meta)
    assert all(x.shape == q.shape for x in KA.sdpa_short_bwd(
        q, q, q, p, q, 0.125))


# ---------------------------------------------------------------------------
# the build: a library's name hashes every header it reaches (no nvcc)
# ---------------------------------------------------------------------------
def test_build_target_hashes_headers_included_by_headers(tmp_path,
                                                         monkeypatch):
    """Editing a header that only another header includes names a new
    library, so no stale build is loaded; a header reached twice, or in
    a cycle, is read once."""
    from paddle_tpu_torch.ops.kernels import build

    (tmp_path / "k.cu").write_text(
        '#include <stdint.h>\n#include "outer.cuh"\n#include "outer.cuh"\n')
    (tmp_path / "outer.cuh").write_text(
        '#pragma once\n#include "inner.cuh"\n#include "outer.cuh"\n')
    (tmp_path / "inner.cuh").write_text(
        '#pragma once\n#include "outer.cuh"\nint inner = 1;\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [t.splitlines()[-1] for t in build._sources("k")] == [
        b'#include "outer.cuh"', b'#include "outer.cuh"',
        b"int inner = 1;"]
    before = build._target("k")
    assert build._target("k") == before
    (tmp_path / "inner.cuh").write_text(
        '#pragma once\n#include "outer.cuh"\nint inner = 2;\n')
    assert build._target("k") != before


def test_kernel_sources_reach_the_shared_headers():
    from paddle_tpu_torch.ops.kernels import build

    def headers(name):
        return {t for t in build._sources(name)[1:]}

    split, mma, fwd, bwd, bf16, wgmma, hopper, attn = (
        (build.CSRC / f"{n}.cuh").read_bytes()
        for n in ("split_tf32", "tile_mma", "flash_fwd", "attn_bwd_from_p",
                  "split_bf16", "wgmma_bf16", "hopper", "attn_wgmma"))
    # the three forwards run one body in fp32 (#2 and #5 in bf16 at d 64
    # and 128 their own Hopper design, attn_wgmma.cuh), the flash backward
    # its mma.sync kernels (dk/dv in bf16 at d 64 and 128 attn_wgmma.cuh),
    # the sdpa_short backward runs the attention block's stages in fp32
    # (with no O = P v product of its own) and attn_wgmma.cuh in bf16,
    # both fused blocks run their products on the split-TF32 product in
    # fp32 and on the wgmma engine in bf16, the engine and attn_wgmma.cuh
    # share hopper.cuh's primitives, and the paged kernel takes the
    # cp.async staging; the SIMT product (tile_gemm.cuh) is gone; the
    # mma.sync attention bodies take their operands through
    # split_bf16.cuh's traits (fp32 or bf16)
    assert headers("flash_attention") == {split, fwd, bf16, hopper, attn}
    assert headers("sdpa_short") == {split, fwd, bf16, hopper, attn}
    assert headers("flash_attention_bwd") == {split, bf16, hopper, attn}
    assert headers("sdpa_short_bwd") == {split, bwd, bf16, hopper, attn}
    assert headers("attention_block") == {split, mma, fwd, bwd, bf16, wgmma,
                                          hopper}
    assert headers("ffn_block") == {split, mma, wgmma, hopper}
    assert headers("paged_attention") == {split}
    assert not (build.CSRC / "tile_gemm.cuh").exists()
    for name in build.SOURCES:
        assert b"tile_gemm" not in b"".join(build._sources(name)), name


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest --noconftest -m gpu "
                    "tests/test_torch_kernels.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_randn(cuda, *shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(_randn(*shape, seed=seed)).to(cuda, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(8192, 512), (8, 512), (33, 300),
                                 (4, 2048)])
def test_layer_norm_kernel_matches_plain(cuda, n, d):
    x = _cuda_randn(cuda, n, d, seed=1) * 3 + 0.5
    s, b = _cuda_randn(cuda, d, seed=2), _cuda_randn(cuda, d, seed=3)
    before = KL.layer_norm.launches
    got = KL.layer_norm(x, s, b, 1e-5)
    torch.cuda.synchronize()
    assert KL.layer_norm.launches == before + 1
    for g, w in zip(got, KL.layer_norm_plain(x, s, b, 1e-5)):
        torch.testing.assert_close(g, w, rtol=0, atol=ATOL)


def _ln_var_without_mean(x, scale, bias, eps=1e-5):
    """#1's planted fault in bf16: the variance as mean(x^2)."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(x32.square().mean(dim=1, keepdim=True)
                                   + eps)
    return (y * scale.float()[None] + bias.float()[None]).to(x.dtype)


def _ln_bf16_case(device, n, d):
    g = torch.Generator().manual_seed(n + d)
    x = (torch.randn(n, d, generator=g) * 3 + 0.5).to(torch.bfloat16)
    s, b = (torch.randn(d, generator=g).to(torch.bfloat16)
            for _ in range(2))
    return x.to(device), s.to(device), b.to(device)


def test_layer_norm_bf16_gate_sees_the_planted_fault():
    """The card's gate for #1 in bf16 (one ulp of the largest |plain| in
    at most 5% of the elements) on the CPU: the plain version passes
    against itself, the variance without the mean subtracted fails."""
    x, s, b = _ln_bf16_case("cpu", 512, 512)
    want = KL.layer_norm_plain(x, s, b)[0]
    assert _bf16_passes(KL.layer_norm(x, s, b)[0], want)
    assert not _bf16_passes(_ln_var_without_mean(x, s, b), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d", [(8192, 512), (4096, 512), (33, 300)])
def test_layer_norm_kernel_bf16_one_ulp(cuda, n, d):
    """#1 in bf16 at the predictor's rows: one ulp of the largest |plain|
    in at most 5% of the elements, the same bits twice."""
    x, s, b = _ln_bf16_case(cuda, n, d)
    before = KL.layer_norm.launches_bf16
    y = KL.layer_norm(x, s, b)[0]
    assert KL.layer_norm.launches_bf16 == before + 1
    want = KL.layer_norm_plain(x, s, b)[0]
    assert _bf16_passes(y, want)
    assert torch.equal(y, KL.layer_norm(x, s, b)[0])
    assert not _bf16_passes(_ln_var_without_mean(x, s, b), want)


@pytest.mark.gpu
def test_layer_norm_kernel_bf16(cuda):
    x = _cuda_randn(cuda, 64, 512, seed=4, dtype=torch.bfloat16)
    s = _cuda_randn(cuda, 512, seed=5, dtype=torch.bfloat16)
    b = _cuda_randn(cuda, 512, seed=6, dtype=torch.bfloat16)
    y, mean, var = KL.layer_norm(x, s, b)
    wy, wmean, wvar = KL.layer_norm_plain(x, s, b)
    assert y.dtype == torch.bfloat16
    # one bf16 rounding of y apart: 2^-8 relative
    torch.testing.assert_close(y.float(), wy.float(), rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(mean, wmean, rtol=0, atol=ATOL)
    torch.testing.assert_close(var, wvar, rtol=0, atol=ATOL)


def _ln_forced_plans(x, s, b):
    """Every plan #1 can take at x's shape: the wrapper's (`ln_plan`'s),
    the warp body with each narrower load width, on one CTA an SM, and
    the block body (a block a row)."""
    n, d = x.shape
    item = x.element_size()
    ptrs = (x.data_ptr(), 0, s.data_ptr(), b.data_ptr())
    chosen = KL.ln_plan(n, d, x.dtype, ptrs)
    plans = {"chosen": chosen, "block": KL.LnPlan("block", item, 0, n)}
    if chosen.body == "block":
        return plans
    plans["1 CTA an SM"] = chosen._replace(grid=min(chosen.grid, 132))
    width = chosen.vec_bytes // 2
    while width >= item:
        plans[f"{width}B"] = KL.ln_plan(n, d, x.dtype, (width,))._replace(
            grid=chosen.grid)
        width //= 2
    return plans


def _ln_agrees(got, want):
    y, mean, var = got
    wy, wmean, wvar = want
    torch.testing.assert_close(mean, wmean, rtol=0, atol=ATOL)
    torch.testing.assert_close(var, wvar, rtol=0, atol=ATOL)
    if y.dtype == torch.bfloat16:
        assert _bf16_passes(y, wy)
    else:
        torch.testing.assert_close(y, wy, rtol=0, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dtype", [
    (8192, 512, torch.float32), (32768, 512, torch.float32),
    (8, 512, torch.float32), (9, 512, torch.float32),
    (17, 512, torch.float32), (85, 512, torch.float32),
    (17, 256, torch.float32), (4096, 256, torch.float32),
    (1, 512, torch.float32), (4096, 300, torch.float32),
    (8192, 512, torch.bfloat16), (4096, 512, torch.bfloat16),
    (33, 300, torch.bfloat16), (7, 511, torch.bfloat16),
    (3000, 1024, torch.float32),
    (5, 1023, torch.bfloat16), (6, 1025, torch.float32),
    (3, 2048, torch.bfloat16)])
def test_layer_norm_kernel_each_plan_matches_plain(cuda, n, d, dtype):
    """#1 on every plan it can take, forced through the wrapper: against
    the plain version (fp32 1e-5; bf16 one ulp of the largest |plain| in
    at most 5%, mean and var 1e-5), the same bits on a second launch, one
    launch counted each."""
    g = torch.Generator().manual_seed(n + d)
    x = (torch.randn(n, d, generator=g) * 3 + 0.5).to(cuda, dtype)
    s, b = (torch.randn(d, generator=g).to(cuda, dtype) for _ in range(2))
    want = KL.layer_norm_plain(x, s, b)
    for name, plan in _ln_forced_plans(x, s, b).items():
        before = KL.layer_norm.launches
        one = KL.layer_norm_with(x, s, b, 1e-5, plan)
        two = KL.layer_norm_with(x, s, b, 1e-5, plan)
        torch.cuda.synchronize()
        assert KL.layer_norm.launches == before + 2, name
        _ln_agrees(one, want)
        assert all(torch.equal(u, v) for u, v in zip(one, two)), name


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,dtype,offset,width", [
    (4097, 300, torch.bfloat16, None, 8),   # x[1:]
    (4096, 512, torch.bfloat16, 1, 2), (4096, 512, torch.float32, 1, 4),
    (4096, 512, torch.float32, 2, 8), (17, 512, torch.float32, 3, 4)])
def test_layer_norm_kernel_on_row_views_off_16_bytes(cuda, n, d, dtype,
                                                     offset, width):
    """A row view off a 16-byte boundary (x[1:] of [4097, 300] bf16, or x
    `offset` elements into its storage) takes the narrower loads its
    address allows and agrees with the plain version; a forced 16-byte
    plan on it is refused before any launch (no count)."""
    g = torch.Generator().manual_seed(n + d)
    flat = (torch.randn((offset or 0) + n * d, generator=g) * 3 + 0.5).to(
        cuda, dtype)
    if offset is None:
        x = flat.view(n, d)[1:]
    else:
        x = flat[offset:].view(n, d)
    s, b = (torch.randn(d, generator=g).to(cuda, dtype) for _ in range(2))
    plan = KL.ln_plan(*x.shape, dtype, (x.data_ptr(), 0, s.data_ptr(),
                                         b.data_ptr()))
    assert plan.vec_bytes == width
    _ln_agrees(KL.layer_norm(x, s, b), KL.layer_norm_plain(x, s, b))
    before = KL.layer_norm.launches
    with pytest.raises(RuntimeError):
        KL.layer_norm_with(x, s, b, 1e-5, plan._replace(vec_bytes=16))
    assert KL.layer_norm.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,causal", [
    (2, 8, 512, 64, False), (2, 8, 512, 64, True), (1, 4, 300, 128, True),
    (1, 2, 264, 64, False)])
def test_sdpa_short_kernel_matches_plain(cuda, b, h, t, d, causal):
    q, k, v = (_cuda_randn(cuda, b, h, t, d, seed=s) for s in (7, 8, 9))
    before = KA.sdpa_short.launches
    got = KA.sdpa_short(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert KA.sdpa_short.launches == before + 1
    torch.testing.assert_close(
        got, KA.sdpa_short_plain(q, k, v, d ** -0.5, causal), rtol=0,
        atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal", [
    (2, 8, 1024, 1024, 64, False), (2, 8, 1024, 1024, 64, True),
    (1, 4, 96, 1024, 64, True), (1, 2, 100, 40, 128, True),
    (1, 2, 600, 600, 256, True)])
def test_flash_kernel_matches_plain(cuda, b, h, tq, tk, d, causal):
    q = _cuda_randn(cuda, b, h, tq, d, seed=10)
    k = _cuda_randn(cuda, b, h, tk, d, seed=11)
    v = _cuda_randn(cuda, b, h, tk, d, seed=12)
    before = KA.flash_attention.launches
    got = KA.flash_attention(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert KA.flash_attention.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, KA.flash_attention_plain(q, k, v, d ** -0.5, causal), rtol=0,
        atol=2e-5)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero): the operand a split-TF32 kernel would see if it dropped the
    small halves of its products."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_repeats_and_beats_a_tf32_control(cuda, causal):
    """The forward runs in split TF32 on the tensor cores: a second launch
    gives identical bits, with lse and without, and the plain forward on
    TF32-rounded q, k, v fails the limits that the kernel passes."""
    q, k, v = (_cuda_randn(cuda, 2, 8, 1024, 64, seed=s) for s in (10, 11,
                                                                  12))
    runs = [KA._flash_attention_launch(q, k, v, 0.125, causal, True)
            for _ in range(2)]
    primal = KA._flash_attention_launch(q, k, v, 0.125, causal, False)
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(primal, runs[0][0])
    want, wlse = KA.flash_attention_plain(q, k, v, 0.125, causal,
                                          with_lse=True)
    assert float((runs[0][0] - want).abs().max()) <= 2e-5
    assert float((runs[0][1] - wlse).abs().max()) <= 1e-5
    tout, tlse = KA.flash_attention_plain(_tf32(q), _tf32(k), _tf32(v),
                                          0.125, causal, with_lse=True)
    assert float((tout - want).abs().max()) > 2e-5
    assert float((tlse - wlse).abs().max()) > 1e-5


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = _cuda_randn(cuda, 4, 64)
    with pytest.raises(TypeError):
        KL.layer_norm(x.double(), torch.ones(64, device=cuda).double(),
                      torch.zeros(64, device=cuda).double())
    with pytest.raises(ValueError):
        KL.layer_norm(x.t().contiguous().t(), torch.ones(64, device=cuda),
                      torch.zeros(64, device=cuda))
    q = _cuda_randn(cuda, 1, 1, 600, 64)
    with pytest.raises(ValueError):
        KA.sdpa_short(q, q, q, 0.125)       # T > 512
    q = _cuda_randn(cuda, 1, 1, 64, 32)
    with pytest.raises(ValueError):
        KA.flash_attention(q, q, q, 0.125)  # d 32


@pytest.mark.gpu
@pytest.mark.parametrize("n,v,eps,dtype", [
    (512, 32000, 0.1, torch.float32), (512, 32000, 0.0, torch.float32),
    (33, 1000, 0.1, torch.float32), (64, 32000, 0.1, torch.bfloat16),
    # rows off a 16-byte boundary (fp32 V % 4, bf16 V % 8), the MNIST
    # head, eight CTAs a row with the widest staged slices, and a row too
    # wide for them (the backward's streamed body)
    (64, 1001, 0.1, torch.float32), (64, 1003, 0.1, torch.bfloat16),
    (64, 10, 0.0, torch.float32), (64, 300000, 0.1, torch.float32),
    (64, 524288, 0.1, torch.float32),
    # the forward's plans on each side of its crossovers (csrc/xent.cu
    # `fwd_lanes`): a lane a row, groups of lanes, a warp a row, a block
    (64, 1, 0.0, torch.float32), (64, 31, 0.1, torch.bfloat16),
    (64, 32, 0.1, torch.float32), (64, 33, 0.1, torch.float32),
    (64, 4096, 0.1, torch.float32), (64, 4097, 0.1, torch.float32),
    (64, 8192, 0.1, torch.bfloat16), (64, 8193, 0.1, torch.bfloat16)])
def test_xent_kernels_match_plain(cuda, n, v, eps, dtype):
    x, lab, g = _xent_inputs(n, v, seed=20)
    lab[1] = v + 3  # out of range: picks 0, matches no column
    x = torch.from_numpy(x).to(cuda, dtype)
    lab, g = torch.from_numpy(lab).to(cuda), torch.from_numpy(g).to(cuda)
    before = KX.xent_forward.launches, KX.xent_backward.launches
    loss, lse = KX.xent_forward(x, lab, eps)
    dx = KX.xent_backward(x, lab, g, eps)
    torch.cuda.synchronize()
    assert (KX.xent_forward.launches, KX.xent_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    wloss, wlse = KX.xent_forward_plain(x, lab, eps)
    wdx = KX.xent_backward_plain(x, lab, g, eps)
    # fp32 sums over V in another order: 1e-5 on a loss of ~12
    torch.testing.assert_close(loss, wloss, rtol=0, atol=1e-5)
    torch.testing.assert_close(lse, wlse, rtol=0, atol=1e-5)
    assert dx.dtype == dtype
    # element by element, since most |dx| are ~1e-6 or below. fp32: lse
    # differs by ~1e-6 relative from the other sum order, and 1e-9
    # covers p - eps/V cancelling; bf16: the two roundings of a value
    # may fall an ulp (at most 2^-7 relative) apart
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(dx.float(), wdx.float(), rtol=rtol, atol=1e-9)
    assert (dx[lab == -100] == 0).all() and (loss[lab == -100] == 0).all()
    # the row's (max, sum) pairs merge in a fixed order: the same bits
    assert torch.equal(KX.xent_backward(x, lab, g, eps), dx)
    again = KX.xent_forward(x, lab, eps)
    assert torch.equal(again[0], loss) and torch.equal(again[1], lse)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_backward_logits_out_of_phase_with_dx(cuda, dtype):
    """Logits one row into a bigger tensor at V 1001 start 4 (fp32) or 2
    (bf16) bytes past a 16-byte boundary, the fresh dx on one: the
    backward writes such rows column by column."""
    x, lab, g = _xent_inputs(65, 1001, seed=21)
    x = torch.from_numpy(x).to(cuda, dtype)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    lab, g = torch.from_numpy(lab[1:]).to(cuda), torch.from_numpy(g[1:]).to(cuda)
    dx = KX.xent_backward(x, lab, g, 0.1)
    wdx = KX.xent_backward_plain(x, lab, g, 0.1)
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(dx.float(), wdx.float(), rtol=rtol, atol=1e-9)


# the backward kernels against their plain versions: fp32 sums over up to
# 1024 keys or queries in another order, about sqrt(n) roundings of the
# largest term, 2e-6 of the largest grad; the limit is 1e-5 of it. A
# planted fault (lse off by 1e-3) moves the grads by ~1e-3 of it.
BWD_RTOL = 1e-5


def _close_to_scale(got, want, rtol=BWD_RTOL):
    scale = float(want.abs().max())
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= rtol * scale, (
        float((got - want).abs().max()), scale)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,t,d,causal", [
    (2, 8, 512, 64, False), (2, 8, 512, 64, True), (1, 4, 300, 128, True),
    # ragged tiles, and T 13: odd rows of P, stored and read a float at
    # a time
    (1, 4, 264, 64, True), (1, 2, 300, 128, False), (1, 2, 13, 64, True),
    (2, 3, 13, 128, False)])
def test_sdpa_short_residual_and_bwd_kernels_match_plain(cuda, b, h, t, d,
                                                         causal):
    q, k, v, g = (_cuda_randn(cuda, b, h, t, d, seed=s)
                  for s in (7, 8, 9, 10))
    out, p = KA._sdpa_short_launch(q, k, v, d ** -0.5, causal, True)
    wout, wp = KA.sdpa_short_plain(q, k, v, d ** -0.5, causal, save_p=True)
    torch.testing.assert_close(out, wout, rtol=0, atol=2e-5)
    torch.testing.assert_close(p, wp, rtol=0, atol=1e-6)
    before = KA.sdpa_short_bwd.launches
    got = KA.sdpa_short_bwd(q, k, v, p, g, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert KA.sdpa_short_bwd.launches == before + 1
    for a, w in zip(got, KA.sdpa_short_bwd_plain(q, k, v, p, g, d ** -0.5)):
        _close_to_scale(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_short_kernels_repeat_and_beat_a_tf32_control(cuda, causal):
    """Both kernels run in split TF32 on the tensor cores. The forward:
    a second launch gives identical bits, with P and without, and the
    output without P is the output with P; the plain forward on
    TF32-rounded q, k, v fails the limits (2e-5 out, 1e-6 P) that the
    kernel passes. The backward: a second launch gives identical bits, and
    the plain backward on TF32-rounded q, k, v, P and dO fails the 1e-5
    limit that the kernel passes."""
    q, k, v, g = (_cuda_randn(cuda, 2, 8, 512, 64, seed=s)
                  for s in (14, 15, 16, 17))
    runs = [KA._sdpa_short_launch(q, k, v, 0.125, causal, True)
            for _ in range(2)]
    primal = [KA._sdpa_short_launch(q, k, v, 0.125, causal, False)
              for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert torch.equal(primal[0], primal[1])
    assert torch.equal(primal[0], runs[0][0])
    out, p = runs[0]
    want, wp = KA.sdpa_short_plain(q, k, v, 0.125, causal, save_p=True)
    assert float((out - want).abs().max()) <= 2e-5
    assert float((p - wp).abs().max()) <= 1e-6
    tout, tp = KA.sdpa_short_plain(_tf32(q), _tf32(k), _tf32(v), 0.125,
                                   causal, save_p=True)
    assert float((tout - want).abs().max()) > 2e-5
    assert float((tp - wp).abs().max()) > 1e-6

    grads = [KA.sdpa_short_bwd(q, k, v, p, g, 0.125, causal)
             for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*grads):
        assert torch.equal(a, b_)
    wgrads = KA.sdpa_short_bwd_plain(q, k, v, p, g, 0.125)
    for a, w in zip(grads[0], wgrads):
        _close_to_scale(a, w)
    tf32 = KA.sdpa_short_bwd_plain(*(_tf32(z) for z in (q, k, v, p, g)),
                                   0.125)
    assert max(float((a - w).abs().max()) / float(w.abs().max())
               for a, w in zip(tf32, wgrads)) > BWD_RTOL


@pytest.mark.gpu
def test_attention_wrappers_refuse_views_off_a_16_byte_boundary(cuda):
    """The forwards and backwards copy 16-byte rows with cp.async: a
    contiguous view that starts 4 bytes into its storage is refused before
    a launch, where the card would fault on it."""
    t, d = 64, 64
    q = _cuda_randn(cuda, 1, 1, t, d, seed=18)
    off = torch.empty(t * d + 1, device=cuda)[1:].view(1, 1, t, d)
    off.copy_(q)
    assert off.is_contiguous() and off.data_ptr() % 16
    p = torch.softmax(torch.zeros(1, t, t, device=cuda), -1)
    before = KA.sdpa_short.launches, KA.flash_attention.launches, \
        KA.sdpa_short_bwd.launches
    for call in (lambda: KA._sdpa_short_launch(off, q, q, 0.125, False,
                                               False),
                 lambda: KA._flash_attention_launch(q, q, off, 0.125, False,
                                                    False),
                 lambda: KA.sdpa_short_bwd(q, q, q, p, off, 0.125)):
        with pytest.raises(ValueError, match="16-byte"):
            call()
    assert (KA.sdpa_short.launches, KA.flash_attention.launches,
            KA.sdpa_short_bwd.launches) == before


FLASH_BWD_CASES = [
    (2, 8, 1024, 1024, 64, False), (2, 8, 1024, 1024, 64, True),
    (1, 4, 96, 1024, 64, True), (1, 2, 100, 40, 128, True),
    (1, 2, 600, 600, 256, True),
    # ragged tiles: a last key and query tile cut short, tq < tk by a
    # part tile, and tq > tk (rows that see no key) at D 128
    (1, 4, 600, 600, 64, False), (1, 4, 600, 600, 64, True),
    (1, 4, 1000, 1024, 64, True), (1, 2, 1024, 600, 128, True)]


def _flash_bwd_inputs(cuda, b, h, tq, tk, d, causal):
    q, g = (_cuda_randn(cuda, b, h, tq, d, seed=s) for s in (10, 13))
    k = _cuda_randn(cuda, b, h, tk, d, seed=11)
    v = _cuda_randn(cuda, b, h, tk, d, seed=12)
    return q, k, v, g


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal", FLASH_BWD_CASES)
def test_flash_residual_and_bwd_kernels_match_plain(cuda, b, h, tq, tk, d,
                                                    causal):
    q, k, v, g = _flash_bwd_inputs(cuda, b, h, tq, tk, d, causal)
    scale = d ** -0.5
    out, lse = KA._flash_attention_launch(q, k, v, scale, causal, True)
    wout, wlse = KA.flash_attention_plain(q, k, v, scale, causal,
                                          with_lse=True)
    torch.testing.assert_close(out, wout, rtol=0, atol=2e-5)
    torch.testing.assert_close(lse, wlse, rtol=1e-6, atol=1e-5)
    before = KA.flash_bwd_dq.launches, KA.flash_bwd_dkv.launches
    got = KA.flash_attention_bwd(q, k, v, out, lse, g, scale, causal)
    torch.cuda.synchronize()
    assert (KA.flash_bwd_dq.launches, KA.flash_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, w in zip(got, KA.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                      scale, causal)):
        _close_to_scale(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,causal", [
    (2, 8, 1024, 1024, 64, True), (1, 2, 1024, 600, 128, True),
    (1, 2, 600, 600, 256, False)])
def test_flash_bwd_kernels_are_deterministic(cuda, b, h, tq, tk, d, causal):
    """Each block writes only its own rows, with no atomics, in a fixed
    order: two launches on the same inputs give identical bits."""
    q, k, v, g = _flash_bwd_inputs(cuda, b, h, tq, tk, d, causal)
    scale = d ** -0.5
    out, lse = KA._flash_attention_launch(q, k, v, scale, causal, True)
    delta = KA.flash_delta(out, g)
    runs = [(KA.flash_bwd_dq(q, k, v, g, lse, delta, scale, causal),
             *KA.flash_bwd_dkv(q, k, v, g, lse, delta, scale, causal))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [384, 1024])
def test_attention_grad_on_the_card_matches_plain(cuda, t):
    """sdpa_short (256 < T <= 512) and flash (T > 512): the attention
    grad op on the card recomputes the forward kernel with its residual
    and launches the backward kernel(s); its grads equal the same grad
    op on the CPU, which takes the plain versions. The forward op, under
    no_grad as the Executor runs it, launches the primal kernel once."""
    import paddle_tpu_torch as pf
    from paddle_tpu_torch.core import registry

    prog = pf.Program()
    blk = prog.global_block
    for n in ("Q", "K", "V"):
        blk.create_var(name=n, shape=(1, t, 2, 64), dtype="float32")
    op = blk.append_op("attention", {"Q": "Q", "K": "K", "V": "V"},
                       {"Out": "O"}, {"causal": True, "scale": 0.125,
                                      "layout": "bthd"})
    (gop,) = registry.make_grad_ops(op)
    env = {n: _cuda_randn(cuda, 1, t, 2, 64, seed=i)
           for i, n in enumerate(("Q", "K", "V", "O@GRAD"))}
    cpu_env = {n: x.cpu() for n, x in env.items()}
    fwd = KA.sdpa_short if t <= 512 else KA.flash_attention
    bwd = (KA.sdpa_short_bwd,) if t <= 512 else (KA.flash_bwd_dq,
                                                 KA.flash_bwd_dkv)
    before = fwd.launches, [k.launches for k in bwd]
    with torch.no_grad():
        registry.run_op(op, env, cuda)
        torch.cuda.synchronize()
        assert fwd.launches == before[0] + 1
        registry.run_op(gop, env, cuda)
        registry.run_op(gop, cpu_env, torch.device("cpu"))
    torch.cuda.synchronize()
    assert fwd.launches == before[0] + 2
    assert [k.launches for k in bwd] == [n + 1 for n in before[1]]
    for n in ("Q@GRAD", "K@GRAD", "V@GRAD"):
        _close_to_scale(env[n].cpu(), cpu_env[n])


@pytest.mark.gpu
def test_layer_norm_grad_launches_no_kernel(cuda):
    """The layer_norm grad op takes the plain version's vjp on the card
    too: it launches no layer_norm kernel and agrees with the CPU."""
    import paddle_tpu_torch as pf
    from paddle_tpu_torch.core import registry

    prog = pf.Program()
    blk = prog.global_block
    blk.create_var(name="X", shape=(64, 512), dtype="float32")
    for n in ("S", "B"):
        blk.create_var(name=n, shape=(512,), dtype="float32")
    op = blk.append_op("layer_norm", {"X": "X", "Scale": "S", "Bias": "B"},
                       {"Y": "Y", "Mean": "M", "Variance": "V"},
                       {"epsilon": 1e-5, "begin_norm_axis": 1})
    (gop,) = registry.make_grad_ops(op)
    env = {"X": _cuda_randn(cuda, 64, 512, seed=4) * 3 + 0.5,
           "S": _cuda_randn(cuda, 512, seed=5),
           "B": _cuda_randn(cuda, 512, seed=6),
           "Y@GRAD": _cuda_randn(cuda, 64, 512, seed=7)}
    cpu_env = {n: t.cpu() for n, t in env.items()}
    gop.inputs["Mean@GRAD"] = gop.inputs["Variance@GRAD"] = \
        [registry.EMPTY_VAR]
    before = KL.layer_norm.launches
    with torch.no_grad():
        registry.run_op(gop, env, cuda)
        registry.run_op(gop, cpu_env, torch.device("cpu"))
    torch.cuda.synchronize()
    assert KL.layer_norm.launches == before
    for n in ("X@GRAD", "S@GRAD", "B@GRAD"):
        # fp32, sums over 512 columns or 64 rows in another order
        torch.testing.assert_close(env[n].cpu(), cpu_env[n], rtol=1e-5,
                                   atol=1e-5)


# the fused-block kernels against their plain versions: each output and
# grad within 1e-5 of its largest |plain| (BWD_RTOL; the products sum over
# up to B*T = 16384 rows in another order), saved P within 1e-6. Shapes:
# odd batches, heads of 16, 24, 32 and 64, widths that are not multiples
# of the 128-wide product tiles, and Transformer-base's width.
@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,h,causal", [
    (3, 16, 64, 2, True), (3, 8, 64, 4, False), (2, 72, 192, 8, True),
    (4, 256, 512, 8, True), (4, 256, 512, 8, False), (1, 512, 256, 2,
                                                       True),
    (1, 512, 512, 8, True), (2, 200, 256, 2, False)])
def test_attention_block_kernels_match_plain(cuda, b, t, d, h, causal):
    x, g = (_cuda_randn(cuda, b, t, d, seed=s) for s in (40, 41))
    wqkv = _cuda_randn(cuda, d, 3 * d, seed=42) / d ** 0.5
    wo = _cuda_randn(cuda, d, d, seed=43) / d ** 0.5
    scale = (d // h) ** -0.5
    before = KAB.attention_block.launches, KAB.attention_block_bwd.launches
    out, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal, True)
    primal = KAB.attention_block(x, wqkv, wo, h, scale, causal)
    got = KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
    torch.cuda.synchronize()
    assert (KAB.attention_block.launches,
            KAB.attention_block_bwd.launches) == (before[0] + 2,
                                                  before[1] + 1)
    wout, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale, causal,
                                             save_p=True)
    _close_to_scale(out, wout)
    torch.testing.assert_close(primal, out, rtol=0, atol=0)
    torch.testing.assert_close(p, wp, rtol=0, atol=1e-6)
    for a, w in zip(got, KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h,
                                                       scale)):
        _close_to_scale(a, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("t", [200, 512])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_fwd_across_head_widths(cuda, dh, t, causal):
    """The forward's attention stage runs Dh <= 64 on the flash body's
    D-64 instance and Dh <= 128 on its D-128 one, the columns past Dh
    zero-filled: out and P against the plain version at a ragged T and at
    T's limit; out is the same bits with P and without, and on a second
    launch."""
    b, h = 2, 2
    d = h * dh
    x = _cuda_randn(cuda, b, t, d, seed=60)
    wqkv = _cuda_randn(cuda, d, 3 * d, seed=61) / d ** 0.5
    wo = _cuda_randn(cuda, d, d, seed=62) / d ** 0.5
    scale = dh ** -0.5
    out, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal, True)
    out2, p2 = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                           True)
    primal = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal,
                                         False)
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(p, p2)
    assert torch.equal(primal, out)
    wout, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale, causal,
                                             save_p=True)
    _close_to_scale(out, wout)
    torch.testing.assert_close(p, wp, rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_fwd_beats_a_tf32_control_and_its_causal_flag(
        cuda, causal):
    """The forward runs in split TF32 on the tensor cores: the plain
    forward on TF32-rounded x, Wqkv and Wo fails the limits on out and P
    that the kernel passes; in the causal case, the kernel with the flag
    dropped fails them too."""
    b, t, d, h = 4, 256, 512, 8
    x = _cuda_randn(cuda, b, t, d, seed=63)
    wqkv = _cuda_randn(cuda, d, 3 * d, seed=64) / d ** 0.5
    wo = _cuda_randn(cuda, d, d, seed=65) / d ** 0.5
    scale = (d // h) ** -0.5
    out, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal, True)
    wout, wp = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale, causal,
                                             save_p=True)
    _close_to_scale(out, wout)
    torch.testing.assert_close(p, wp, rtol=0, atol=1e-6)
    tout, tp = KAB.attention_block_fwd_plain(
        *(_tf32(z) for z in (x, wqkv, wo)), h, scale, causal, save_p=True)
    assert float((tout - wout).abs().max()) > BWD_RTOL * float(
        wout.abs().max())
    assert float((tp - wp).abs().max()) > 1e-6
    if causal:
        bad = KAB._attention_block_launch(x, wqkv, wo, h, scale, False,
                                          False)
        assert float((bad - wout).abs().max()) > BWD_RTOL * float(
            wout.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_bwd_repeats_and_beats_a_tf32_control(cuda,
                                                              causal):
    """The backward runs in split TF32 on the tensor cores: a second launch
    gives identical bits, and the plain backward on TF32-rounded x, Wqkv,
    Wo, P and g fails the 1e-5 limit that the kernel passes."""
    b, t, d, h = 4, 256, 512, 8
    x, g = (_cuda_randn(cuda, b, t, d, seed=s) for s in (50, 51))
    wqkv = _cuda_randn(cuda, d, 3 * d, seed=52) / d ** 0.5
    wo = _cuda_randn(cuda, d, d, seed=53) / d ** 0.5
    scale = (d // h) ** -0.5
    _, p = KAB._attention_block_launch(x, wqkv, wo, h, scale, causal, True)
    runs = [KAB.attention_block_bwd(x, wqkv, wo, p, g, h, scale, causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    want = KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h, scale)
    for a, w in zip(runs[0], want):
        _close_to_scale(a, w)
    tf32 = KAB.attention_block_bwd_plain(
        *(_tf32(z) for z in (x, wqkv, wo, p, g)), h, scale)
    assert max(float((a - w).abs().max()) / float(w.abs().max())
               for a, w in zip(tf32, want)) > BWD_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("t,causal", [(13, True), (20, False)])
def test_attention_block_bwd_c_entry_takes_any_t(cuda, t, causal):
    """The C entry takes any T <= 512, which the wrapper (T % 8 == 0)
    never passes: at T 13 the rows of P are not 16-byte aligned and the
    products copy them 4 bytes at a time; at T 20 the tiles are ragged."""
    b, d, h = 2, 64, 2
    x, g = (_cuda_randn(cuda, b, t, d, seed=s) for s in (54, 55))
    wqkv = _cuda_randn(cuda, d, 3 * d, seed=56) / d ** 0.5
    wo = _cuda_randn(cuda, d, d, seed=57) / d ** 0.5
    scale = (d // h) ** -0.5
    _, p = KAB.attention_block_fwd_plain(x, wqkv, wo, h, scale, causal,
                                         save_p=True)
    got = [torch.empty_like(z) for z in (x, wqkv, wo)]
    scratch = [x.new_empty(b * t, 3 * d), x.new_empty(b * t, d),
               x.new_empty(b * t, d), x.new_empty(b * t, 3 * d),
               x.new_empty(b * h, t), x.new_empty(KAB.WORKSPACE_FLOATS)]
    err = KAB._kernel("attention_block_bwd", 14, True)(
        *(z.data_ptr() for z in (x, wqkv, wo, p, g, *got, *scratch)),
        KAB.WORKSPACE_FLOATS, b, t, d, h, scale, int(causal),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for a, w in zip(got, KAB.attention_block_bwd_plain(x, wqkv, wo, p, g, h,
                                                       scale)):
        _close_to_scale(a, w)


def _ffn_bwd_pinned(x, w1, b1, w2, g):
    """The plain FFN backward with its ReLU mask pinned to the one the
    backward kernel's split-TF32 recompute took, after checking that they
    differ only at units within rounding of zero (1e-5 of the largest
    |pre-activation|, float64): the two round the pre-activation
    differently, and one unit that takes the other mask moves the grads
    below it by ~1e-2 of their largest. The kernel's mask comes through
    its C entry, whose scratch hidden ends as dh = (g W2^T)[mask] (no
    element of g W2^T is 0 at these random inputs)."""
    d, f = w1.shape
    n = x.numel() // d
    h = x.new_empty(n, f)
    ws = x.new_empty(max(KFF.WORKSPACE_FLOATS, f))
    grads = [torch.empty_like(z) for z in (x, w1, b1, w2)] + [x.new_empty(d)]
    assert KFF._kernel("ffn_block_bwd", 12, True)(
        *(z.data_ptr() for z in (x, w1, b1, w2, g, *grads, h, ws)),
        ws.numel(), n, d, f, torch.cuda.current_stream().cuda_stream) == 0
    x2, g2 = x.reshape(n, d), g.reshape(n, d)
    mask = h != 0
    pre = x2.double() @ w1.double() + b1.double()
    flips = mask != (x2 @ w1 + b1 > 0)
    if bool(flips.any()):
        assert float(pre[flips].abs().max()) <= BWD_RTOL * float(
            pre.abs().max())
    dh = torch.where(mask, g2 @ w2.T, 0.0)
    return ((dh @ w1.T).reshape(x.shape), x2.T @ dh, dh.sum(0),
            torch.relu(x2 @ w1 + b1).T @ g2, g2.sum(0))


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,f", [
    (3, 16, 64, 96), (2, 40, 24, 40), (64, 256, 512, 2048),
    (4, 64, 512, 1000)])   # F not a multiple of the 128-wide tiles
def test_ffn_block_kernels_match_plain(cuda, b, t, d, f):
    x, g = (_cuda_randn(cuda, b, t, d, seed=s) for s in (44, 45))
    w1 = _cuda_randn(cuda, d, f, seed=46) / d ** 0.5
    b1 = _cuda_randn(cuda, f, seed=47) * 0.1
    w2 = _cuda_randn(cuda, f, d, seed=48) / f ** 0.5
    b2 = _cuda_randn(cuda, d, seed=49) * 0.1
    before = KFF.ffn_block.launches, KFF.ffn_block_bwd.launches
    out = KFF.ffn_block(x, w1, b1, w2, b2)
    got = KFF.ffn_block_bwd(x, w1, b1, w2, g)
    torch.cuda.synchronize()
    assert (KFF.ffn_block.launches, KFF.ffn_block_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _close_to_scale(out, KFF.ffn_block_plain(x, w1, b1, w2, b2))
    for a, w in zip(got, _ffn_bwd_pinned(x, w1, b1, w2, g)):
        _close_to_scale(a, w)


@pytest.mark.gpu
def test_ffn_block_bwd_repeats_and_beats_a_tf32_control(cuda):
    """The backward runs its five products in split TF32 on the tensor
    cores: a second launch gives identical bits, and the plain backward on
    TF32-rounded x, W1, b1, W2 and g fails the 1e-5 limit that the kernel
    passes."""
    b, t, d, f = 8, 256, 512, 2048
    x, g = (_cuda_randn(cuda, b, t, d, seed=s) for s in (66, 67))
    w1 = _cuda_randn(cuda, d, f, seed=68) / d ** 0.5
    b1 = _cuda_randn(cuda, f, seed=69) * 0.1
    w2 = _cuda_randn(cuda, f, d, seed=70) / f ** 0.5
    runs = [KFF.ffn_block_bwd(x, w1, b1, w2, g) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)
    want = _ffn_bwd_pinned(x, w1, b1, w2, g)
    for a, w in zip(runs[0], want):
        _close_to_scale(a, w)
    tf32 = KFF.ffn_block_bwd_plain(*(_tf32(z) for z in (x, w1, b1, w2, g)))
    assert max(float((a - w).abs().max()) / float(w.abs().max())
               for a, w in zip(tf32, want)) > BWD_RTOL


@pytest.mark.gpu
def test_ffn_block_fwd_repeats_and_beats_a_tf32_control(cuda):
    """The forward runs both products in split TF32 on the tensor cores: a
    second launch gives identical bits, and the plain forward on
    TF32-rounded x, W1, b1, W2 and b2 fails the 1e-5 limit that the
    kernel passes."""
    b, t, d, f = 8, 256, 512, 2048
    x = _cuda_randn(cuda, b, t, d, seed=71)
    w1 = _cuda_randn(cuda, d, f, seed=72) / d ** 0.5
    b1 = _cuda_randn(cuda, f, seed=73) * 0.1
    w2 = _cuda_randn(cuda, f, d, seed=74) / f ** 0.5
    b2 = _cuda_randn(cuda, d, seed=75) * 0.1
    runs = [KFF.ffn_block(x, w1, b1, w2, b2) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)
    want = KFF.ffn_block_plain(x, w1, b1, w2, b2)
    _close_to_scale(runs[0], want)
    tf32 = KFF.ffn_block_plain(*(_tf32(z) for z in (x, w1, b1, w2, b2)))
    assert float((tf32 - want).abs().max()) > BWD_RTOL * float(
        want.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,f", [(64, 256, 512, 2048),
                                     (4, 64, 512, 1000)])
def test_ffn_block_fwd_hidden_is_the_bwd_recompute(cuda, b, t, d, f):
    """The forward's hidden and the backward's recompute run one code path:
    no ReLU unit takes one mask in the forward (its scratch hidden h > 0)
    and the other in the backward (its scratch dh = (g W2^T)[mask] under a
    cotangent of ones, nonzero wherever the mask is on since no row of W2
    sums to 0), through the C entries."""
    n = b * t
    x = _cuda_randn(cuda, n, d, seed=76)
    w1 = _cuda_randn(cuda, d, f, seed=77) / d ** 0.5
    b1 = _cuda_randn(cuda, f, seed=78) * 0.1
    w2 = _cuda_randn(cuda, f, d, seed=79) / f ** 0.5
    assert float(w2.double().sum(1).abs().min()) > 1e-5
    stream = torch.cuda.current_stream().cuda_stream
    h = x.new_empty(n, f)
    assert KFF._kernel("ffn_block_fwd", 7, False)(
        *(z.data_ptr() for z in (x, w1, b1, w2, x.new_zeros(d),
                                 torch.empty_like(x), h)),
        n, d, f, stream) == 0
    dh = x.new_empty(n, f)
    ws = x.new_empty(max(KFF.WORKSPACE_FLOATS, f))
    grads = [torch.empty_like(z) for z in (x, w1, b1, w2)] + [x.new_empty(d)]
    assert KFF._kernel("ffn_block_bwd", 12, True)(
        *(z.data_ptr() for z in (x, w1, b1, w2, torch.ones_like(x), *grads,
                                 dh, ws)),
        ws.numel(), n, d, f, stream) == 0
    torch.cuda.synchronize()
    assert int(((h > 0) != (dh != 0)).sum()) == 0


@pytest.mark.gpu
def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = _cuda_randn(cuda, 2, 16, 512)
    w = _cuda_randn(cuda, 512, 1536)
    wo = _cuda_randn(cuda, 512, 512)
    with pytest.raises(ValueError):
        KAB.attention_block(x, w, wo, 2, 0.1)       # head width 256
    with pytest.raises(TypeError):
        KAB.attention_block(x.double(), w.double(), wo.double(), 8, 0.1)
    with pytest.raises(ValueError):
        KFF.ffn_block(x, w, _cuda_randn(cuda, 1536), w.t().contiguous(),
                      _cuda_randn(cuda, 256))       # b2 of the wrong width


@pytest.mark.gpu
@pytest.mark.parametrize("block", ["attention_block", "ffn_block"])
def test_fused_grad_ops_on_the_card_match_the_cpu(cuda, block):
    """The fused op and its grad op as the Executor runs them on the card:
    the forward op launches the forward kernel once; the grad op
    recomputes it (attention_block: saving P) and launches the backward
    kernel once; the grads equal the same grad op on the CPU, which takes
    the plain versions."""
    import paddle_tpu_torch as pf
    from paddle_tpu_torch.core import registry

    b, t, d, f = 4, 64, 128, 256
    if block == "attention_block":
        shapes = {"X": (b, t, d), "WQKV": (d, 3 * d), "WO": (d, d)}
        attrs = {"n_heads": 4, "scale": 32 ** -0.5, "causal": True}
        kern = (KAB.attention_block, KAB.attention_block_bwd)
    else:
        shapes = {"X": (b, t, d), "W1": (d, f), "B1": (f,), "W2": (f, d),
                  "B2": (d,)}
        attrs = {}
        kern = (KFF.ffn_block, KFF.ffn_block_bwd)
    blk = pf.Program().global_block
    for n, shape in shapes.items():
        blk.create_var(name=n, shape=shape, dtype="float32")
    op = blk.append_op(block, {n: n for n in shapes}, {"Out": "Out"}, attrs)
    (gop,) = registry.make_grad_ops(op)
    env = {n: _cuda_randn(cuda, *shape, seed=i) / (shape[0] ** 0.5
                                                   if len(shape) == 2 else 1)
           for i, (n, shape) in enumerate(shapes.items())}
    env["Out@GRAD"] = _cuda_randn(cuda, b, t, d, seed=9)
    cpu_env = {n: x.cpu() for n, x in env.items()}
    before = [k.launches for k in kern]
    with torch.no_grad():
        registry.run_op(op, env, cuda)
        torch.cuda.synchronize()
        assert [k.launches for k in kern] == [before[0] + 1, before[1]]
        registry.run_op(gop, env, cuda)
        registry.run_op(gop, cpu_env, torch.device("cpu"))
    torch.cuda.synchronize()
    assert [k.launches for k in kern] == [before[0] + 2, before[1] + 1]
    for n in shapes:
        _close_to_scale(env[n + "@GRAD"].cpu(), cpu_env[n + "@GRAD"])


def _paged_steps(rng, kind, r, bs, t):
    """Lane steps: "spread", random over the buffer with the first lane at
    -1 (the uniform average) and the last at T - 1; "boundary", every lane
    on a page boundary, the first cell of a page or the last, from 0 to
    T - 1; "first", the first lane at -1, the others inside the kernel's
    first chunk of 64 positions (0, 4, 8, ...)."""
    if kind == "boundary":
        return np.array([min(t - 1, bs * i - i % 2) for i in range(r)])
    if kind == "first":
        return np.array([-1] + [min(t - 1, 4 * i) for i in range(r - 1)])
    steps = rng.randint(0, t, size=r)
    steps[0], steps[-1] = -1, t - 1
    return steps


@pytest.mark.gpu
@pytest.mark.parametrize("r,h,d,bs,np_pages,nb,kind", [
    (3, 2, 16, 8, 4, 16, "spread"),        # the CPU tests' shape
    (5, 4, 128, 16, 8, 48, "spread"),      # Dh 128
    (17, 8, 64, 16, 16, 256, "spread"),    # the paged serving shape
    (4, 2, 40, 8, 4, 16, "spread"),        # Dh not a multiple of 32
    (1, 8, 64, 16, 64, 80, "spread"),      # one lane, T 1024: R*H = 8
    (2, 8, 64, 16, 64, 160, "spread"),     # step -1 over T 1024
    (3, 2, 256, 16, 8, 32, "spread"),      # Dh 256
    (17, 8, 64, 16, 16, 256, "boundary"),  # steps on page boundaries
    (17, 8, 64, 16, 16, 256, "first"),     # steps inside the first chunk
])
def test_paged_attention_kernel_matches_plain(cuda, r, h, d, bs, np_pages,
                                              nb, kind):
    """Kernel #9 against its plain version: lanes at steps spread over
    the buffer (one lane at step -1, the uniform average over its cells)
    or on page boundaries or inside the first chunk, tables sharing no
    block with unallocated pages at block 0; one lane alone with a long
    context. A second launch gives identical bits."""
    from paddle_tpu_torch.ops.kernels import paged_attention as KPA

    rng = np.random.RandomState(r + d)
    t = np_pages * bs
    steps = _paged_steps(rng, kind, r, bs, t)
    tab = np.zeros((r, np_pages), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for i, st in enumerate(steps):
        used = np_pages if st < 0 else st // bs + 1
        for p in range(min(used, len(free))):
            tab[i, p] = free.pop()
    q = _cuda_randn(cuda, r, h, d, seed=1)
    pk = _cuda_randn(cuda, nb, bs, h, d, seed=2)
    pv = _cuda_randn(cuda, nb, bs, h, d, seed=3)
    tab_t = torch.from_numpy(tab).to(cuda)
    step_t = torch.from_numpy(steps).to(cuda)
    before = KPA.paged_decode_attention.launches
    got = KPA.paged_decode_attention(q, pk, pv, tab_t, step_t, d ** -0.5)
    again = KPA.paged_decode_attention(q, pk, pv, tab_t, step_t, d ** -0.5)
    torch.cuda.synchronize()
    assert KPA.paged_decode_attention.launches == before + 2
    assert torch.equal(got, again)
    want = KPA.paged_decode_attention_plain(q, pk, pv, tab_t, step_t,
                                            d ** -0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="no kernel"):
        KPA.paged_decode_attention(q, pk[:, :4].contiguous(),
                                   pv[:, :4].contiguous(), tab_t, step_t)
    # a pool view off a 16-byte boundary is refused before a launch
    off = torch.empty(pk.numel() + 1, device=cuda)[1:].view(pk.shape)
    off.copy_(pk)
    with pytest.raises(ValueError, match="16-byte"):
        KPA.paged_decode_attention(q, off, pv, tab_t, step_t)
    assert KPA.paged_decode_attention.launches == before + 2


# ---------------------------------------------------------------------------
# bf16 (AMP) contracts of the attention kernels #2-#6
# ---------------------------------------------------------------------------
# Both the kernel and its plain version compute in fp32 from the same bf16
# inputs and round the result to bf16 once, so they differ by at most one
# bf16 ulp of an element, at most one ulp of the largest |plain| (2^-8 to
# 2^-7 of it, by where it lies in its binade; 2^-8 of the largest alone,
# the gate's former measure, is less than that ulp whenever the largest
# lies below the next power of two), and only where their fp32
# values straddle a rounding boundary: in few elements. An fp32
# intermediate fed to a product as a single bf16 term (P in P v, dS in dS
# k) moves the fp32 values by ~2^-9 relative before the rounding, so a
# share of the elements of that order differs.
BF16_SHARE = 0.05


def _bf16_gate(got, want):
    """(max |got - want| in bf16 ulps of the largest |want|, the share of
    elements whose values differ)."""
    g, w = got.float(), want.float()
    top = float(w.abs().max())
    ulp = 2.0 ** (math.frexp(top)[1] - 8) if top > 0 else 2.0 ** -133
    return (float((g - w).abs().max()) / ulp,
            float((g != w).float().mean()))


def _bf16_passes(got, want):
    ulps, share = _bf16_gate(got, want)
    return bool(torch.isfinite(got.float()).all()) and ulps <= 1.0 \
        and share <= BF16_SHARE


def test_bf16_gate_is_one_ulp_of_the_largest():
    """The #2-#6 gate's measure: a largest element one rounding apart
    (0.44921875 against 0.447265625, as #4's dv read on the card: one
    ulp, above 2^-8 of the largest), passes; two ulps fail; one ulp in
    more than 5% of the elements fails."""
    want = torch.tensor([0.447265625] + [0.25] * 99, dtype=torch.bfloat16)
    got = want.clone()
    got[0] = 0.44921875
    assert float(got[0] - want[0]) > 2 ** -8 * 0.447265625
    assert _bf16_passes(got, want), _bf16_gate(got, want)
    got[0] = 0.451171875
    assert not _bf16_passes(got, want), _bf16_gate(got, want)
    many = want.clone()
    many.view(torch.int16)[::10] += 1
    assert _bf16_gate(many, want)[0] <= 1.0
    assert not _bf16_passes(many, want)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _attention_f64(q, k, v, scale, causal):
    """The attention function in float64 (masked scores at finfo.min)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * scale
    if causal:
        keep = K.causal_keep(*s.shape[-2:], s.device)
        s = s.masked_fill(~keep, torch.finfo(s.dtype).min)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())


def _sdpa_bwd_f64(q, k, v, p, g, scale, single_bf16_ds=False):
    """`sdpa_short_bwd_plain` in float64 from the same P; with
    `single_bf16_ds` dS is rounded to one bf16 term before its products,
    the control of a kernel that did not split it."""
    q, k, v, p, g = (x.double() for x in (q, k, v, p, g))
    p = p.reshape(*q.shape[:2], *p.shape[-2:])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if single_bf16_ds:
        ds = ds.to(torch.bfloat16).double()
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale, dv)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_short_bf16_plain_matches_pallas_interpret(jax_ref, causal):
    """#5 and #6 in bf16: the Pallas kernels in interpret mode on bf16
    q, k, v and dO, their P saved in bf16; the port's plain versions on
    the same bf16 values give bf16 outputs and a bf16 P, each within one
    bf16 rounding of the kernel's."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import attention as jattn

    q, k, v, g = (_randn(1, 8, 264, 64, seed=30 + i) for i in range(4))
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jnp.bfloat16)
                      for x in (q, k, v, g))
    jattn.force_interpret(True)
    try:
        out, p = jattn._sdpa_short_fwd_impl(jq, jk, jv, 0.125, causal,
                                            save_p=True)
        grads = jattn._sdpa_short_bwd_impl(jq, jk, jv, p, jg, 0.125,
                                           causal)
    finally:
        jattn.force_interpret(False)
    tq, tk, tv, tg = map(_bf16, (q, k, v, g))
    got, tp = KA.sdpa_short_plain(tq, tk, tv, 0.125, causal, save_p=True)
    assert got.dtype == tp.dtype == torch.bfloat16
    assert tp.shape == (8, 264, 264)
    for a, w in ((got, out), (tp, p)):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert _bf16_passes(a, w), _bf16_gate(a, w)
    wp = _bf16(np.asarray(p.astype(jnp.float32)))
    mine = KA.sdpa_short_bwd_plain(tq, tk, tv, wp, tg, 0.125, causal)
    for name, a, w in zip(("dq", "dk", "dv"), mine, grads):
        assert a.dtype == torch.bfloat16, name
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert _bf16_passes(a, w), (name, _bf16_gate(a, w))


@pytest.mark.parametrize("tq,tk,causal", [(64, 64, False), (64, 64, True),
                                          (32, 64, True)])
def test_flash_bf16_plain_matches_pallas_interpret(jax_ref, tq, tk, causal):
    """#2-#4 in bf16: output, fp32 lse and the grads from the same
    (q, k, v, out, lse, dO) against `_flash_fwd_impl` and
    `_flash_bwd_impl` in interpret mode on bf16 inputs."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import attention as jattn

    q, g = _randn(1, 2, tq, 64, seed=40), _randn(1, 2, tq, 64, seed=41)
    k, v = _randn(1, 2, tk, 64, seed=42), _randn(1, 2, tk, 64, seed=43)
    jq, jk, jv, jg = (jnp.asarray(x, dtype=jnp.bfloat16)
                      for x in (q, k, v, g))
    jattn.force_interpret(True)
    try:
        out, lse = jattn._flash_fwd_impl(jq, jk, jv, 0.125, causal)
        want = jattn._flash_bwd_impl(jq, jk, jv, out, lse, jg, 0.125,
                                     causal)
    finally:
        jattn.force_interpret(False)
    tq_, tk_, tv_, tg_ = map(_bf16, (q, k, v, g))
    got, glse = KA.flash_attention_plain(tq_, tk_, tv_, 0.125, causal,
                                         with_lse=True)
    assert got.dtype == torch.bfloat16 and glse.dtype == torch.float32
    wout = torch.from_numpy(np.asarray(out.astype(jnp.float32)))
    assert _bf16_passes(got, wout), _bf16_gate(got, wout)
    np.testing.assert_allclose(glse.numpy(), np.asarray(lse), rtol=0,
                               atol=ATOL)
    mine = KA.flash_attention_bwd_plain(
        tq_, tk_, tv_, _bf16(np.asarray(out.astype(jnp.float32))),
        torch.from_numpy(np.asarray(lse)), tg_, 0.125, causal)
    for name, a, w in zip(("dq", "dk", "dv"), mine, want):
        assert a.dtype == torch.bfloat16, name
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert _bf16_passes(a, w), (name, _bf16_gate(a, w))


def test_bf16_launch_raises_when_the_kernels_cannot_be_built(monkeypatch):
    """A bf16 launch takes no plain path when its kernel is missing: with
    the build failing, each launch function raises before any launch."""
    from paddle_tpu_torch.ops.kernels import build

    def fail(name):
        raise RuntimeError("CUDA kernel build failed: (stand-in)")

    monkeypatch.setattr(build, "library", fail)
    KA._kernel.cache_clear()
    q = torch.zeros(1, 1, 300, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 1, 300)
    p = torch.zeros(1, 300, 300, dtype=torch.bfloat16)
    before = [w.launches for w in (KA.sdpa_short, KA.sdpa_short_bwd,
                                   KA.flash_attention, KA.flash_bwd_dq,
                                   KA.flash_bwd_dkv)]
    calls = [lambda: KA._sdpa_short_launch(q, q, q, 0.125, True, True),
             lambda: KA._flash_attention_launch(q, q, q, 0.125, True, True),
             lambda: KA._sdpa_short_bwd_launch(q, q, q, p, q, 0.125, True),
             lambda: KA._flash_bwd_dq_launch(q, q, q, q, lse, lse, 0.125,
                                             True),
             lambda: KA._flash_bwd_dkv_launch(q, q, q, q, lse, lse, 0.125,
                                              True)]
    try:
        for call in calls:
            with pytest.raises(RuntimeError, match="build failed"):
                call()
    finally:
        KA._kernel.cache_clear()
    assert [w.launches for w in (KA.sdpa_short, KA.sdpa_short_bwd,
                                 KA.flash_attention, KA.flash_bwd_dq,
                                 KA.flash_bwd_dkv)] == before


BF16_FWD_CASES = [
    ("sdpa_short", 2, 8, 512, 512, 64, False),
    ("sdpa_short", 2, 8, 512, 512, 64, True),
    ("sdpa_short", 1, 4, 300, 300, 128, True),
    ("sdpa_short", 1, 2, 13, 13, 64, True),
    ("flash", 2, 8, 1024, 1024, 64, False),
    ("flash", 2, 8, 1024, 1024, 64, True),
    ("flash", 1, 4, 96, 1024, 64, True),
    ("flash", 1, 2, 100, 40, 128, True),
    ("flash", 1, 2, 600, 600, 256, True),
    ("flash", 1, 4, 1000, 1024, 64, True),
    # ragged T and d 128 on #2's and #6's wgmma design: P's rows by TMA at
    # T 264, gathered by the producer warp at 300 and 13
    ("sdpa_short", 1, 4, 264, 264, 64, False),
    ("sdpa_short", 1, 4, 300, 300, 64, False),
    ("sdpa_short", 1, 4, 264, 264, 128, True),
    ("sdpa_short", 1, 4, 300, 300, 128, False),
    ("flash", 1, 4, 300, 264, 64, False),
    ("flash", 1, 4, 264, 300, 128, False),
    ("flash", 1, 4, 300, 300, 128, True),
    ("flash", 1, 2, 200, 72, 64, True),  # fully masked rows
    # odd tq: #4's lse and delta rows lie off 16 bytes and are gathered by
    # its producer warp
    ("flash", 1, 4, 301, 264, 64, True),
    ("flash", 1, 4, 257, 300, 128, False),
    # #3 on wgmma: an odd tq with rows that see no key at d 128, and a tq
    # whose second warpgroup's rows all lie past it
    ("flash", 1, 4, 333, 200, 128, True),
    ("flash", 1, 2, 40, 300, 64, False)]


def _bf16_inputs(cuda, b, h, tq, tk, d):
    q, g = (_cuda_randn(cuda, b, h, tq, d, seed=s, dtype=torch.bfloat16)
            for s in (50, 53))
    k, v = (_cuda_randn(cuda, b, h, tk, d, seed=s, dtype=torch.bfloat16)
            for s in (51, 52))
    return q, k, v, g


@pytest.mark.gpu
@pytest.mark.parametrize("kind,b,h,tq,tk,d,causal", BF16_FWD_CASES)
def test_bf16_attention_kernels_match_plain(cuda, kind, b, h, tq, tk, d,
                                            causal):
    """#2-#6 on bf16 q, k, v and dO: outputs, P and grads in bf16, lse in
    fp32; each within one bf16 rounding of its plain version in few
    elements, no further from a float64 oracle than twice the plain
    version is, and the same bits on a second launch; the launch counters
    move by one a call."""
    q, k, v, g = _bf16_inputs(cuda, b, h, tq, tk, d)
    scale = d ** -0.5
    if kind == "sdpa_short":
        fwd, bwd = KA.sdpa_short, (KA.sdpa_short_bwd,)
        before = fwd.launches, [w.launches for w in bwd]
        runs = [KA._sdpa_short_launch(q, k, v, scale, causal, True)
                for _ in range(2)]
        out, res = runs[0]
        wout, wres = KA.sdpa_short_plain(q, k, v, scale, causal,
                                         save_p=True)
        grads = [KA.sdpa_short_bwd(q, k, v, res, g, scale, causal)
                 for _ in range(2)]
        wgrads = KA.sdpa_short_bwd_plain(q, k, v, res, g, scale, causal)
        f64 = _sdpa_bwd_f64(q, k, v, res, g, scale)
        assert res.dtype == torch.bfloat16 and _bf16_passes(res, wres), \
            _bf16_gate(res, wres)
    else:
        fwd, bwd = KA.flash_attention, (KA.flash_bwd_dq, KA.flash_bwd_dkv)
        before = fwd.launches, [w.launches for w in bwd]
        runs = [KA._flash_attention_launch(q, k, v, scale, causal, True)
                for _ in range(2)]
        out, res = runs[0]
        wout, wres = KA.flash_attention_plain(q, k, v, scale, causal,
                                              with_lse=True)
        grads = [KA.flash_attention_bwd(q, k, v, out, res, g, scale, causal)
                 for _ in range(2)]
        wgrads = KA.flash_attention_bwd_plain(q, k, v, out, res, g, scale,
                                              causal)
        qr, kr, vr = (x.double().requires_grad_() for x in (q, k, v))
        f64 = torch.autograd.grad(_attention_f64(qr, kr, vr, scale, causal),
                                  (qr, kr, vr), g.double())
        assert res.dtype == torch.float32
        torch.testing.assert_close(res, wres, rtol=1e-6, atol=1e-5)
    torch.cuda.synchronize()
    assert fwd.launches == before[0] + 2
    assert [w.launches for w in bwd] == [n + 2 for n in before[1]]
    assert out.dtype == torch.bfloat16
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert _bf16_passes(out, wout), _bf16_gate(out, wout)
    oracle = _attention_f64(q, k, v, scale, causal)
    assert max_err_f64(out, oracle) <= 2 * max_err_f64(wout, oracle)
    for name, a, a2, w, o in zip(("dq", "dk", "dv"), grads[0], grads[1],
                                 wgrads, f64):
        assert a.dtype == torch.bfloat16, name
        assert torch.equal(a, a2), name
        assert _bf16_passes(a, w), (name, _bf16_gate(a, w))
        assert max_err_f64(a, o) <= 2 * max_err_f64(w, o), name


def max_err_f64(a, b):
    return float((a.double() - b.double()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_bf16_attention_kernels_fail_planted_faults(cuda, causal):
    """The bf16 gate catches what it is for: the flash backward fed an lse
    off by 1e-2, either forward or backward launched with the causal flag
    dropped (causal cases), #6's dS taken as a single bf16 term (the
    plain version so computed, against the float64 oracle), #4's design
    with P^T fed to dv as one bf16 term, #3's with dS fed to dq as one
    bf16 term and #5's with P normalized by the running max
    (`flash_bwd_dkv_tiles_plain(p_terms=1)`,
    `flash_bwd_dq_tiles_plain(ds_terms=1)`,
    `sdpa_short_tiles_plain(p_max="running")`)."""
    q, k, v, g = _bf16_inputs(cuda, 2, 8, 1024, 1024, 64)
    out, lse = KA._flash_attention_launch(q, k, v, 0.125, causal, True)
    want = KA.flash_attention_bwd_plain(q, k, v, out, lse, g, 0.125, causal)
    bad = KA.flash_attention_bwd(q, k, v, out, lse + 1e-2, g, 0.125, causal)
    assert not all(_bf16_passes(a, w) for a, w in zip(bad, want))
    delta = KA.flash_delta(out, g)
    _, dv1 = KA.flash_bwd_dkv_tiles_plain(q, k, v, g, lse, delta, 0.125,
                                          causal, p_terms=1)
    assert not _bf16_passes(dv1, want[2]), _bf16_gate(dv1, want[2])
    dq1 = KA.flash_bwd_dq_tiles_plain(q, k, v, g, lse, delta, 0.125, causal,
                                      ds_terms=1)
    assert not _bf16_passes(dq1, want[0]), _bf16_gate(dq1, want[0])
    if causal:
        wout = KA.flash_attention_plain(q, k, v, 0.125, True)
        assert not _bf16_passes(KA.flash_attention(q, k, v, 0.125, False),
                                wout)
        bad = KA.flash_attention_bwd(q, k, v, out, lse, g, 0.125, False)
        assert not all(_bf16_passes(a, w) for a, w in zip(bad, want))
    q, k, v, g = _bf16_inputs(cuda, 2, 8, 512, 512, 64)
    _, p = KA._sdpa_short_launch(q, k, v, 0.125, causal, True)
    _, wp = KA.sdpa_short_plain(q, k, v, 0.125, causal, save_p=True)
    _, p1 = KA.sdpa_short_tiles_plain(q, k, v, 0.125, causal,
                                      p_max="running")
    assert _bf16_passes(p, wp) and not _bf16_passes(p1, wp), \
        _bf16_gate(p1, wp)
    want = KA.sdpa_short_bwd_plain(q, k, v, p, g, 0.125, causal)
    single = [x.to(torch.bfloat16) for x in _sdpa_bwd_f64(
        q, k, v, p, g, 0.125, single_bf16_ds=True)]
    assert not all(_bf16_passes(a, w) for a, w in zip(single[:2],
                                                      want[:2]))
    if causal:
        bad = KA.sdpa_short_bwd(q, k, v, p, g, 0.125, False)
        got = KA.sdpa_short_bwd(q, k, v, p, g, 0.125, True)
        assert all(_bf16_passes(a, w) for a, w in zip(got, want))
        # the flag only skips tiles where P is 0: the same grads
        assert all(_bf16_passes(a, w) for a, w in zip(bad, want))


@pytest.mark.gpu
def test_bf16_routed_attention_launches_the_kernel(cuda, monkeypatch):
    """The attention op on bf16 q, k, v at T 384 (sdpa_short) and 1024
    (flash) launches the bf16 kernel, never the plain composition; with
    the kernels' build failing it raises."""
    import paddle_tpu_torch as pf
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops.kernels import build

    for t, wrapper in ((384, KA.sdpa_short), (1024, KA.flash_attention)):
        blk = pf.Program().global_block
        for n in ("Q", "K", "V"):
            blk.create_var(name=n, shape=(1, t, 2, 64), dtype="bfloat16")
        op = blk.append_op("attention", {"Q": "Q", "K": "K", "V": "V"},
                           {"Out": "O"}, {"causal": True, "scale": 0.125,
                                          "layout": "bthd"})
        env = {n: _cuda_randn(cuda, 1, t, 2, 64, seed=i,
                              dtype=torch.bfloat16)
               for i, n in enumerate(("Q", "K", "V"))}
        before = wrapper.launches
        with torch.no_grad():
            registry.run_op(op, env, cuda)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert env["O"].dtype == torch.bfloat16
        want = KA.flash_attention_plain(
            *(env[n].transpose(1, 2) for n in ("Q", "K", "V")), 0.125, True)
        assert _bf16_passes(env["O"].transpose(1, 2), want)
    monkeypatch.setattr(build, "library", lambda name: (_ for _ in ()).throw(
        RuntimeError("CUDA kernel build failed: (stand-in)")))
    KA._kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="build failed"):
            with torch.no_grad():
                registry.run_op(op, env, cuda)
    finally:
        KA._kernel.cache_clear()
