"""#1 (layer_norm) on the CPU: the kernel's row plan (``ln_plan``) at
every shape the port runs it at, at aligned and odd offsets and over a
sweep of D; the plain version against the JAX package's ``_ln_ref`` at
the decoder-step shapes; the planted faults that the card's gates must
fail. The kernel itself runs on the card (``tests/test_torch_kernels.py``
``-m gpu -k layer_norm``).

Tolerances: fp32 1e-5 absolute (the two implementations sum in another
order); bf16 y one bf16 ulp of the largest |reference| in at most 5% of
the elements (both round one fp32 value once), as the card's gate.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import layer_norm as KL

F32, BF16 = torch.float32, torch.bfloat16
LN_TOL = 1e-5
BF16_SHARE = 0.05
BASE = 1 << 20  # an address on a 16-byte boundary


def _inputs(n, d, dtype, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(n, d) * 3 + 0.5).astype("float32")
    s, b = r.randn(d).astype("float32"), r.randn(d).astype("float32")
    return tuple(torch.from_numpy(a).to(dtype) for a in (x, s, b))


def _tail_left_out(x, scale, bias, eps=1e-5, cols=256):
    """The planted fault: the statistics from the first `cols` columns
    (at D 300 the last load a lane makes left out)."""
    x32 = x.float()
    mean = x32[:, :cols].mean(dim=1, keepdim=True)
    var = (x32[:, :cols] - mean).square().mean(dim=1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()[None] + bias.float()[None]
    return y.to(x.dtype), mean.reshape(-1), var.reshape(-1)


def _gate(got, want):
    """The card's gate for #1 (chip_smoke.py `_ln_gate`)."""
    (y, mean, var), (wy, wmean, wvar) = got, want
    stat = max(float((mean - wmean).abs().max()),
               float((var - wvar).abs().max()))
    if y.dtype == BF16:
        g, w = y.float(), wy.float()
        top = float(w.abs().max())
        ulp = 2.0 ** (math.frexp(top)[1] - 8)
        return (float((g - w).abs().max()) <= ulp
                and float((g != w).float().mean()) <= BF16_SHARE
                and stat <= LN_TOL)
    return max(float((y - wy).abs().max()), stat) <= LN_TOL


# ---------------------------------------------------------------------------
# the row plan
# ---------------------------------------------------------------------------
# (rows, D, dtype) -> (body, vec_bytes, loads, grid) on 132 SMs with
# every pointer on a 16-byte boundary, at the shapes a whole
# chip_smoke.py run gives #1 (PERF.md's census of its launches): prompts
# and parity steps, the encoder at prompt 512 and 1024, training at
# 16384 and 32768 target tokens, the predictor's rows in bf16, the
# draft's prompts at d 256; GenerationServer's decoder step, a tick's
# lanes and the dustbin lane (9, 17), the verify at k = 2, 3, 4, the
# draft's steps; the ragged D 300; a row too wide for the warp body
MAIN_PATH_PLANS = [
    ((256, 512, F32), ("warp", 16, 4, 32)),
    ((512, 512, F32), ("warp", 16, 4, 64)),
    ((1024, 512, F32), ("warp", 16, 4, 128)),
    ((2048, 512, F32), ("warp", 16, 4, 256)),
    ((4096, 512, F32), ("warp", 16, 4, 264)),
    ((8192, 512, F32), ("warp", 16, 4, 264)),
    ((16384, 512, F32), ("warp", 16, 4, 264)),
    ((32768, 512, F32), ("warp", 16, 4, 264)),
    ((4096, 512, BF16), ("warp", 16, 2, 264)),
    ((8192, 512, BF16), ("warp", 16, 2, 264)),
    ((1024, 256, F32), ("warp", 16, 2, 128)),
    ((4096, 256, F32), ("warp", 16, 2, 264)),
    ((8, 512, F32), ("warp", 16, 4, 1)),
    ((9, 512, F32), ("warp", 16, 4, 2)),
    ((17, 512, F32), ("warp", 16, 4, 3)),
    ((51, 512, F32), ("warp", 16, 4, 7)),
    ((68, 512, F32), ("warp", 16, 4, 9)),
    ((85, 512, F32), ("warp", 16, 4, 11)),
    ((17, 256, F32), ("warp", 16, 2, 3)),
    ((4096, 300, F32), ("warp", 16, 4, 264)),
    ((4096, 300, BF16), ("warp", 8, 4, 264)),
    ((4096, 2048, F32), ("block", 4, 0, 4096)),
]


@pytest.mark.parametrize("shape,want", MAIN_PATH_PLANS,
                         ids=[f"{s[2]}-{s[0]}x{s[1]}"
                              for s, _ in MAIN_PATH_PLANS])
def test_ln_plan_at_the_main_path_shapes(shape, want):
    n, d, dtype = shape
    assert tuple(KL.ln_plan(n, d, dtype, (BASE,) * 4)) == want


@pytest.mark.parametrize("n,d,dtype,offset,want", [
    # x[1:] of [4097, 300] bf16: 600 bytes in
    (4096, 300, BF16, 600, ("warp", 8, 4, 264)),
    # [4096, 512] at element 1 and 2
    (4096, 512, BF16, 2, ("warp", 2, 16, 264)),
    (4096, 512, F32, 4, ("warp", 4, 16, 264)),
    (4096, 512, F32, 8, ("warp", 8, 8, 264)),
    (8, 512, BF16, 2, ("warp", 2, 16, 1)),
    (17, 512, F32, 8, ("warp", 8, 8, 3)),
])
def test_ln_plan_at_odd_offsets(n, d, dtype, offset, want):
    """x off a 16-byte boundary takes the widest loads its address
    allows; so does a scale or bias view off one (y is always the
    wrapper's fresh allocation)."""
    assert tuple(KL.ln_plan(n, d, dtype, (BASE + offset, BASE, BASE,
                                          BASE))) == want
    assert tuple(KL.ln_plan(n, d, dtype, (BASE, BASE, BASE + offset,
                                          BASE))) == want


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_ln_plan_covers_every_row_once(dtype):
    """Over D 1 to 1100 and every address offset below 16 bytes: D <=
    512 takes the warp body, whose packs (32 lanes x `loads` of
    `vec_bytes` bytes) cover the row with the fewest loads a power of two
    allows, on loads that divide the row and every pointer, with at most
    LANE_MAX elements a lane, as the C entry requires; wider rows take
    the block body on a grid of n."""
    item = dtype.itemsize
    for d in range(1, 1101):
        for off in range(0, 16, item):
            p = KL.ln_plan(300, d, dtype, (BASE + off, BASE, BASE, BASE))
            if d > 512:
                assert p == ("block", item, 0, 300), (d, off)
                continue
            vec = p.vec_bytes // item
            assert p.body == "warp" and p.vec_bytes in (2, 4, 8, 16)
            assert (d * item) % p.vec_bytes == 0 and off % p.vec_bytes == 0
            wider = 2 * p.vec_bytes
            assert wider > 16 or (d * item) % wider or off % wider
            assert p.loads & (p.loads - 1) == 0
            assert p.loads * 32 * vec >= d > p.loads * 16 * vec \
                or p.loads == 1
            assert p.loads * vec <= KL.LANE_MAX


def test_ln_plan_grid_by_rows_and_sms():
    """A warp a row up to CTAS_PER_SM CTAs of 8 warps an SM, then a
    grid-stride loop over the rows beyond one wave of warps."""
    for n, sms, grid in ((1, 132, 1), (9, 132, 2), (2112, 132, 264),
                         (2113, 132, 264), (4096, 114, 228),
                         (1824, 114, 228), (1825, 114, 228)):
        p = KL.ln_plan(n, 512, F32, (BASE,) * 4, sms)
        assert p.grid == grid, (n, sms, p)


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture
def jln():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from paddle_tpu.ops.pallas import layer_norm

    return layer_norm


@pytest.mark.parametrize("n,d,dtype", [(17, 512, F32), (16, 256, F32),
                                       (1, 512, F32), (33, 300, BF16)])
def test_layer_norm_plain_matches_ln_ref(jln, n, d, dtype):
    """y against `_ln_ref` on the same inputs (fp32 within 1e-5; bf16
    within the card's one-ulp gate), mean and var against float64 of the
    same values (1e-5 absolute for the mean, 1e-5 relative for the
    variance of values ~3 wide)."""
    import jax.numpy as jnp

    x, s, b = _inputs(n, d, dtype, seed=n + d)
    y, mean, var = KL.layer_norm_plain(x, s, b, 1e-5)
    jd = jnp.bfloat16 if dtype == BF16 else jnp.float32
    want = np.asarray(jln._ln_ref(jnp.asarray(x.float().numpy(), jd),
                                  jnp.asarray(s.float().numpy(), jd),
                                  jnp.asarray(b.float().numpy(), jd),
                                  1e-5).astype(jnp.float32))
    x64 = x.double().numpy()
    np.testing.assert_allclose(mean.numpy(), x64.mean(1), rtol=0,
                               atol=LN_TOL)
    np.testing.assert_allclose(var.numpy(), x64.var(1), rtol=1e-5, atol=0)
    if dtype == BF16:
        assert _gate((y, mean, var),
                     (torch.tensor(want).to(BF16), mean, var))
    else:
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=LN_TOL)


# ---------------------------------------------------------------------------
# the planted fault
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_the_gates_fail_the_ragged_tail_left_out(dtype):
    """At D 300 the statistics without the last 44 columns fail the
    card's gate in either type; at D 256 the same fault leaves nothing
    out and passes (it is the ragged tail the gate sees)."""
    x, s, b = _inputs(64, 300, dtype, seed=5)
    want = KL.layer_norm_plain(x, s, b)
    assert _gate(KL.layer_norm(x, s, b), want)
    assert not _gate(_tail_left_out(x, s, b), want)
    x, s, b = _inputs(64, 256, dtype, seed=6)
    assert _gate(_tail_left_out(x, s, b), KL.layer_norm_plain(x, s, b))
