"""Attention kernels: ``csrc/sdpa_short.cu`` and ``csrc/flash_attention.cu``
(forward), ``csrc/sdpa_short_bwd.cu`` and ``csrc/flash_attention_bwd.cu``
(backward), with their plain PyTorch versions (counterpart of
``paddle_tpu/ops/pallas/attention.py``).

All take q, k, v as [B, H, T, D], all fp32 or all bf16 (the TPU kernels'
contract under AMP: fp32 accumulation, fp32 lse and delta, outputs and
grads in the input dtype, sdpa_short's saved P in the input dtype). Each
C entry point has a ``_bf16`` twin. Both forwards run one body in fp32,
an online softmax over streamed keys on the tensor cores
(``csrc/flash_fwd.cuh``): ``sdpa_short`` at tq == tk <= 512, d in {64,
128}, ``flash_attention`` at any tq, tk, d in {64, 128, 256}, causal
masking bottom-right aligned. ``sdpa_short``'s backward runs, in fp32, the
attention stages it shares with the attention block's backward
(``csrc/attn_bwd_from_p.cuh``). In bf16 at d 64 and 128, ``flash_attention``,
``sdpa_short`` (with P: the flash forward writing its lse, then a P
kernel), the flash backward's dq and dk/dv and ``sdpa_short``'s backward
run their own Hopper design on wgmma fed by TMA
(``csrc/attn_wgmma.cuh``; `flash_attention_tiles_plain`,
`sdpa_short_tiles_plain`, `flash_bwd_dq_tiles_plain`,
`flash_bwd_dkv_tiles_plain` and `sdpa_short_bwd_tiles_plain` are its
arithmetic in PyTorch); at d 256 ``flash_attention`` keeps
``flash_fwd.cuh``'s body and the dq and dk/dv kernels their ``mma.sync``
bodies, a dispatch by d (their accumulators leave a wgmma consumer no
registers).

On the card both are differentiable, as the JAX package's ``custom_vjp``
pair is: under a vjp the forward kernel also writes the residual its
backward kernel reads (sdpa_short: the normalized P; flash: the per-row
logsumexp), and the backward launches the backward kernel(s). The
primal call, as the Executor's forward op makes it under ``no_grad``,
writes no residual.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (causal_keep, check_launch, count_launch, current_stream,
               masked_logits, reference_attention, require_cuda_inputs,
               storage_tensor)
from . import on_card as _on_card
from .bf16_planes import planes_sum

SDPA_MAX_T = 512
SDPA_HEAD_DIMS = (64, 128)
FLASH_HEAD_DIMS = (64, 128, 256)
# the dtypes the kernels take, all of q, k, v alike
DTYPES = (torch.float32, torch.bfloat16)


def sdpa_short_plain(q, k, v, scale, causal, save_p=False):
    """The sdpa_short kernel's function (`_sdpa_short_fwd_impl`, tq ==
    tk): `reference_attention`, whose bottom-right causal mask is
    `_causal_mask` (query i sees keys <= i) when tq == tk; the output
    from the fp32 P. With `save_p` it also returns the normalized
    probabilities [B*H, T, T] in q's dtype (bf16 under AMP, as the TPU
    kernel saves them)."""
    out = reference_attention(q, k, v, scale, causal)
    if not save_p:
        return out
    p = torch.softmax(masked_logits(q, k, scale, causal), dim=-1)
    return out, p.reshape(-1, *p.shape[-2:]).to(q.dtype)


def sdpa_short_bwd_plain(q, k, v, p, g, scale, causal=False):
    """`_sdpa_short_bwd_impl`: (dq, dk, dv) from the saved P [B*H, T, T]
    and the output's cotangent g, with no exp, in fp32 and returned in
    q's dtype. `causal` only lets the kernel skip the tiles where P is
    0."""
    b, h, t, d = q.shape
    p = p.reshape(b, h, t, t).float()
    g = g.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


LOG2E = 1.4426950408889634
FLT_MAX = torch.finfo(torch.float32).max


def _key_loop_tiles(q, k, v, scale, causal, key_tile, p_terms):
    """The bf16 forward's key loop (``csrc/attn_wgmma.cuh`` `fwd_kernel`)
    in fp32: (acc, the scaled scores s [B, H, tq, tk] in the log2 domain,
    the final max m and sum l, the running max after each tile)."""
    tq, tk = q.shape[2], k.shape[2]
    qf, vf = q.float(), v.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * (scale * LOG2E)
    if causal:
        s = torch.where(causal_keep(tq, tk, q.device), s, -FLT_MAX)
    m = torch.full(q.shape[:3], -torch.inf, device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    acc = torch.zeros_like(qf)
    running = []
    for k0 in range(0, tk, key_tile):
        st = s[..., k0:k0 + key_tile]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", planes_sum(p, p_terms),
            vf[:, :, k0:k0 + key_tile])
        m = m_new
        running.append(m)
    return acc, s, m, l, running


def flash_attention_tiles_plain(q, k, v, scale, causal, key_tile=128,
                                p_terms=2):
    """The arithmetic of the bf16 flash forward on wgmma
    (``csrc/attn_wgmma.cuh``), in fp32 from q's values: keys in tiles of
    `key_tile` (128 at d 64, 64 at d 128), the online softmax on the
    scores scaled into the log2 domain (a causally masked score
    -FLT_MAX), P fed to P v as `p_terms` bf16 planes (2: hi and lo; 1:
    P rounded to one bf16 term, a design that must fail the bf16 gate)
    into a fresh accumulator a tile, out / l rounded to q's dtype once.
    Returns (out, lse fp32 [B, H, tq]; -FLT_MAX on a fully masked
    row)."""
    acc, _, m, l, _ = _key_loop_tiles(q, k, v, scale, causal, key_tile,
                                      p_terms)
    lse = torch.where(m == -FLT_MAX, -FLT_MAX, m / LOG2E + torch.log(l))
    return (acc / l[..., None]).to(q.dtype), lse


def sdpa_short_tiles_plain(q, k, v, scale, causal, key_tile=128,
                           p_max="final"):
    """The arithmetic of bf16 #5 on wgmma (``csrc/attn_wgmma.cuh``), in
    fp32 from q's values, tq == tk: #2's key loop gives the output
    (`flash_attention_tiles_plain`, P v on P's planes) and the lse;
    `p_kernel` takes the scaled scores again and saves P = exp2(s - lse2)
    with the row's final lse2 = m + log2(l) (its max m and sum l), rounded
    to q's dtype [B*H, T, T] (causally masked entries 0).
    `p_max="running"`: each tile's P normalized by the running max after
    that tile and the final sum, as a single pass writing P during the
    key loop would, a design that must fail the bf16 gate. Returns (out,
    P)."""
    acc, s, m, l, running = _key_loop_tiles(q, k, v, scale, causal,
                                            key_tile, 2)
    if p_max == "final":
        p = torch.exp2(s - (m + torch.log2(l))[..., None])
    else:
        shift = torch.cat([r[..., None].expand(*r.shape, st.shape[-1])
                           for r, st in zip(running, s.split(key_tile, -1))],
                          -1)
        p = torch.exp2(s - shift) / l[..., None]
    return ((acc / l[..., None]).to(q.dtype),
            p.reshape(-1, *p.shape[-2:]).to(q.dtype))


def sdpa_short_bwd_tiles_plain(q, k, v, p, g, scale, causal=False,
                               key_tile=128, query_tile=64, ds_terms=2):
    """The arithmetic of the bf16 sdpa_short backward on wgmma
    (``csrc/attn_wgmma.cuh``), in fp32 from the bf16 values: grid 1's
    delta = rowsum(dP P) summed over key tiles of `key_tile` in order, and
    dq = scale dS k a tile at a time; grid 2's dk = scale dS^T q and dv =
    P^T dO over query tiles of `query_tile`; dS enters its products as
    `ds_terms` bf16 planes (2: hi and lo; 1: one bf16 term, a design that
    must fail the bf16 gate). `causal` only skips tiles where P is 0.
    Returns (dq, dk, dv) in q's dtype."""
    b, h, t, d = q.shape
    p = p.reshape(b, h, t, t).float()
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = torch.zeros(b, h, t, device=q.device)
    for k0 in range(0, t, key_tile):
        sl = slice(k0, k0 + key_tile)
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf[:, :, sl])
        delta = delta + (dp * p[..., sl]).sum(-1)
    dq = torch.zeros_like(qf)
    for k0 in range(0, t, key_tile):
        sl = slice(k0, k0 + key_tile)
        dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf[:, :, sl])
        ds = p[..., sl] * (dp - delta[..., None])
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", planes_sum(ds, ds_terms),
                               kf[:, :, sl])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, t, query_tile):
        sl = slice(q0, q0 + query_tile)
        pt = p[:, :, sl].transpose(-1, -2)  # [keys, queries]
        dpt = torch.einsum("bhkd,bhqd->bhkq", vf, gf[:, :, sl])
        dst = pt * (dpt - delta[:, :, None, sl])
        dv = dv + torch.einsum("bhkq,bhqd->bhkd", pt, gf[:, :, sl])
        dk = dk + torch.einsum("bhkq,bhqd->bhkd", planes_sum(dst, ds_terms),
                               qf[:, :, sl])
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype))


def flash_bwd_dkv_tiles_plain(q, k, v, g, lse, delta, scale, causal,
                              query_tile=64, p_terms=2):
    """The arithmetic of bf16 #4 on wgmma (``csrc/attn_wgmma.cuh``
    `flash_dkv_kernel`), in fp32 from the bf16 values: P = exp2(s scale
    log2e - lse log2e) from the forward's lse (a causally masked entry 0,
    a row that sees no key 1/tk, found by index), dS = P (dP - delta) in
    fp32; dv = P^T dO with P as `p_terms` bf16 planes (2: hi and lo; 1:
    one bf16 term, a design that must fail the bf16 gate) and dk = dS^T q
    with dS as two planes, each summed in chains of two query tiles of
    `query_tile` (256 terms) added to the running sum; dk scaled once.
    Returns (dk, dv) in q's dtype."""
    tq, tk = q.shape[2], k.shape[2]
    qf, gf = q.float(), g.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, k.float()) * (scale * LOG2E)
    p = torch.exp2(s - lse[..., None] * LOG2E)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, v.float())
              - delta[..., None])
    if causal:
        keep = causal_keep(tq, tk, q.device)
        blind = torch.arange(tq, device=q.device)[:, None] < tq - tk
        p = torch.where(keep, p, torch.where(blind, 1.0 / tk, 0.0))
        ds = torch.where(keep, ds, 0.0)
    dk, dv = torch.zeros_like(k.float()), torch.zeros_like(k.float())
    for q0 in range(0, tq, 2 * query_tile):
        sl = slice(q0, q0 + 2 * query_tile)
        dv = dv + torch.einsum("bhqk,bhqd->bhkd",
                               planes_sum(p[:, :, sl], p_terms), gf[:, :, sl])
        dk = dk + torch.einsum("bhqk,bhqd->bhkd", planes_sum(ds[:, :, sl]),
                               qf[:, :, sl])
    return (dk * scale).to(q.dtype), dv.to(q.dtype)


def flash_bwd_dq_tiles_plain(q, k, v, g, lse, delta, scale, causal,
                             key_tile=64, ds_terms=2):
    """The arithmetic of bf16 #3 on wgmma (``csrc/attn_wgmma.cuh``
    `flash_dq_kernel`), in fp32 from the bf16 values: P = exp2(s scale
    log2e - lse log2e) from the forward's lse, dS = P (dP - delta) (0 on
    a causally masked entry, so 0 on every key of a row that sees none,
    found by index); dq = dS k with dS as `ds_terms` bf16 planes (2: hi
    and lo; 1: one bf16 term, a design that must fail the bf16 gate),
    summed a key tile of `key_tile` at a time (128 terms) into the
    running sum, scaled once. Returns dq in q's dtype."""
    tq, tk = q.shape[2], k.shape[2]
    kf = k.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (scale * LOG2E)
    p = torch.exp2(s - lse[..., None] * LOG2E)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
              - delta[..., None])
    if causal:
        ds = torch.where(causal_keep(tq, tk, q.device), ds, 0.0)
    dq = torch.zeros_like(q.float())
    for k0 in range(0, tk, key_tile):
        sl = slice(k0, k0 + key_tile)
        dq = dq + torch.einsum("bhqk,bhkd->bhqd",
                               planes_sum(ds[..., sl], ds_terms), kf[:, :, sl])
    return (dq * scale).to(q.dtype)


# The operand forms of csrc/attn_wgmma.cuh, each a [64, n] x depth-128
# product as `attn_wgmma_form_bf16` runs it: (name, A MN-major, B MN-major,
# A from registers as two planes of fp32 values).
WGMMA_FORMS = (("SS K-major", False, False, False),
               ("SS MN-major", True, True, False),
               ("RS planes, B MN-major", False, True, True))


def wgmma_form_bf16(form, a, b):
    """C [64, n] fp32 = A B in operand form `form` (`WGMMA_FORMS`): a bf16
    [64, 128] (form 0), [128, 64] (form 1, A^T as it lies) or fp32 [64,
    128] (form 2: its hi/lo planes); b bf16 [n, 128] (form 0, B^T) or
    [128, n]; n 64 or 128. On the card one launch of the form's wgmma
    chain; on the CPU the plain product of the same operands."""
    _, ta, tb, planes = WGMMA_FORMS[form]
    n = b.shape[1] if tb else b.shape[0]
    if a.device.type == "cpu":
        am = planes_sum(a) if planes else a.float()
        return (am.T if ta else am) @ (b.float() if tb else b.float().T)
    require_cuda_inputs("wgmma_form_bf16", (b,), (torch.bfloat16,))
    require_cuda_inputs("wgmma_form_bf16", (a,),
                        (torch.float32 if planes else torch.bfloat16,))
    if a.shape != ((64, 128) if not ta else (128, 64)) or \
            b.shape[1 if not tb else 0] != 128 or n not in (64, 128):
        raise ValueError(f"wgmma_form_bf16: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not fit form {form}")
    _check_aligned("wgmma_form_bf16", (a, b), "a and b")
    c = torch.empty(64, n, dtype=torch.float32, device=a.device)
    check_launch("wgmma_form_bf16", _form_kernel()(
        form, n, a.data_ptr(), b.data_ptr(), c.data_ptr(),
        current_stream(a)))
    return c


@functools.cache
def _form_kernel():
    """The C entry `attn_wgmma_form_bf16` (built with flash_attention.cu)
    with its signature declared: (form, n, a, b, c, stream)."""
    from .build import library

    fn = library("flash_attention").attn_wgmma_form_bf16
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return fn


def flash_attention_plain(q, k, v, scale, causal, with_lse=False):
    """The flash kernel's function: `reference_attention`, whose
    finfo.min masking gives a fully masked row the uniform average of v
    (the kernel matches that; the TPU kernel wrote zeros there). With
    `with_lse` it also returns the per-row logsumexp [B, H, tq] fp32
    (finfo.min on a fully masked row)."""
    out = reference_attention(q, k, v, scale, causal)
    if not with_lse:
        return out
    return out, torch.logsumexp(masked_logits(q, k, scale, causal), dim=-1)


def _flash_p_ds(q, k, v, g, lse, delta, scale, causal):
    """P and ds as both flash backward kernels recompute them: P =
    exp(s - lse) where a key is seen; a masked entry passes no gradient
    (ds = 0), and a row that sees no key (causal, tq > tk) has P = 1/tk
    on every key, the uniform average its forward took."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None])
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = causal_keep(tq, tk, s.device)
        blind = torch.arange(tq, device=s.device)[:, None] < tq - tk
        p = torch.where(keep, p, torch.where(blind, 1.0 / tk, 0.0))
        ds = torch.where(keep, ds, 0.0)
    return p, ds


def flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal):
    """`_bwd_dq_kernel`: dq from lse and delta = rowsum(g * out), in q's
    dtype."""
    _, ds = _flash_p_ds(q, k, v, g, lse, delta, scale, causal)
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
            * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale, causal):
    """`_bwd_dkv_kernel`: (dk, dv) from lse and delta, in q's dtype."""
    p, ds = _flash_p_ds(q, k, v, g, lse, delta, scale, causal)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_delta(out, g):
    """delta = rowsum(g * out) [B, H, tq] fp32, which the JAX package
    computes in XLA outside its backward kernels (`_flash_bwd_impl`)."""
    return (g.float() * out.float()).sum(-1)


def flash_attention_bwd_plain(q, k, v, out, lse, g, scale, causal):
    """`_flash_bwd_impl`: (dq, dk, dv) from the forward's out and lse."""
    delta = flash_delta(out, g)
    dq = flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal)
    return (dq, *flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale, causal))


@functools.cache
def _kernel(name, entry, n_ptrs, n_ints, dtype=torch.float32):
    """The C entry point `entry` of library `name` (its ``_bf16`` twin
    for bf16 operands) with its signature declared: (`n_ptrs` pointers,
    bh, `n_ints` ints of sizes, scale, causal, stream)."""
    from .build import library

    if dtype == torch.bfloat16:
        entry += "_bf16"
    fn = getattr(library(name), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] + \
        [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _check_qkv(name, q, k, v, head_dims):
    require_cuda_inputs(name, (q, k, v), DTYPES)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: q, k, v are {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernels take one dtype")
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B,H,T,D] alike")
    if q.shape[3] not in head_dims:
        raise ValueError(f"{name}: head dim {q.shape[3]} not in {head_dims}")


def _check_aligned(name, tensors, what):
    """The kernels copy 16-byte rows with cp.async: a view that does not
    start on a 16-byte boundary would fault on the card."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary "
                         f"(the kernels copy 16-byte rows)")


def _check_like(name, tensors, shapes, dtypes):
    """Backward inputs beside q, k, v: contiguous, on q's device, of the
    shapes and dtypes the kernels index them by."""
    require_cuda_inputs(name, tensors, DTYPES)
    for t, shape, dtype in zip(tensors, shapes, dtypes):
        if t.dtype != dtype:
            raise TypeError(f"{name}: got dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: got shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


# ---------------------------------------------------------------------------
# sdpa_short
# ---------------------------------------------------------------------------
def sdpa_short(q, k, v, scale, causal=False):
    """q,k,v: [B,H,T,D] (same T) -> [B,H,T,D]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return sdpa_short_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_short: no kernel for device {q.device}")
    return _on_card(SdpaShortFn, _sdpa_short_launch, q, k, v, scale, causal)


def _sdpa_short_launch(q, k, v, scale, causal, save_p):
    _check_qkv("sdpa_short", q, k, v, SDPA_HEAD_DIMS)
    b, h, t, d = q.shape
    if k.shape[2] != t or not 1 <= t <= SDPA_MAX_T:
        raise ValueError(f"sdpa_short: needs tq == tk <= {SDPA_MAX_T}, got "
                         f"{t} and {k.shape[2]}")
    _check_aligned("sdpa_short", (q, k, v), "q, k and v")
    out = torch.empty_like(q)
    p = torch.empty(b * h, t, t, dtype=q.dtype,
                    device=q.device) if save_p else None
    # scratch: in bf16, the lse from which the kernel forms P
    lse = torch.empty(b * h, t, dtype=torch.float32, device=q.device) \
        if save_p and q.dtype == torch.bfloat16 else None
    err = _kernel("sdpa_short", "sdpa_short_fwd", 6, 2, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(p),
        _ptr(lse), b * h, t, d, float(scale), int(bool(causal)),
        current_stream(q))
    count_launch(sdpa_short, q.dtype == torch.bfloat16)
    check_launch("sdpa_short", err)
    return (out, p) if save_p else out


def sdpa_short_bwd(q, k, v, p, g, scale, causal=False):
    """(dq, dk, dv) of sdpa_short from its saved P [B*H, T, T] and the
    output's cotangent g [B,H,T,D]."""
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return sdpa_short_bwd_plain(q, k, v, p, g, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_short_bwd: no kernel for device {q.device}")
    return _sdpa_short_bwd_launch(q, k, v, p, g, scale, causal)


def _sdpa_short_bwd_launch(q, k, v, p, g, scale, causal):
    _check_qkv("sdpa_short_bwd", q, k, v, SDPA_HEAD_DIMS)
    b, h, t, d = q.shape
    if k.shape[2] != t or not 1 <= t <= SDPA_MAX_T:
        raise ValueError(f"sdpa_short_bwd: needs tq == tk <= {SDPA_MAX_T}, "
                         f"got {t} and {k.shape[2]}")
    _check_like("sdpa_short_bwd", (q, p, g), (q.shape, (b * h, t, t),
                                              q.shape), (q.dtype,) * 3)
    _check_aligned("sdpa_short_bwd", (q, k, v, p, g), "q, k, v, P and dO")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    # scratch: delta, rowsum(dP P), which the kernel sums itself; rows
    # rounded up to 128 (the bf16 kernel's tiles read it by TMA)
    rowsum = torch.empty(b * h, -(-t // 128) * 128, dtype=torch.float32,
                         device=q.device)
    ptrs = (q, k, v, p, g, dq, dk, dv, rowsum)
    err = _kernel("sdpa_short_bwd", "sdpa_short_bwd", len(ptrs), 2,
                  q.dtype)(*(x.data_ptr() for x in ptrs), b * h, t, d,
                           float(scale), int(bool(causal)),
                           current_stream(q))
    count_launch(sdpa_short_bwd)
    check_launch("sdpa_short_bwd", err)
    return dq, dk, dv


class SdpaShortFn(torch.autograd.Function):
    """`sdpa_short`'s ``custom_vjp`` (`_sdpa_short_fwd` /
    `_sdpa_short_bwd`) as an autograd.Function: the forward kernel also
    saves P, an output marked non-differentiable (a `setup_context`
    Function, the form `torch.func` accepts, may save only inputs and
    outputs); the backward launches the backward kernel."""

    @staticmethod
    def forward(q, k, v, scale, causal):
        return _sdpa_short_launch(q, k, v, scale, causal, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.scale, ctx.causal = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(q, k, v, output[1])

    @staticmethod
    def backward(ctx, dout, _dp):
        q, k, v, p, g = map(storage_tensor, (*ctx.saved_tensors, dout))
        return (*sdpa_short_bwd(q, k, v, p, g.contiguous(), ctx.scale,
                                ctx.causal), None, None)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, scale, causal=False):
    """q: [B,H,tq,D], k, v: [B,H,tk,D] -> [B,H,tq,D]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _on_card(FlashAttentionFn, _flash_attention_launch, q, k, v,
                    scale, causal)


def _flash_attention_launch(q, k, v, scale, causal, with_lse):
    _check_qkv("flash_attention", q, k, v, FLASH_HEAD_DIMS)
    _check_aligned("flash_attention", (q, k, v), "q, k and v")
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, tq, dtype=torch.float32,
                      device=q.device) if with_lse else None
    err = _kernel("flash_attention", "flash_attention_fwd", 5, 3, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _ptr(lse), b * h, tq, k.shape[2], d, float(scale),
        int(bool(causal)), current_stream(q))
    count_launch(flash_attention, q.dtype == torch.bfloat16)
    check_launch("flash_attention", err)
    return (out, lse) if with_lse else out


def _check_flash_bwd(name, q, k, v, g, lse, delta):
    _check_qkv(name, q, k, v, FLASH_HEAD_DIMS)
    _check_like(name, (q, g, lse, delta), (q.shape, q.shape, q.shape[:3],
                                           q.shape[:3]),
                (q.dtype, q.dtype, torch.float32, torch.float32))
    _check_aligned(name, (q, k, v, g), "q, k, v and dO")


def flash_bwd_dq(q, k, v, g, lse, delta, scale, causal=False):
    """dq [B,H,tq,D] from the forward's lse and delta [B,H,tq]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g, lse, delta, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq: no kernel for device {q.device}")
    return _flash_bwd_dq_launch(q, k, v, g, lse, delta, scale, causal)


def _flash_bwd_dq_launch(q, k, v, g, lse, delta, scale, causal):
    _check_flash_bwd("flash_bwd_dq", q, k, v, g, lse, delta)
    b, h, tq, d = q.shape
    dq = torch.empty_like(q)
    err = _kernel("flash_attention_bwd", "flash_attention_bwd_dq", 7, 3,
                  q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b * h, tq,
        k.shape[2], d, float(scale), int(bool(causal)), current_stream(q))
    count_launch(flash_bwd_dq)
    check_launch("flash_bwd_dq", err)
    return dq


def flash_bwd_dkv(q, k, v, g, lse, delta, scale, causal=False):
    """(dk, dv) [B,H,tk,D] from the forward's lse and delta [B,H,tq]."""
    if q.device.type == "meta":
        return torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g, lse, delta, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv: no kernel for device {q.device}")
    return _flash_bwd_dkv_launch(q, k, v, g, lse, delta, scale, causal)


def _flash_bwd_dkv_launch(q, k, v, g, lse, delta, scale, causal):
    _check_flash_bwd("flash_bwd_dkv", q, k, v, g, lse, delta)
    b, h, tq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _kernel("flash_attention_bwd", "flash_attention_bwd_dkv", 8, 3,
                  q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b * h, tq, k.shape[2], d, float(scale), int(bool(causal)),
        current_stream(q))
    count_launch(flash_bwd_dkv)
    check_launch("flash_bwd_dkv", err)
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, g, scale, causal=False):
    """(dq, dk, dv) of flash_attention from its out and lse: delta in
    PyTorch, then the dq and the dk/dv kernels."""
    delta = flash_delta(out, g)
    return (flash_bwd_dq(q, k, v, g, lse, delta, scale, causal),
            *flash_bwd_dkv(q, k, v, g, lse, delta, scale, causal))


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention`'s ``custom_vjp`` (`_flash_fwd` / `_flash_bwd`)
    as an autograd.Function: the forward kernel also writes lse, an
    output marked non-differentiable; the backward launches the dq and
    dk/dv kernels."""

    @staticmethod
    def forward(q, k, v, scale, causal):
        return _flash_attention_launch(q, k, v, scale, causal, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, ctx.scale, ctx.causal = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, g = map(storage_tensor,
                                   (*ctx.saved_tensors, dout))
        return (*flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                     ctx.scale, ctx.causal), None, None)


sdpa_short.launches = 0
sdpa_short_bwd.launches = 0
flash_attention.launches = 0
# the launches of the bf16 instances (also counted in `launches`)
sdpa_short.launches_bf16 = 0
flash_attention.launches_bf16 = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
