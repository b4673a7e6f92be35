"""Attention kernels: ``csrc/sdpa_short.cu`` and ``csrc/flash_attention.cu``
(forward), ``csrc/sdpa_short_bwd.cu`` and ``csrc/flash_attention_bwd.cu``
(backward), with their plain PyTorch versions (counterpart of
``paddle_tpu/ops/pallas/attention.py``).

All take q, k, v as [B, H, T, D], all fp32 or all bf16 (the TPU kernels'
contract under AMP: fp32 accumulation, fp32 lse and delta, outputs and
grads in the input dtype, sdpa_short's saved P in the input dtype). Each
C entry point has a ``_bf16`` twin built from the same body. Both
forwards run one body, an online softmax over streamed keys on the
tensor cores (``csrc/flash_fwd.cuh``): ``sdpa_short`` at tq == tk <= 512, d in
{64, 128}, ``flash_attention`` at any tq, tk, d in {64, 128, 256},
causal masking bottom-right aligned. ``sdpa_short``'s backward runs the
attention stages it shares with the attention block's backward
(``csrc/attn_bwd_from_p.cuh``).

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

from . import (causal_keep, check_launch, current_stream, masked_logits,
               reference_attention, require_cuda_inputs, storage_tensor)
from . import on_card as _on_card

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
    err = _kernel("sdpa_short", "sdpa_short_fwd", 5, 2, q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(p),
        b * h, t, d, float(scale), int(bool(causal)), current_stream(q))
    sdpa_short.launches += 1
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
    # scratch: delta, rowsum(dP P), which the kernel sums itself
    rowsum = torch.empty(b * h, t, dtype=torch.float32, device=q.device)
    ptrs = (q, k, v, p, g, dq, dk, dv, rowsum)
    err = _kernel("sdpa_short_bwd", "sdpa_short_bwd", len(ptrs), 2,
                  q.dtype)(*(x.data_ptr() for x in ptrs), b * h, t, d,
                           float(scale), int(bool(causal)),
                           current_stream(q))
    sdpa_short_bwd.launches += 1
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
    flash_attention.launches += 1
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
    flash_bwd_dq.launches += 1
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
    flash_bwd_dkv.launches += 1
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
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
