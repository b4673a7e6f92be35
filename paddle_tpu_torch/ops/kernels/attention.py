"""Attention forward kernels: ``csrc/sdpa_short.cu`` and
``csrc/flash_attention.cu`` with their plain PyTorch versions
(counterpart of the forward halves of ``paddle_tpu/ops/pallas/attention.py``).

Both take q, k, v as [B, H, T, D] fp32. ``sdpa_short`` holds each query
tile's whole score row on chip (tq == tk, T <= 512, d in {64, 128});
``flash_attention`` streams keys with an online softmax (any tq, tk;
d in {64, 128, 256}), causal masking bottom-right aligned. Their
backward kernels are not ported yet, so on the card differentiating
either raises (``ForwardOnly``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (check_launch, current_stream, reference_attention,
               require_cuda_inputs)
from .build import library

SDPA_MAX_T = 512
SDPA_HEAD_DIMS = (64, 128)
FLASH_HEAD_DIMS = (64, 128, 256)


def sdpa_short_plain(q, k, v, scale, causal):
    """The sdpa_short kernel's function (`_sdpa_short_fwd_impl`, tq ==
    tk): `reference_attention`, whose bottom-right causal mask is
    `_causal_mask` (query i sees keys <= i) when tq == tk."""
    return reference_attention(q, k, v, scale, causal)


def flash_attention_plain(q, k, v, scale, causal):
    """The flash kernel's function: `reference_attention`, whose
    finfo.min masking gives a fully masked row the uniform average of v
    (the kernel matches that; the TPU kernel wrote zeros there)."""
    return reference_attention(q, k, v, scale, causal)


@functools.cache
def _kernel(name, n_ints):
    """The C entry point `<name>_fwd` with its signature declared:
    (q, k, v, out, bh, `n_ints` ints of sizes, scale, causal, stream)."""
    fn = getattr(library(name), f"{name}_fwd")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] + \
        [ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_qkv(name, q, k, v, head_dims):
    require_cuda_inputs(name, (q, k, v), (torch.float32,))
    if q.dim() != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B,H,T,D] alike")
    if q.shape[3] not in head_dims:
        raise ValueError(f"{name}: head dim {q.shape[3]} not in {head_dims}")


class ForwardOnly(torch.autograd.Function):
    """A forward kernel whose backward kernel is not ported yet. Its
    output is written through ``data_ptr()`` and has no graph, so
    differentiating it would give missing or zero gradients without an
    error; this Function raises instead."""

    @staticmethod
    def forward(launch, q, k, v, scale, causal):
        return launch(q, k, v, scale, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.name = inputs[0].__name__.strip("_").removesuffix("_launch")

    @staticmethod
    def backward(ctx, dout):
        raise NotImplementedError(
            f"{ctx.name}: the attention backward kernels (#3/#4 flash "
            f"dq and dk/dv, #6 sdpa_short) are not ported yet; training "
            f"on the card at T > 256 waits for the long-sequence "
            f"training slice")


def sdpa_short(q, k, v, scale, causal=False):
    """q,k,v: [B,H,T,D] (same T) -> [B,H,T,D]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return sdpa_short_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"sdpa_short: no kernel for device {q.device}")
    return ForwardOnly.apply(_sdpa_short_launch, q, k, v, scale, causal)


def _sdpa_short_launch(q, k, v, scale, causal):
    _check_qkv("sdpa_short", q, k, v, SDPA_HEAD_DIMS)
    b, h, t, d = q.shape
    if k.shape[2] != t or not 1 <= t <= SDPA_MAX_T:
        raise ValueError(f"sdpa_short: needs tq == tk <= {SDPA_MAX_T}, got "
                         f"{t} and {k.shape[2]}")
    out = torch.empty_like(q)
    err = _kernel("sdpa_short", 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
        t, d, float(scale), int(bool(causal)), current_stream(q))
    sdpa_short.launches += 1
    check_launch("sdpa_short", err)
    return out


def flash_attention(q, k, v, scale, causal=False):
    """q: [B,H,tq,D], k, v: [B,H,tk,D] -> [B,H,tq,D]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return ForwardOnly.apply(_flash_attention_launch, q, k, v, scale,
                             causal)


def _flash_attention_launch(q, k, v, scale, causal):
    _check_qkv("flash_attention", q, k, v, FLASH_HEAD_DIMS)
    b, h, tq, d = q.shape
    out = torch.empty_like(q)
    err = _kernel("flash_attention", 3)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
        tq, k.shape[2], d, float(scale), int(bool(causal)),
        current_stream(q))
    flash_attention.launches += 1
    check_launch("flash_attention", err)
    return out


sdpa_short.launches = 0
flash_attention.launches = 0
