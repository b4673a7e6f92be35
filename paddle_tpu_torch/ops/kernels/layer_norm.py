"""Row LayerNorm forward: the CUDA kernel ``csrc/layer_norm.cu`` and its
plain PyTorch version (counterpart of
``paddle_tpu/ops/pallas/layer_norm.py``; CUDA C++ rather than Triton so
all three kernels of the slice share one build route).

Both return ``(y, mean, var)``: y in x's dtype, and the fp32 per-row
mean and (biased) variance that the layer_norm op outputs as Mean and
Variance. On the card the kernel is differentiable: ``LayerNormFn``
gives it the plain version's vjp as its backward, as the JAX package
does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (check_launch, count_launch, current_stream,
               require_cuda_inputs)


def layer_norm_plain(x, scale, bias, eps=1e-5):
    """x [N,D], scale/bias [D]. The JAX package's ``_ln_ref``: fp32
    statistics from the centred values, affine in fp32."""
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    var = (x32 - mean).square().mean(dim=1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()[None] + bias.float()[None]
    return y.to(x.dtype), mean.reshape(-1), var.reshape(-1)


@functools.cache
def _kernel():
    """The C entry point with its signature declared, built on first
    use (the decode loop launches this hundreds of times a batch)."""
    from .build import library

    fn = library("layer_norm").layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, scale, bias, eps):
    """Checks the CUDA inputs and launches the kernel."""
    n, d = x.shape
    require_cuda_inputs("layer_norm", (x, scale, bias),
                        (torch.float32, torch.bfloat16))
    if scale.dtype != x.dtype or bias.dtype != x.dtype \
            or scale.shape != (d,) or bias.shape != (d,):
        raise ValueError(
            f"layer_norm: scale/bias must be [{d}] of {x.dtype}, got "
            f"{tuple(scale.shape)} {scale.dtype} and "
            f"{tuple(bias.shape)} {bias.dtype}")
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    if n == 0:
        return y, mean, var
    err = _kernel()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr(), var.data_ptr(), n, d, eps,
        int(x.dtype == torch.bfloat16), current_stream(x))
    count_launch(layer_norm, x.dtype == torch.bfloat16)
    check_launch("layer_norm", err)
    return y, mean, var


class LayerNormFn(torch.autograd.Function):
    """The kernel's forward with the plain version's vjp as its backward
    (the JAX package's ``custom_vjp`` around ``_ln_impl``, whose backward
    is ``jax.vjp`` of ``_ln_ref``). Written with ``setup_context`` so
    that ``torch.func.vjp`` can differentiate through it: a vjp through
    the bare launch would see an output with no graph. The layer_norm
    grad op does not come through here; it takes the plain version's
    vjp directly and launches nothing."""

    @staticmethod
    def forward(launch, x, scale, bias, eps):
        return launch(x, scale, bias, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, x, scale, bias, eps = inputs
        ctx.save_for_backward(x, scale, bias)
        ctx.eps = eps

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, scale, bias = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda a, s, b: layer_norm_plain(a, s, b, ctx.eps), x, scale,
            bias)
        return (None, *vjp((dy, dmean, dvar)), None)


def layer_norm(x, scale, bias, eps=1e-5):
    """x [N,D] fp32 or bf16; scale/bias [D] of x's dtype."""
    n, d = x.shape
    if x.device.type == "meta":
        stat = torch.empty(n, dtype=torch.float32, device=x.device)
        return torch.empty_like(x), stat, torch.empty_like(stat)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    return LayerNormFn.apply(_launch, x, scale, bias, eps)


layer_norm.launches = 0
# the launches of the bf16 instance (also counted in `launches`)
layer_norm.launches_bf16 = 0
