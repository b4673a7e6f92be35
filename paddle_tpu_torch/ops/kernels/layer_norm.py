"""Row LayerNorm forward: the CUDA kernel ``csrc/layer_norm.cu`` and its
plain PyTorch version (counterpart of
``paddle_tpu/ops/pallas/layer_norm.py``; CUDA C++ rather than Triton so
every kernel of the port shares one build route).

Both return ``(y, mean, var)``: y in x's dtype, and the fp32 per-row
mean and (biased) variance that the layer_norm op outputs as Mean and
Variance. On the card the kernel is differentiable: ``LayerNormFn``
gives it the plain version's vjp as its backward, as the JAX package
does. ``ln_plan`` picks the kernel's body, load width and grid on the
host (the source's note says why).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

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


# the kernel's constants (csrc/layer_norm.cu): 8 warps a CTA; the warp
# body holds at most 16 elements a lane (D 512 at any alignment) and
# keeps 2 CTAs an SM resident (its launch bound)
WARPS = 8
LANE_MAX = 16
CTAS_PER_SM = 2
H100_SMS = 132


class LnPlan(NamedTuple):
    """How the kernel runs [n, d]: ``body`` "warp" (a warp a row, D <=
    512) or "block" (a block of 256 threads a row); the warp body's
    loads of ``vec_bytes`` bytes, ``loads`` of them a lane (a power of
    two); ``grid`` CTAs."""
    body: str
    vec_bytes: int
    loads: int
    grid: int


def ln_plan(n: int, d: int, dtype: torch.dtype, ptrs: Sequence[int],
            sms: int = H100_SMS) -> LnPlan:
    """The plan for x [n, d] of `dtype` whose x, y, scale and bias start
    at the addresses `ptrs`, on a card of `sms` SMs. Loads are as wide as
    D * itemsize and every pointer allow (16 bytes, else 8, 4, 2). A
    warp walks a grid-stride loop over rows with at most CTAS_PER_SM
    CTAs an SM."""
    item = dtype.itemsize
    if d > LANE_MAX * 32:
        return LnPlan("block", item, 0, n)
    where = d * item
    for p in ptrs:
        where |= p
    vec_bytes = min(16, where & -where)  # the widest power of two dividing all
    vec = vec_bytes // item
    per_lane = -(-(d // vec) // 32)
    loads = 1 << (per_lane - 1).bit_length()
    grid = min(-(-n // WARPS), sms * CTAS_PER_SM)
    return LnPlan("warp", vec_bytes, loads, grid)


@functools.cache
def _kernel():
    """The C entry point with its signature declared, built on first
    use (the decode loop launches this hundreds of times a batch)."""
    from .build import library

    fn = library("layer_norm").layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _plan_args(plan: LnPlan) -> tuple:
    """The plan as the C entry's arguments."""
    return int(plan.body == "warp"), plan.vec_bytes, plan.loads, plan.grid


@functools.lru_cache(maxsize=4096)
def _default_args(n: int, d: int, dtype: torch.dtype, low: int) -> tuple:
    """`ln_plan`'s arguments for pointers whose low four bits OR to
    `low`; cached, as the decode loop launches #1 at a few shapes
    thousands of times. The SMs are the current card's: a grid sized for
    another card is still right, as the warp body walks the rows
    grid-stride."""
    return _plan_args(ln_plan(n, d, dtype, (low,),
                              torch.cuda.get_device_properties(
                                  torch.cuda.current_device())
                              .multi_processor_count))


def _launch(x, scale, bias, eps, plan=None):
    """Checks the CUDA inputs and launches the kernel on `plan` (by
    default `ln_plan`'s)."""
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
    xp, yp, sp, bp = (x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                      bias.data_ptr())
    args = (_default_args(n, d, x.dtype, (xp | yp | sp | bp) & 15)
            if plan is None else _plan_args(plan))
    err = _kernel()(
        xp, sp, bp, yp, mean.data_ptr(), var.data_ptr(), n, d, eps,
        int(x.dtype == torch.bfloat16), *args, current_stream(x))
    check_launch("layer_norm", err)
    count_launch(layer_norm, x.dtype == torch.bfloat16)
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


def layer_norm_with(x, scale, bias, eps, plan):
    """The kernel on a given plan, with the wrapper's checks and count:
    for holding each plan against the plain version and timing the plans
    against each other. A plan the inputs do not allow raises."""
    return _launch(x, scale, bias, eps, plan)


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
