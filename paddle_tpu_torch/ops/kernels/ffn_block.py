"""The whole position-wise MLP sub-layer: the CUDA kernels
``csrc/ffn_block.cu`` (forward and backward) with their plain PyTorch
versions (counterpart of ``paddle_tpu/ops/pallas/ffn_block.py``).

    ffn_block(x [...,D], w1 [D,F], b1 [F], w2 [F,D], b2 [D]) -> out [...,D]
    ffn_block_bwd(x, w1, b1, w2, g [...,D]) -> (dx, dw1, db1, dw2, db2)

out = relu(x W1 + b1) W2 + b2. On the card ``ffn_block`` is
differentiable, as the JAX package's ``custom_vjp`` is: the backward
kernel recomputes the hidden from x and takes all five gradients.

Where the kernels run: ``usable`` keeps the reference's structural
conditions (3-D x, W1 [D, F], T, D and F multiples of 8, x and W1 both
fp32 or both bf16) and drops
its batch grouping and its VMEM estimate against 12 MiB, a TPU condition
that refuses Transformer-base's width at every shape (D 512, F 2048: the
weights alone take most of it; on a TPU the op then computes the
reference composition). The kernels take any width, so on the card they
run at full width, where the TPU would not run its own. The kernels take
fp32 and bf16 (every input of one dtype).

bf16 (as AMP calls the op: it is on the WHITE list): x, the weights, the
biases and g bf16, every product computed in fp32 on their exact values
and the hidden h and dh fp32 quantities, as the TPU kernel upcasts; out,
dx and the weight and bias gradients rounded once to bf16. The plain
versions compute the same contract and stay the CPU path. The bf16
kernels (wgmma fed by TMA, ``csrc/wgmma_bf16.cuh``) keep h and dh as two
bf16 planes, hi = bf16(v) and lo = bf16(v - hi), in the fp32 scratch's
bytes: `ffn_block_planes_plain` computes what they compute, and
``bf16_planes.scratch_planes`` reads the scratch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (check_launch, count_launch, current_stream,
               require_block_inputs, require_cuda_inputs, storage_tensor)
from .bf16_planes import planes_sum

# the weight gradients' row slices and the column sums (tile_mma.cuh,
# wgmma_bf16.cuh)
WORKSPACE_FLOATS = 1 << 22
# the dtypes the JAX package's gate takes, and the kernels
BLOCK_DTYPES = (torch.float32, torch.bfloat16)


def usable(x, w1) -> bool:
    """Whether the kernels take these shapes (see the module docstring)."""
    if x.dim() != 3 or w1.dim() != 2:
        return False
    _, t, d = x.shape
    f = w1.shape[1]
    return (w1.shape[0] == d and t % 8 == 0 and d % 8 == 0 and f % 8 == 0
            and x.dtype == w1.dtype and x.dtype in BLOCK_DTYPES)


def ffn_block_plain(x, w1, b1, w2, b2):
    """`ffn_block_reference`: fp32 arithmetic, the output in x's dtype."""
    h = torch.relu(x.float() @ w1.float() + b1.float())
    return (h @ w2.float() + b2.float()).to(x.dtype)


def ffn_block_bwd_plain(x, w1, b1, w2, g):
    """`_bwd_impl`: (dx, dw1, db1, dw2, db2) from the output's cotangent
    g, the hidden recomputed from x."""
    d, f = w1.shape
    x2, g2 = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    pre = x2 @ w1.float() + b1.float()
    h = torch.relu(pre)
    dh = torch.where(pre > 0, g2 @ w2.float().T, 0.0)
    dx = (dh @ w1.float().T).reshape(x.shape).to(x.dtype)
    return (dx, (x2.T @ dh).to(w1.dtype), dh.sum(0).to(b1.dtype),
            (h.T @ g2).to(w2.dtype), g2.sum(0).to(w2.dtype))


def ffn_block_planes_plain(x, w1, b1, w2, b2, g, h_terms=2, dh_terms=2):
    """#12 and #13 as the bf16 kernels compute them: h and dh kept as
    `h_terms` and `dh_terms` bf16 planes (2: hi + lo, within 2^-17 of the
    fp32 value; 1: a kernel that dropped the low plane), the ReLU mask
    hi + lo > 0, every product in fp32. Returns (out, (dx, dw1, db1, dw2,
    db2))."""
    d = w1.shape[0]
    x2, g2 = x.reshape(-1, d).float(), g.reshape(-1, d).float()
    h = planes_sum(torch.relu(x2 @ w1.float() + b1.float()), h_terms)
    out = (h @ w2.float() + b2.float()).reshape(x.shape).to(x.dtype)
    dh = planes_sum(torch.where(h > 0, g2 @ w2.float().T, 0.0), dh_terms)
    return out, ((dh @ w1.float().T).reshape(x.shape).to(x.dtype),
                 (x2.T @ dh).to(w1.dtype), dh.sum(0).to(b1.dtype),
                 (h.T @ g2).to(w2.dtype), g2.sum(0).to(w2.dtype))


@functools.cache
def _kernel(entry, n_ptrs, with_workspace, dtype=torch.float32):
    """The C entry point `entry` (its `_bf16` instance for bf16 `dtype`)
    with its signature declared: (`n_ptrs` pointers, [workspace size,]
    rows, d, f, stream)."""
    from .build import library

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    fn = getattr(library("ffn_block"), entry + suffix)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + (
        [ctypes.c_int64] if with_workspace else []) + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, w1, b1, w2, last, last_is_bias):
    """The CUDA path's checks: all fp32 or all bf16, contiguous, on x's
    device, and the shapes against x [..., D] and W1 [D, F]; `last` is b2
    [D] (`last_is_bias`) or g shaped like x. Returns (rows, D, F)."""
    biases = (b1, last) if last_is_bias else (b1,)
    require_block_inputs(name, (x, w1, w2) + (() if last_is_bias
                                              else (last,)))
    require_cuda_inputs(name, (x, *biases), (x.dtype,))
    if w1.dim() != 2 or x.shape[-1] != w1.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w1 "
                         f"{tuple(w1.shape)} are not [..., D] and [D, F]")
    d, f = w1.shape
    want_last = (d,) if last_is_bias else tuple(x.shape)
    for t, shape in ((b1, (f,)), (w2, (f, d)), (last, want_last)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: got shape {tuple(t.shape)}, "
                             f"expected {shape}")
    return x.numel() // d, d, f


def ffn_block(x, w1, b1, w2, b2):
    """x [..., D] -> [..., D]."""
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return ffn_block_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_block: no kernel for device {x.device}")
    return _on_card(x, w1, b1, w2, b2)


def _on_card(*args):
    """The wrapper's CUDA path: under a vjp (grad mode on and an input
    tracked) the differentiable Function, else the launch alone."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return FfnBlockFn.apply(*args)
    return _ffn_block_launch(*args)


def _ffn_block_launch(x, w1, b1, w2, b2):
    n, d, f = _check("ffn_block", x, w1, b1, w2, b2, True)
    out = torch.empty_like(x)
    # fp32 h, or (bf16) its hi and lo planes in the same bytes
    h = torch.empty(n, f, dtype=torch.float32, device=x.device)
    err = _kernel("ffn_block_fwd", 7, False, x.dtype)(
        *(a.data_ptr() for a in (x, w1, b1, w2, b2, out, h)), n, d, f,
        current_stream(x))
    count_launch(ffn_block)
    check_launch("ffn_block", err)
    return out


def ffn_block_bwd(x, w1, b1, w2, g):
    """(dx, dw1, db1, dw2, db2) of ffn_block from the output's cotangent
    g [..., D]."""
    if x.device.type == "meta":
        return (torch.empty_like(x), torch.empty_like(w1),
                torch.empty_like(b1), torch.empty_like(w2),
                x.new_empty(w1.shape[0]))
    if x.device.type == "cpu":
        return ffn_block_bwd_plain(x, w1, b1, w2, g)
    if x.device.type != "cuda":
        raise ValueError(f"ffn_block_bwd: no kernel for device {x.device}")
    n, d, f = _check("ffn_block_bwd", x, w1, b1, w2, g, False)
    dx, dw1, db1, dw2 = (torch.empty_like(a) for a in (x, w1, b1, w2))
    db2 = x.new_empty(d)
    f32 = dict(dtype=torch.float32, device=x.device)
    h = torch.empty(n, f, **f32)
    ws_floats = max(WORKSPACE_FLOATS, f)
    ws = torch.empty(ws_floats, **f32)
    err = _kernel("ffn_block_bwd", 12, True, x.dtype)(
        *(a.data_ptr() for a in (x, w1, b1, w2, g, dx, dw1, db1, dw2, db2, h,
                                 ws)), ws_floats, n, d, f, current_stream(x))
    count_launch(ffn_block_bwd)
    check_launch("ffn_block_bwd", err)
    return dx, dw1, db1, dw2, db2


class FfnBlockFn(torch.autograd.Function):
    """`ffn_block`'s ``custom_vjp`` (`_fwd` / `_bwd`) as an
    autograd.Function in the `setup_context` form `torch.func` accepts:
    the forward kernel saves nothing but the inputs; the backward launches
    the backward kernel on them with torch.func's wrappers taken off."""

    @staticmethod
    def forward(x, w1, b1, w2, b2):
        return _ffn_block_launch(x, w1, b1, w2, b2)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dout):
        x, w1, b1, w2, _, g = map(storage_tensor, (*ctx.saved_tensors, dout))
        return ffn_block_bwd(x, w1, b1, w2, g.contiguous())


ffn_block.launches = 0
ffn_block_bwd.launches = 0
