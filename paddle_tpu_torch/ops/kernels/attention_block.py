"""The whole self-attention sub-layer: the CUDA kernels
``csrc/attention_block.cu`` (forward and backward) with their plain
PyTorch versions (counterpart of ``paddle_tpu/ops/pallas/attention_block.py``).

    attention_block(x [B,T,D], wqkv [D,3D], wo [D,D], n_heads, scale,
                    causal)                               -> out [B,T,D]
    attention_block_bwd(x, wqkv, wo, p [B,H,T,T], g [B,T,D], n_heads,
                        scale, causal)                    -> (dx, dwqkv, dwo)

out = merge(softmax(scale q k^T [causal]) v) Wo with q|k|v = x Wqkv split
into H heads of D/H; no projection biases, no residual. On the card
``attention_block`` is differentiable, as the JAX package's
``custom_vjp`` is: under a vjp the forward kernel also writes the
normalized P, and the backward kernel takes the gradients from it with no
exp. P is fp32, for bf16 inputs too (the TPU kernel saves bf16, which
the port's 1e-5 gradient parity would not hold; at Transformer-base's
width the JAX package's gate refuses its kernel and it differentiates
`attention_block_reference`, whose P is fp32). The primal call, as the
Executor's forward op makes it under ``no_grad``, writes no P.

bf16 (as AMP calls the op: it is on the WHITE list): x, Wqkv, Wo and g
bf16, every product computed in fp32 on their exact values and the
intermediates (qkv, ctx, P, dctx, dqkv) fp32 quantities, as the TPU kernel
upcasts; out, dx and the weight gradients rounded once to bf16. The plain
versions compute the same contract and stay the CPU path. The bf16
kernels run their dense products on wgmma fed by TMA
(``csrc/wgmma_bf16.cuh``, the FFN block's engine) and keep every fp32
intermediate but the forward's qkv and the saved P as two bf16 planes,
hi = bf16(v) and lo = bf16(v - hi), in its fp32 scratch's bytes
(`scratch_planes`): the forward's scores q k^T take fp32 q and k (planed
ones put P 2-6e-6 from float64, over the 1e-6 it is held to), and its
attention stage writes ctx as planes; the backward's attention stages run
on the planes of qkv, ctx, dctx and dqkv, the saved P and dS split into
planes where they enter a product. `attention_block_planes_plain`
computes what they compute.

Where the kernels run: ``usable`` keeps the reference's structural
conditions (3-D x, Wqkv [D, 3D], D % H == 0, 8 <= T <= 512, T % 8 == 0,
D/H % 8 == 0, x and Wqkv both fp32 or both bf16) and the kernels' own
limit D/H <= 128 (the backward's shared memory and registers). It drops
the reference's batch grouping and its VMEM estimate against 12 MiB, a
TPU condition that refuses Transformer-base's width (D 512 at batch 64,
T 256: on a TPU the op then computes the reference composition). So on
the card these kernels run at full width, where the TPU would not run
its own. The kernels take fp32 and bf16 (every input of one dtype): on
the card a bf16 call, as AMP makes it (the op is on the WHITE list),
launches the bf16 instances; a call the kernels refuse raises and never
runs the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (check_launch, count_launch, current_stream, masked_logits,
               on_card, require_block_inputs, storage_tensor)
from .bf16_planes import planes_sum

MAX_T = 512
MAX_HEAD_DIM = 128
# the backward's weight gradients' row slices (tile_mma.cuh,
# wgmma_bf16.cuh), 16 MB
WORKSPACE_FLOATS = 1 << 22
# the dtypes the JAX package's gate takes, and the kernels
BLOCK_DTYPES = (torch.float32, torch.bfloat16)


def usable(x, w_qkv, n_heads) -> bool:
    """Whether the kernels take these shapes (see the module docstring)."""
    if x.dim() != 3 or w_qkv.dim() != 2:
        return False
    _, t, d = x.shape
    if tuple(w_qkv.shape) != (d, 3 * d) or d % n_heads:
        return False
    dh = d // n_heads
    return (8 <= t <= MAX_T and t % 8 == 0 and dh % 8 == 0
            and dh <= MAX_HEAD_DIM
            and x.dtype == w_qkv.dtype and x.dtype in BLOCK_DTYPES)


def _heads(z, n_heads):
    """[B,T,D] -> [B,H,T,D/H]."""
    b, t, _ = z.shape
    return z.reshape(b, t, n_heads, -1).transpose(1, 2)


def _merge(z):
    """[B,H,T,Dh] -> [B,T,H*Dh]."""
    b, _, t, _ = z.shape
    return z.transpose(1, 2).reshape(b, t, -1)


def attention_block_fwd_plain(x, wqkv, wo, n_heads, scale, causal,
                              save_p=False):
    """`attention_block_reference` (fp32 arithmetic, the output in x's
    dtype); with `save_p` also the normalized P [B, H, T, T] fp32."""
    d = x.shape[-1]
    qkv = x.float() @ wqkv.float()
    q, k, v = (_heads(z, n_heads) for z in qkv.split(d, dim=2))
    p = torch.softmax(masked_logits(q, k, scale, causal), dim=-1)
    out = (_merge(p @ v) @ wo.float()).to(x.dtype)
    return (out, p) if save_p else out


def attention_block_plain(x, wqkv, wo, n_heads, scale, causal):
    """The forward kernel's function (`attention_block_reference`)."""
    return attention_block_fwd_plain(x, wqkv, wo, n_heads, scale, causal)


def attention_block_bwd_plain(x, wqkv, wo, p, g, n_heads, scale,
                              causal=False):
    """`_bwd_impl`: (dx, dwqkv, dwo) from the saved P and the output's
    cotangent g, with no exp; qkv and the context are recomputed. `causal`
    only lets the kernel skip the tiles where P is 0."""
    b, t, d = x.shape
    xf, p, g = x.float(), p.float(), g.float()
    qkv = xf @ wqkv.float()
    q, k, v = (_heads(z, n_heads) for z in qkv.split(d, dim=2))
    ctx = _merge(p @ v)
    dwo = ctx.reshape(-1, d).T @ g.reshape(-1, d)
    dctx = _heads(g @ wo.float().T, n_heads)
    dv = p.transpose(-1, -2) @ dctx
    dp = dctx @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = ds @ k * scale
    dk = ds.transpose(-1, -2) @ q * scale
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=2)
    dwqkv = xf.reshape(-1, d).T @ dqkv.reshape(-1, 3 * d)
    dx = dqkv @ wqkv.float().T
    return dx.to(x.dtype), dwqkv.to(wqkv.dtype), dwo.to(wo.dtype)


def attention_block_planes_plain(x, wqkv, wo, g, n_heads, scale, causal,
                                 p=None, qk_planes=False, dqkv_terms=2):
    """#10 and #11 as the bf16 kernels compute them, every product in
    fp32: the forward's scores from fp32 q and k, ctx kept as hi + lo
    bf16 planes; the backward (from `p`, else the forward's own P) with
    qkv, ctx, dctx and dqkv as planes (`dqkv_terms` 1: a kernel that
    dropped dqkv's low plane), P and dS as planes where they enter a
    product, delta = rowsum(dctx ctx). `qk_planes`: q and k as planes in
    the scores too (a design that misses P's limit). Returns (out, P,
    (dx, dwqkv, dwo))."""
    b, t, d = x.shape
    xf, gf, wq, wof = x.float(), g.float(), wqkv.float(), wo.float()
    qkv = xf @ wq
    q, k, v = (_heads(z, n_heads) for z in qkv.split(d, dim=2))
    if qk_planes:
        q, k = planes_sum(q), planes_sum(k)
    p_fwd = torch.softmax(masked_logits(q, k, scale, causal), dim=-1)
    out = (planes_sum(_merge(p_fwd @ v)) @ wof).to(x.dtype)
    p = p_fwd if p is None else p.float()
    q, k, v = (_heads(z, n_heads)
               for z in planes_sum(qkv).split(d, dim=2))
    pp = planes_sum(p)
    ctx = planes_sum(_merge(pp @ v))
    dctx = planes_sum(gf @ wof.T)
    delta = _heads(dctx * ctx, n_heads).sum(-1, keepdim=True)
    dch = _heads(dctx, n_heads)
    dv = pp.transpose(-1, -2) @ dch
    ds = planes_sum(p * (dch @ v.transpose(-1, -2) - delta))
    dq = ds @ k * scale
    dk = ds.transpose(-1, -2) @ q * scale
    dqkv = planes_sum(torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=2),
                      dqkv_terms)
    dwqkv = xf.reshape(-1, d).T @ dqkv.reshape(-1, 3 * d)
    dwo = ctx.reshape(-1, d).T @ gf.reshape(-1, d)
    return out, p_fwd, ((dqkv @ wq.T).to(x.dtype), dwqkv.to(wqkv.dtype),
                        dwo.to(wo.dtype))


@functools.cache
def _kernel(entry, n_ptrs, with_workspace, dtype=torch.float32):
    """The C entry point `entry` (its `_bf16` instance for bf16 `dtype`)
    with its signature declared: (`n_ptrs` pointers, [workspace size,] b,
    t, d, h, scale, causal, stream)."""
    from .build import library

    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    fn = getattr(library("attention_block"), entry + suffix)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + (
        [ctypes.c_int64] if with_workspace else []) + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, wqkv, wo, n_heads, p=None, g=None):
    """The CUDA path's checks: x, Wqkv, Wo (and g) all fp32 or all bf16, P
    fp32, contiguous, on x's device, the shapes the kernels index them by
    and take."""
    require_block_inputs(name, (x, wqkv, wo) + ((g,) if g is not None
                                                else ()),
                         fp32=() if p is None else (p,))
    if not usable(x, wqkv, n_heads):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, wqkv {tuple(wqkv.shape)} with "
            f"{n_heads} heads: needs [B,T,D], [D,3D], 8 <= T <= {MAX_T}, "
            f"T % 8 == 0, D/H % 8 == 0, D/H <= {MAX_HEAD_DIM}")
    b, t, d = x.shape
    if b * n_heads > 65535:
        raise ValueError(f"{name}: B*H = {b * n_heads} > 65535")
    shapes = [(wo, (d, d))]
    if p is not None:
        shapes += [(p, (b, n_heads, t, t)), (g, tuple(x.shape))]
    for a, shape in shapes:
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: got shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")


def attention_block(x, wqkv, wo, n_heads, scale, causal=False):
    """x [B,T,D], wqkv [D,3D], wo [D,D] -> [B,T,D]."""
    if x.device.type == "meta":
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return attention_block_plain(x, wqkv, wo, n_heads, scale, causal)
    if x.device.type != "cuda":
        raise ValueError(f"attention_block: no kernel for device {x.device}")
    return on_card(AttentionBlockFn, _attention_block_launch, x, wqkv, wo,
                   n_heads, scale, causal)


def _attention_block_launch(x, wqkv, wo, n_heads, scale, causal, save_p):
    _check("attention_block", x, wqkv, wo, n_heads)
    b, t, d = x.shape
    out = torch.empty_like(x)
    p = torch.empty(b, n_heads, t, t, dtype=torch.float32,
                    device=x.device) if save_p else None
    f32 = dict(dtype=torch.float32, device=x.device)
    qkv = torch.empty(b * t, 3 * d, **f32)
    ctx = torch.empty(b * t, d, **f32)
    err = _kernel("attention_block_fwd", 7, False, x.dtype)(
        x.data_ptr(), wqkv.data_ptr(), wo.data_ptr(), out.data_ptr(),
        0 if p is None else p.data_ptr(), qkv.data_ptr(), ctx.data_ptr(),
        b, t, d, n_heads, float(scale), int(bool(causal)), current_stream(x))
    count_launch(attention_block)
    check_launch("attention_block", err)
    return (out, p) if save_p else out


def attention_block_bwd(x, wqkv, wo, p, g, n_heads, scale, causal=False):
    """(dx, dwqkv, dwo) of attention_block from its saved P [B,H,T,T] and
    the output's cotangent g [B,T,D]."""
    if x.device.type == "meta":
        return (torch.empty_like(x), torch.empty_like(wqkv),
                torch.empty_like(wo))
    if x.device.type == "cpu":
        return attention_block_bwd_plain(x, wqkv, wo, p, g, n_heads, scale,
                                         causal)
    if x.device.type != "cuda":
        raise ValueError(f"attention_block_bwd: no kernel for device "
                         f"{x.device}")
    b, t, d = x.shape
    _check("attention_block_bwd", x, wqkv, wo, n_heads, p, g)
    dx, dwqkv, dwo = (torch.empty_like(a) for a in (x, wqkv, wo))
    f32 = dict(dtype=torch.float32, device=x.device)
    qkv, dqkv = (torch.empty(b * t, 3 * d, **f32) for _ in range(2))
    ctx, dctx = (torch.empty(b * t, d, **f32) for _ in range(2))
    rowsum = torch.empty(b * n_heads, t, **f32)
    ws = torch.empty(WORKSPACE_FLOATS, **f32)
    err = _kernel("attention_block_bwd", 14, True, x.dtype)(
        *(a.data_ptr() for a in (x, wqkv, wo, p, g, dx, dwqkv, dwo, qkv, ctx,
                                 dctx, dqkv, rowsum, ws)),
        WORKSPACE_FLOATS, b, t, d, n_heads, float(scale), int(bool(causal)),
        current_stream(x))
    count_launch(attention_block_bwd)
    check_launch("attention_block_bwd", err)
    return dx, dwqkv, dwo


class AttentionBlockFn(torch.autograd.Function):
    """`attention_block`'s ``custom_vjp`` (`_fwd` / `_bwd`) as an
    autograd.Function: the forward kernel also saves P, an output marked
    non-differentiable (a `setup_context` Function, the form `torch.func`
    accepts, may save only inputs and outputs); the backward launches the
    backward kernel on the saved tensors with torch.func's wrappers taken
    off."""

    @staticmethod
    def forward(x, wqkv, wo, n_heads, scale, causal):
        return _attention_block_launch(x, wqkv, wo, n_heads, scale, causal,
                                       True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, wqkv, wo, ctx.n_heads, ctx.scale, ctx.causal = inputs
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(x, wqkv, wo, output[1])

    @staticmethod
    def backward(ctx, dout, _dp):
        x, wqkv, wo, p, g = map(storage_tensor, (*ctx.saved_tensors, dout))
        return (*attention_block_bwd(x, wqkv, wo, p, g.contiguous(),
                                     ctx.n_heads, ctx.scale, ctx.causal),
                None, None, None)


attention_block.launches = 0
attention_block_bwd.launches = 0
