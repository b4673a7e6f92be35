"""The bf16 fused-block kernels' planes (``csrc/wgmma_bf16.cuh``): an
fp32 intermediate kept as two bf16 planes, hi = bf16(v) and lo = bf16(v -
hi) (hi + lo within 2^-17 of v), in its fp32 scratch's bytes, and the
operand layouts of the engine's products, with `product_bf16`, one of
them alone (the engine's test entry). ``ffn_block`` (h, dh) and
``attention_block`` (ctx; in the backward also qkv, dctx and dqkv) keep
their intermediates so.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import check_launch, current_stream, require_block_inputs


def _planes(v, terms):
    """fp32 `v` as `terms` bf16 planes [terms, ...]: hi = bf16(v), then
    (2 terms) lo = bf16(v - hi)."""
    hi = v.to(torch.bfloat16)
    if terms == 1:
        return hi[None]
    return torch.stack([hi, (v - hi.float()).to(torch.bfloat16)])


def planes_sum(v, terms=2):
    """fp32 `v` as the bf16 kernels keep it: the sum of its `terms` bf16
    planes, in fp32."""
    return _planes(v, terms).float().sum(0)


def scratch_planes(h, n, f):
    """The bf16 kernels' (hi, lo) planes [n, f] in the fp32 scratch h
    [n, f]: its bytes, hi first."""
    return h.reshape(-1).view(torch.bfloat16).view(2, n, f).unbind(0)


# The bf16 kernels' products, each with its operand layout: (name, A
# MN-major, B MN-major, planes of A, planes of B). K-major A is [m][k],
# MN-major [k][m]; K-major B is [n][k], MN-major [k][n]. The FFN block runs
# layouts 0-5; the attention block runs x Wqkv (0; 6 in its backward), ctx
# Wo (1), ctx^T g (2), g Wo^T (3, into planes), x^T dqkv (4) and dqkv
# Wqkv^T (5). Layout 6 is layout 0 with C written as two bf16 planes.
PRODUCT_LAYOUTS = (
    ("x W1", False, True, 1, 1),
    ("h W2", False, True, 2, 1),
    ("h^T g", True, True, 2, 1),
    ("g W2^T", False, False, 1, 1),
    ("x^T dh", True, True, 1, 2),
    ("dh W1^T", False, False, 2, 1),
    ("x Wqkv into planes", False, True, 1, 1),
)
# the layout whose C comes back as hi + lo planes
SPLIT_LAYOUT = 6


def layout_operands(layout, a, b):
    """A [m, k] and B [k, n] (fp32) laid out as product `layout` reads
    them: bf16 planes [P, rows, cols], contiguous, K-major or MN-major."""
    _, ta, tb, pa, pb = PRODUCT_LAYOUTS[layout]
    return (_planes((a.T if ta else a).contiguous(), pa).contiguous(),
            _planes((b if tb else b.T).contiguous(), pb).contiguous())


def product_bf16(layout, a, b, m, n, k, group=4):
    """C [m, n] fp32 = A B from operands as `layout_operands` lays them:
    on the card one product of the bf16 kernels' engine (unsplit; `group`
    64-deep slabs a fresh accumulator takes, as the kernels' 4, or 0 for
    one accumulator over all of k), on the CPU the plain product of the
    planes' sums; `SPLIT_LAYOUT` gives the sum of C's two planes."""
    _, ta, tb, _, _ = PRODUCT_LAYOUTS[layout]
    if a.device.type == "cpu":
        am, bm = a.float().sum(0), b.float().sum(0)
        c = (am.T if ta else am) @ (bm if tb else bm.T)
        return planes_sum(c) if layout == SPLIT_LAYOUT else c
    require_block_inputs("product_bf16", (a, b))
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    check_launch("product_bf16", _product_kernel()(
        layout, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, group,
        current_stream(a)))
    if layout == SPLIT_LAYOUT:
        hi, lo = scratch_planes(c, m, n)
        return hi.float() + lo.float()
    return c


@functools.cache
def _product_kernel():
    """The C entry `wgmma_product_bf16` (built with the FFN block) with
    its signature declared: (layout, a, b, c, m, n, k, group, stream)."""
    from .build import library

    fn = library("ffn_block").wgmma_product_bf16
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
