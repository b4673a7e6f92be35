"""Dense math, elementwise ops with fluid axis broadcasting, relu,
rsqrt, sqrt, exp, log, square, cos, floor, ceil, sign, reduce_sum,
squared_l2_norm, mean and comparisons: the port's subset of
``paddle_tpu/ops/math_ops.py`` (reference mul_op.cc, matmul_op.cc,
elementwise_op_function.h, activation_op.cc, reduce_ops/,
squared_l2_norm_op.cc, mean_op.cc, compare_op.cc). Their grads come from
the generic vjp maker; sign, floor and ceil have none, and
elementwise_pow's vjp takes JAX's derivative rules (`_Pow`).

The matrix products go to ``torch.matmul``, as the JAX package leaves
them to XLA; TF32 is off wherever the port runs on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op


def _flatten2d(x, num_col_dims):
    lead = int(np.prod(x.shape[:num_col_dims])) if num_col_dims else 1
    return x.reshape(lead, -1)


@register_op("mul")
def mul(ctx):
    """reference mul_op.cc: flatten X/Y to 2-D then matmul."""
    x, y = ctx.input("X"), ctx.input("Y")
    xnc = ctx.attr("x_num_col_dims", 1)
    ync = ctx.attr("y_num_col_dims", 1)
    y2 = y.reshape(int(np.prod(y.shape[:ync])), -1)
    out = torch.matmul(_flatten2d(x, xnc), y2)
    return out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))


@register_op("matmul")
def matmul(ctx):
    """reference matmul_op.cc: batched matmul with transpose flags+alpha."""
    x, y = ctx.input("X"), ctx.input("Y")
    tx, ty = ctx.attr("transpose_X", False), ctx.attr("transpose_Y", False)
    if x.dim() == 1:
        x = x[None, :] if not tx else x[:, None]
    if y.dim() == 1:
        y = y[:, None] if not ty else y[None, :]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return out


def _broadcast_y(x, y, axis):
    """fluid semantics: Y broadcasts against X starting at `axis`."""
    if x.shape == y.shape:
        return y
    if axis == -1 or axis is None:
        axis = x.dim() - y.dim()
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > x.dim() - axis:
        yshape.pop()
    return y.reshape([1] * axis + yshape
                     + [1] * (x.dim() - axis - len(yshape)))


def _ew(fn):
    def kernel(ctx):
        x, y = ctx.input("X"), ctx.input("Y")
        return fn(x, _broadcast_y(x, y, ctx.attr("axis", -1)))

    return kernel


register_op("elementwise_add")(_ew(torch.add))
register_op("elementwise_sub")(_ew(torch.sub))
register_op("elementwise_mul")(_ew(torch.mul))
register_op("elementwise_div")(_ew(torch.div))
register_op("elementwise_min")(_ew(torch.minimum))
register_op("elementwise_max")(_ew(torch.maximum))
# the floored remainder, the divisor's sign, as ``jnp.mod``
register_op("elementwise_mod", differentiable=False)(_ew(torch.remainder))


def _sum_to(g, shape):
    """`g` summed over the axes along which `shape` was broadcast."""
    lead = g.dim() - len(shape)
    if lead:
        g = g.sum(dim=tuple(range(lead)))
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _Pow(torch.autograd.Function):
    """x ** y with ``jax.lax.pow``'s derivatives, which torch's differ from
    at base 0: d/dx = y x^(y-1) (NaN at x = y = 0, where torch gives 0;
    with an integer y, 0 where y == 0), d/dy = log(x or 1 where x == 0)
    x^y (NaN at x = 0, y < 0, where torch gives -inf)."""

    @staticmethod
    def forward(x, y):
        return torch.pow(x, y)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, g):
        x, y, out = ctx.saved_tensors
        dx = dy = None
        if ctx.needs_input_grad[0]:
            yf = y.to(x.dtype)
            jac = yf * torch.pow(x, yf - 1)
            if not y.is_floating_point():
                jac = torch.where(y == 0, torch.zeros_like(jac), jac)
            dx = _sum_to(g * jac, x.shape)
        if ctx.needs_input_grad[1]:
            safe = torch.where(x == 0, torch.ones_like(x), x)
            dy = _sum_to(g * (torch.log(safe) * out), y.shape)
        return dx, dy


@register_op("elementwise_pow")
def elementwise_pow(ctx):
    """x ** y, Y broadcast from `axis` (``jnp.power``)."""
    x, y = ctx.input("X"), ctx.input("Y")
    return _Pow.apply(x, _broadcast_y(x, y, ctx.attr("axis", -1)))


@register_op("relu")
def relu(ctx):
    return torch.relu(ctx.input("X"))


@register_op("rsqrt")
def rsqrt(ctx):
    return torch.rsqrt(ctx.input("X"))


@register_op("sqrt")
def sqrt(ctx):
    return torch.sqrt(ctx.input("X"))


@register_op("exp")
def exp(ctx):
    return torch.exp(ctx.input("X"))


@register_op("log")
def log(ctx):
    return torch.log(ctx.input("X"))


@register_op("square")
def square(ctx):
    x = ctx.input("X")
    return x * x


@register_op("cos")
def cos(ctx):
    return torch.cos(ctx.input("X"))


@register_op("floor", differentiable=False)
def floor(ctx):
    return torch.floor(ctx.input("X"))


@register_op("ceil", differentiable=False)
def ceil(ctx):
    return torch.ceil(ctx.input("X"))


@register_op("sign", differentiable=False)
def sign(ctx):
    """-1 or 1, and X itself where X is 0, -0 or NaN, as ``jnp.sign``
    gives them (``torch.sign`` maps NaN to 0)."""
    x = ctx.input("X")
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


@register_op("squared_l2_norm")
def squared_l2_norm(ctx):
    """The sum of squares of every element, shape [1]."""
    x = ctx.input("X")
    return torch.sum(x * x).reshape(1)


@register_op("reduce_sum")
def reduce_sum(ctx):
    x = ctx.input("X")
    if ctx.attr("reduce_all", False):
        dims = tuple(range(x.dim()))
    else:
        dims = tuple(d % x.dim() for d in ctx.attr("dim", [0]))
        if not dims:  # jnp.sum(x, axis=()) sums over no axis
            return x
    return torch.sum(x, dim=dims, keepdim=ctx.attr("keep_dim", False))


@register_op("reduce_max", differentiable=False)
def reduce_max(ctx):
    x = ctx.input("X")
    if ctx.attr("reduce_all", False):
        dims = tuple(range(x.dim()))
    else:
        dims = tuple(d % x.dim() for d in ctx.attr("dim", [0]))
        if not dims:
            return x
    return torch.amax(x, dim=dims, keepdim=ctx.attr("keep_dim", False))


@register_op("mean")
def mean(ctx):
    """Output shape [1], as fluid's mean_op.cc. An integer or bool X
    gives float32, as ``jnp.mean`` promotes it."""
    x = ctx.input("X")
    if not x.is_floating_point():
        x = x.to(torch.float32)
    return torch.mean(x).reshape(1)


def _cmp(fn, type_name):
    def kernel(ctx):
        return fn(ctx.input("X"), ctx.input("Y"))

    register_op(type_name, differentiable=False)(kernel)


_cmp(torch.lt, "less_than")
_cmp(torch.gt, "greater_than")
_cmp(torch.eq, "equal")
