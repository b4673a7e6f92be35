"""Optimizer update ops: sgd and adam (the port's subset of
``paddle_tpu/ops/optimizer_ops.py``; reference
operators/optimizers/sgd_op.cc, adam_op.cc).

Optimizers are graph ops, as in the reference: each reads Param and its
accumulators and writes ParamOut and the accumulator outs, which the
optimizer names with the same vars, so the Executor commits the new
values to the scope in place of the old. The kernels are functional:
they allocate the new values and never write into the tensors they
read (a scope tensor may share its memory with a caller's numpy array).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("sgd", differentiable=False)
def sgd(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(())
    return {"ParamOut": p - lr * g}


@register_op("adam", differentiable=False)
def adam(ctx):
    """Adam with the bias corrections folded into the step size, and
    the beta-power accumulators advanced when the op names outputs for
    them (adam_op.h)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m1, m2 = ctx.input("Moment1"), ctx.input("Moment2")
    b1p = ctx.input("Beta1Pow").reshape(())
    b2p = ctx.input("Beta2Pow").reshape(())
    lr = ctx.input("LearningRate").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    out = {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out}
    if "Beta1PowOut" in ctx.op.outputs:
        out["Beta1PowOut"] = b1p.reshape(1) * b1
        out["Beta2PowOut"] = b2p.reshape(1) * b2
    return out
