"""Control-flow ops: ``while`` and ``run_block_if`` (counterparts of
``paddle_tpu/ops/control_flow_ops.py:36, 76``; reference
operators/controlflow/while_op.cc, conditional_block_op.cc).

The JAX package lowers ``while`` to ``lax.while_loop``; here, as in the
reference, the op interprets its sub-block in a Python loop. Each
iteration reads the condition back to the host once. ``run_block_if``
reads nothing back: it runs its sub-block every time and keeps the
new values where the condition holds, so a step that holds it can be
captured in a CUDA graph.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op, run_op


def _no_infer(op, block):
    return None


@register_op("while", infer_shape=_no_infer, differentiable=False)
def while_op(ctx):
    """inputs: Condition (bool, carried: the body must update it),
    X = externals (read-only), Init = carried initial values.
    outputs: Out = carried finals. attrs: sub_block, carried,
    externals."""
    sub = ctx.attr("sub_block")
    carried = list(ctx.attr("carried"))
    cond_name = ctx.op.inputs["Condition"][0]
    env = dict(zip(ctx.attr("externals"), ctx.inputs("X")))
    env.update(zip(carried, ctx.inputs("Init")))
    if cond_name not in env:
        raise ValueError(
            f"while: condition var {cond_name!r} is neither carried nor "
            f"external — the loop body must update it")
    while bool(env[cond_name].reshape(())):
        for op in sub.ops:
            run_op(op, env, ctx.device, ctx.seed, key=ctx.key, dkey=ctx.dkey)
    return {"Out": [env[n] for n in carried]}


@register_op("run_block_if", infer_shape=_no_infer, differentiable=False,
             stop_gradient_slots=("Condition",))
def run_block_if(ctx):
    """Run a sub-block iff Condition, carrying the vars it writes (the
    JAX package's ``lax.cond`` with the identity as the false branch;
    GradientMergeOptimizer gates its optimize section on the k-th
    micro-step with it).

    inputs: Condition, X = externals (read-only), Init = carried values.
    outputs: Out = carried finals. attrs: sub_block, carried, externals.

    The block runs on every call and each carried var takes
    ``torch.where(cond, new, old)``: for a block with no side effect
    outside its carried vars, what ``lax.cond`` gives, with no host
    sync. The untaken block's work is spent all the same."""
    sub = ctx.attr("sub_block")
    carried = list(ctx.attr("carried"))
    env = dict(zip(ctx.attr("externals"), ctx.inputs("X")))
    init = ctx.inputs("Init")
    env.update(zip(carried, init))
    for op in sub.ops:
        run_op(op, env, ctx.device, ctx.seed, key=ctx.key, dkey=ctx.dkey)
    cond = ctx.input("Condition").reshape(()).to(torch.bool)
    return {"Out": [torch.where(cond, env[n], old)
                    for n, old in zip(carried, init)]}
