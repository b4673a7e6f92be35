"""Control-flow ops: ``while`` (counterpart of
``paddle_tpu/ops/control_flow_ops.py:36``; reference
operators/controlflow/while_op.cc).

The JAX package lowers ``while`` to ``lax.while_loop``; here, as in the
reference, the op interprets its sub-block in a Python loop. Each
iteration reads the condition back to the host once.
"""
from __future__ import annotations

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
