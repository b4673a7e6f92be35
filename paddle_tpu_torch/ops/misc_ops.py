"""Ops with no other home: the port's subset of
``paddle_tpu/ops/misc_ops.py``.
"""
from __future__ import annotations

from ..core.registry import register_op


@register_op("optimization_barrier", differentiable=False)
def optimization_barrier(ctx):
    """Out = X, the same tensor. The recompute planner
    (``backward._emit_recompute``) puts one between a recomputed
    segment's clones and each value they read from outside it. In the JAX
    package it keeps XLA's CSE from merging the clones back into the
    forward ops (``jax.lax.optimization_barrier``); the port runs its ops
    one by one and has no CSE to stop, so here it is the identity. Out
    shares X's storage: the Executor drops a value after its last reader
    by dropping a reference, so X's storage lives while Out is read."""
    return {"Out": ctx.input("X")}
