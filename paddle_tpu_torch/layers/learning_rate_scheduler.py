"""Learning-rate schedules (reference
python/paddle/fluid/layers/learning_rate_scheduler.py; the port's copy
of noam_decay from paddle_tpu/layers/learning_rate_scheduler.py).

A schedule is a small op subgraph in the training program reading a
persistable global step counter, as in the reference, so the decay runs
inside each step.
"""
from __future__ import annotations

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import nn, ops, tensor

__all__ = ["noam_decay"]

_STEP_COUNTER = "@LR_DECAY_COUNTER@"


def _global_step():
    """The float32 [1] step counter, set to 0 by the startup program and
    advanced by one at the start of each step (op_role lr_sched, so
    ``Program.clone(for_test=True)`` drops the increment)."""
    helper = LayerHelper("global_step_counter")
    counter = helper.main_program.global_block.create_var(
        name=_STEP_COUNTER, shape=(1,), dtype="float32",
        persistable=True, stop_gradient=True)
    sblock = helper.startup_program.global_block
    svar = sblock.create_var(name=_STEP_COUNTER, shape=(1,),
                             dtype="float32", persistable=True)
    if not any(_STEP_COUNTER in op.output_arg_names for op in sblock.ops):
        ConstantInitializer(0.0)(svar, sblock)
    block = helper.main_program.current_block()
    if not any(_STEP_COUNTER in op.output_arg_names
               and op.type == "increment" for op in block.ops):
        block.append_op("increment", {"X": counter}, {"Out": counter},
                        {"step": 1.0, "op_role": "lr_sched"})
    return counter


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 · min(step^-0.5, step · warmup_steps^-1.5)."""
    step = _global_step()
    a = ops.rsqrt(nn.elementwise_max(
        step, tensor.fill_constant([1], "float32", 1.0)))
    b = nn.scale(step, scale=warmup_steps ** -1.5)
    return nn.scale(nn.elementwise_min(a, b), scale=d_model ** -0.5)
