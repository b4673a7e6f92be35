"""Learning-rate schedules (reference
python/paddle/fluid/layers/learning_rate_scheduler.py; the port's copy
of paddle_tpu/layers/learning_rate_scheduler.py).

A schedule is a small op subgraph in the training program reading a
persistable global step counter, as in the reference, so the decay runs
inside each step (and inside a captured step: no op reads the host).
Each builds the same ops as the JAX package's, in the same order.
"""
from __future__ import annotations

import math

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper
from . import control_flow, nn, ops, tensor

__all__ = ["noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "piecewise_decay",
           "cosine_decay", "linear_lr_warmup", "append_LARS"]

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


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr · rate^(step / decay_steps), the exponent floored with
    `staircase`."""
    step = _global_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    return nn.scale(nn.elementwise_pow(
        tensor.fill_constant([1], "float32", decay_rate), div),
        scale=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr · exp(-rate · step / decay_steps)."""
    step = _global_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    return nn.scale(ops.exp(nn.scale(div, scale=-decay_rate)),
                    scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + rate · step / decay_steps)."""
    step = _global_step()
    div = nn.scale(step, scale=1.0 / decay_steps)
    if staircase:
        div = ops.floor(div)
    denom = nn.scale(div, scale=decay_rate, bias=1.0)
    return nn.elementwise_div(
        tensor.fill_constant([1], "float32", learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    """(lr - end) · (1 - step / decay_steps)^power + end, the step capped
    at decay_steps, or with `cycle` decay_steps stretched to the next
    multiple of itself at or above the step."""
    step = _global_step()
    if cycle:
        ratio = nn.scale(step, scale=1.0 / decay_steps)
        div = ops.ceil(nn.elementwise_max(
            ratio, tensor.fill_constant([1], "float32", 1e-12)))
        decay_steps_var = nn.scale(div, scale=float(decay_steps))
        frac = nn.elementwise_div(step, decay_steps_var)
    else:
        capped = nn.elementwise_min(
            step, tensor.fill_constant([1], "float32", float(decay_steps)))
        frac = nn.scale(capped, scale=1.0 / decay_steps)
    one_minus = nn.scale(frac, scale=-1.0, bias=1.0)
    poly = nn.elementwise_pow(
        one_minus, tensor.fill_constant([1], "float32", power))
    return nn.scale(poly, scale=learning_rate - end_learning_rate,
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i] (and past every boundary
    values[-1]), by arithmetic masks: segment i = below_i - below_(i-1)."""
    step = _global_step()
    prev = lr = None
    for i, b in enumerate(boundaries):
        below = nn.cast(control_flow.less_than_value(step, float(b)),
                        "float32")
        if prev is None:
            seg = below
        else:
            seg = nn.elementwise_mul(
                below, nn.scale(prev, scale=-1.0, bias=1.0))
        contrib = nn.scale(seg, scale=values[i])
        lr = contrib if lr is None else nn.elementwise_add(lr, contrib)
        prev = below
    tail = nn.scale(prev, scale=-1.0, bias=1.0)
    return nn.elementwise_add(lr, nn.scale(tail, scale=values[-1]))


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr · (cos(pi · epoch / epochs) + 1) / 2, epoch = floor(step /
    step_each_epoch)."""
    step = _global_step()
    epoch = ops.floor(nn.scale(step, scale=1.0 / step_each_epoch))
    cosv = ops.cos(nn.scale(epoch, scale=math.pi / epochs))
    return nn.scale(nn.scale(cosv, scale=0.5, bias=0.5),
                    scale=learning_rate)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr to end_lr linearly while step < warmup_steps, then
    `learning_rate` (a float or another schedule's variable)."""
    step = _global_step()
    if not isinstance(learning_rate, float):
        base = learning_rate
    else:
        base = tensor.fill_constant([1], "float32", learning_rate)
    frac = nn.elementwise_min(
        nn.scale(step, scale=1.0 / warmup_steps),
        tensor.fill_constant([1], "float32", 1.0))
    warm = nn.scale(frac, scale=end_lr - start_lr, bias=start_lr)
    mask = nn.cast(control_flow.less_than_value(step, float(warmup_steps)),
                   "float32")
    inv = nn.scale(mask, scale=-1.0, bias=1.0)
    return nn.elementwise_add(nn.elementwise_mul(warm, mask),
                              nn.elementwise_mul(base, inv))


def append_LARS(params_grads, learning_rate, weight_decay):
    """Each parameter's LARS rate, lr · |w| / (|g| + wd · |w|), as a list
    of [1] variables (``LarsMomentumOptimizer`` folds the same rate into
    its update op)."""

    def _norm(v):
        return ops.sqrt(nn.reduce_sum(ops.square(v)))

    out = []
    for param, grad in params_grads:
        pn = _norm(param)
        gn = _norm(grad)
        denom = gn + weight_decay * pn
        out.append(learning_rate * pn / denom)
    return out
