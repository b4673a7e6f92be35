"""Optimizer update ops: sgd, momentum, lars_momentum, adam, adamax,
adagrad, decayed_adagrad, adadelta, rmsprop, ftrl, dpsgd and Deep
Gradient Compression's dgc_momentum, dgc and dgc_clip_by_norm (the
port's subset of ``paddle_tpu/ops/optimizer_ops.py``, and
dgc_clip_by_norm of ``extra_ops2.py``, their formulas in the same order
of operations; reference operators/optimizers/sgd_op.cc,
momentum_op.cc, lars_momentum_op.cc, adam_op.cc, adamax_op.cc,
adagrad_op.cc, decayed_adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc,
ftrl_op.cc, dpsgd_op.cc, dgc_op.cc, dgc_clip_by_norm_op.h).

Optimizers are graph ops, as in the reference: each reads Param and its
accumulators and writes ParamOut and the accumulator outs, which the
optimizer names with the same vars, so the Executor commits the new
values to the scope in place of the old. The kernels are functional:
they allocate the new values and never write into the tensors they
read (a scope tensor may share its memory with a caller's numpy array).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from ..parallel import dgc as _dgc
from .tensor_ops import _constant


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


@register_op("momentum", differentiable=False)
def momentum(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    v = ctx.input("Velocity")
    lr = ctx.input("LearningRate").reshape(())
    mu = ctx.attr("mu")
    v_out = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("lars_momentum", differentiable=False)
def lars_momentum(ctx):
    """Momentum with the layer-wise rate lr·coeff·|p| / (|g| + wd·|p|)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    v = ctx.input("Velocity")
    lr = ctx.input("LearningRate").reshape(())
    mu = ctx.attr("mu")
    lars_coeff = ctx.attr("lars_coeff", 0.001)
    lars_wd = ctx.attr("lars_weight_decay", 0.0005)
    p_norm = torch.sqrt(torch.sum(p * p))
    g_norm = torch.sqrt(torch.sum(g * g))
    local_lr = lr * lars_coeff * p_norm / (
        g_norm + lars_wd * p_norm + 1e-9)
    v_out = mu * v + local_lr * (g + lars_wd * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


@register_op("adamax", differentiable=False)
def adamax(ctx):
    """Adam under the infinity norm. Beta1Pow is read, not advanced: the
    optimizer scales it once a step after every update
    (``AdamaxOptimizer._finish_update``)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    inf = ctx.input("InfNorm")
    b1p = ctx.input("Beta1Pow").reshape(())
    lr = ctx.input("LearningRate").reshape(())
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g) + eps)
    p_out = p - (lr / (1 - b1p)) * (m_out / inf_out)
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out}


@register_op("adagrad", differentiable=False)
def adagrad(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    eps = ctx.attr("epsilon", 1e-6)
    m_out = m + g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out, "MomentOut": m_out}


@register_op("decayed_adagrad", differentiable=False)
def decayed_adagrad(ctx):
    p, g = ctx.input("Param"), ctx.input("Grad")
    m = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * g * g
    p_out = p - lr * g / (torch.sqrt(m_out) + eps)
    return {"ParamOut": p_out, "MomentOut": m_out}


@register_op("adadelta", differentiable=False)
def adadelta(ctx):
    """No learning rate: the step is sqrt((E[dx^2] + eps) / (E[g^2] +
    eps)) g."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    asg = ctx.input("AvgSquaredGrad")
    asu = ctx.input("AvgSquaredUpdate")
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    asg_out = rho * asg + (1 - rho) * g * g
    update = -torch.sqrt((asu + eps) / (asg_out + eps)) * g
    asu_out = rho * asu + (1 - rho) * update * update
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg_out,
            "AvgSquaredUpdateOut": asu_out}


@register_op("rmsprop", differentiable=False)
def rmsprop(ctx):
    """With `centered` the mean square less the squared mean gradient
    (MeanGrad, advanced only then), with `momentum` a heavy ball."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    ms = ctx.input("MeanSquare")
    mom = ctx.input("Moment")
    lr = ctx.input("LearningRate").reshape(())
    rho = ctx.attr("decay", 0.9)
    eps = ctx.attr("epsilon", 1e-10)
    mu = ctx.attr("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * g * g
    out = {"MeanSquareOut": ms_out}
    if ctx.attr("centered", False):
        mg = ctx.input("MeanGrad")
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
        out["MeanGradOut"] = mg_out
    else:
        denom = ms_out + eps
    mom_out = mu * mom + lr * g / torch.sqrt(denom)
    out["MomentOut"] = mom_out
    out["ParamOut"] = p - mom_out
    return out


@register_op("ftrl", differentiable=False)
def ftrl(ctx):
    """Follow the regularized leader (McMahan et al. 2013): lr_power
    -0.5 takes square roots, any other power ``**``."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    sq = ctx.input("SquaredAccumulator")
    lin = ctx.input("LinearAccumulator")
    lr = ctx.input("LearningRate").reshape(())
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    lr_power = ctx.attr("lr_power", -0.5)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (new_sq ** -lr_power - sq ** -lr_power) / lr
    lin_out = lin + g - sigma * p
    if lr_power == -0.5:
        x = l2 + torch.sqrt(new_sq) / lr
    else:
        x = l2 + new_sq ** -lr_power / lr
    pre_shrink = (torch.sign(lin_out) * l1 - lin_out) / x
    p_out = torch.where(torch.abs(lin_out) > l1, pre_shrink,
                        torch.zeros_like(p))
    return {"ParamOut": p_out, "SquaredAccumOut": new_sq,
            "LinearAccumOut": lin_out}


def _sparsity(ctx):
    """The `sparsity` attr as a float32 tensor on the op's device, made
    once (a host copy at every step could not be captured)."""
    return _constant(ctx, lambda: torch.from_numpy(np.asarray(
        ctx.attr("sparsity", [0.999]), np.float32)).to(ctx.device))


def _step(ctx, slot):
    return ctx.input(slot).reshape(()).to(torch.int32)


@register_op("dgc_momentum", differentiable=False)
def dgc_momentum(ctx):
    """Deep Gradient Compression momentum (``parallel.dgc
    .dgc_momentum_step``): before rampup_begin_step the momentum op's
    update, then the update from the top (1 - sparsity) share of the
    accumulated velocity. CurrentStep is advanced once a step by the
    optimizer's own increment op, not here."""
    p_out, u_out, v_out = _dgc.dgc_momentum_step(
        ctx.input("Param"), ctx.input("Grad"), ctx.input("U"),
        ctx.input("V"), ctx.input("LearningRate").reshape(()),
        mu=ctx.attr("mu"), step=_step(ctx, "CurrentStep"),
        sparsity=_sparsity(ctx),
        rampup_begin_step=ctx.attr("rampup_begin_step", 0),
        rampup_step=ctx.attr("rampup_step", 1),
        use_nesterov=ctx.attr("use_nesterov", False))
    return {"ParamOut": p_out, "UOut": u_out, "VOut": v_out}


@register_op("dgc", differentiable=False)
def dgc(ctx):
    """DGC's gradient encode (reference dgc_op.h:38; ``parallel.dgc
    .dgc_encode``)."""
    u_out, v_out, encode, grad_out, k = _dgc.dgc_encode(
        ctx.input("U"), ctx.input("V"), ctx.input("Grad"),
        m=ctx.attr("m", 0.9), step=_step(ctx, "current_step"),
        sparsity=_sparsity(ctx),
        rampup_begin_step=int(ctx.attr("rampup_begin_step", 0.0)),
        rampup_step=int(ctx.attr("rampup_step", 1.0)),
        use_nesterov=ctx.attr("use_nesterov", True))
    return {"U_out": u_out, "V_out": v_out, "EncodeGrad": encode,
            "Grad_out": grad_out, "k": k}


@register_op("dgc_clip_by_norm", differentiable=False)
def dgc_clip_by_norm(ctx):
    """clip_by_norm from rampup_begin_step on; before it (read from the
    device step, current_step) X passes through."""
    x = ctx.input("X")
    maxn = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    clipped = torch.where(norm > maxn, x * (maxn / norm), x)
    step = ctx.input("current_step")
    if step is None:
        return clipped
    return torch.where(step.reshape(()) < ctx.attr("rampup_begin_step", 0.0),
                       x, clipped)


@register_op("dpsgd", differentiable=False, needs_rng=True)
def dpsgd(ctx):
    """Differentially private SGD (reference dpsgd_op.cc): the gradient
    clipped to L2 norm `clip`, plus Gaussian noise of std sigma * clip
    drawn on the device from the step key (``OpContext.normal``: each
    step draws anew, a replayed step draws what the eager one does; the
    JAX package's threefry noise is matched in distribution only)."""
    p, g = ctx.input("Param"), ctx.input("Grad")
    lr = ctx.input("LearningRate").reshape(())
    clip = ctx.attr("clip", 10.0)
    sigma = ctx.attr("sigma", 1.0)
    norm = torch.sqrt(torch.sum(g * g))
    g = g * torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    noise = sigma * clip * ctx.normal(g.shape, g.dtype, g.device)
    return {"ParamOut": p - lr * (g + noise)}
