"""Gradient clipping (the port's copy of ``paddle_tpu/clip.py``;
reference python/paddle/fluid/clip.py: ErrorClipByValue,
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
set_gradient_clip).

``Optimizer.apply_gradients`` calls ``append_gradient_clip_ops`` on the
(param, grad) pairs before regularization: each parameter's clip, set
with ``set_gradient_clip`` or ``ParamAttr(gradient_clip=...)``, appends
its ops and hands on the clipped grad. The parameters of one
``GradientClipByGlobalNorm`` group are scaled together by
clip_norm / max(global norm, clip_norm), the global norm taken over all
of their grads.
"""
from __future__ import annotations

__all__ = ["ErrorClipByValue", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "set_gradient_clip", "append_gradient_clip_ops",
           "error_clip_callback"]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    """Clips a forward variable's grad to [min, max] (min defaults to
    -max) when an ``append_backward`` callback asks it to."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _append_clip_op(self, block, grad_name):
        block.append_op("clip", {"X": grad_name}, {"Out": grad_name},
                        {"min": self.min, "max": self.max,
                         "op_role": "backward"})


def error_clip_callback(block, context):
    """The default ``append_backward`` callback of ``Optimizer.backward``:
    does nothing, as in the JAX package."""


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """grad limited to [min, max] element by element."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=grad.shape,
                               dtype=grad.dtype)
        block.append_op("clip", {"X": grad}, {"Out": out},
                        {"min": self.min, "max": self.max,
                         "op_role": "backward"})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    """grad scaled to L2 norm clip_norm where its own norm is larger."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(name=grad.name + "@CLIP", shape=grad.shape,
                               dtype=grad.dtype)
        block.append_op("clip_by_norm", {"X": grad}, {"Out": out},
                        {"max_norm": self.clip_norm, "op_role": "backward"})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Every grad of the group `group_name` scaled by
    clip_norm / max(global norm, clip_norm)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        group = context.setdefault(self.group_name,
                                   {"grads": [], "clip_norm": self.clip_norm})
        group["grads"].append((param, grad))

    def _create_operators(self, param, grad):
        return param, grad  # the group's ops: _apply_global_norm_group


def _apply_global_norm_group(group):
    """sqrt(sum of each grad's squared_l2_norm), then each grad times
    clip_norm / max(that, clip_norm): the ops of one global-norm group
    (``paddle_tpu/clip.py`` ``_apply_global_norm_group``)."""
    grads = group["grads"]
    first = grads[0][1]
    block = first.block

    def scalar(name):
        return block.create_var(name=name, shape=(1,), dtype=first.dtype)

    sq_sums = []
    for _, g in grads:
        sq = g.block.create_var(name=g.name + "@SQSUM", shape=(1,),
                                dtype=g.dtype)
        g.block.append_op("squared_l2_norm", {"X": g}, {"Out": sq},
                          {"op_role": "backward"})
        sq_sums.append(sq)
    total = scalar(first.name + "@GLOBALSQ")
    block.append_op("sum", {"X": sq_sums}, {"Out": total},
                    {"op_role": "backward"})
    gnorm = scalar(first.name + "@GNORM")
    block.append_op("sqrt", {"X": total}, {"Out": gnorm},
                    {"op_role": "backward"})
    denom, cn_var = scalar(gnorm.name + "@MAX"), scalar(gnorm.name + "@CN")
    block.append_op("fill_constant", {}, {"Out": cn_var},
                    {"shape": [1], "dtype": "float32",
                     "value": float(group["clip_norm"]),
                     "op_role": "backward"})
    block.append_op("elementwise_max", {"X": gnorm, "Y": cn_var},
                    {"Out": denom}, {"op_role": "backward"})
    scale_var = scalar(gnorm.name + "@SCALE")
    block.append_op("elementwise_div", {"X": cn_var, "Y": denom},
                    {"Out": scale_var}, {"op_role": "backward"})
    result = []
    for p, g in grads:
        out = g.block.create_var(name=g.name + "@GCLIP", shape=g.shape,
                                 dtype=g.dtype)
        g.block.append_op("elementwise_mul", {"X": g, "Y": scale_var},
                          {"Out": out}, {"axis": -1, "op_role": "backward"})
        result.append((p, out))
    return result


def set_gradient_clip(clip, param_list=None, program=None):
    """`clip` for the parameters of `param_list` (Parameters or names;
    default: every parameter of `program`, the default main program),
    kept on each parameter as Fluid keeps it (``gradient_clip_attr``)."""
    from .core.program import default_main_program

    program = program or default_main_program()
    if param_list is None:
        param_list = program.all_parameters()
    block = program.global_block
    for p in param_list:
        param = block.var(p) if isinstance(p, str) else p
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    """Each (param, grad) with its parameter's clip applied: the
    per-parameter clips in order, then each global-norm group's pairs."""
    context = {}
    result = []
    for p, g in param_grads:
        if g is None:
            result.append((p, g))
            continue
        clip = getattr(p, "gradient_clip_attr", None) \
            or getattr(p, "error_clip", None)
        if clip is None:
            result.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            clip._process_context(context, p, g)
        else:
            result.append(clip._create_operators(p, g))
    for group in context.values():
        result.extend(_apply_global_norm_group(group))
    return result
