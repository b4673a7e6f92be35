"""Weight-decay regularizers (the port's copy of
``paddle_tpu/regularizer.py``; reference
python/paddle/fluid/regularizer.py).

``Optimizer.apply_gradients`` calls ``append_regularization_ops`` after
clipping: each parameter's grad becomes grad + coeff * param (L2) or
grad + coeff * sign(param) (L1), through ``scale``, ``sign`` and
``sum`` ops before the optimizer ops. A parameter's own regularizer
(``ParamAttr(regularizer=...)``) takes the place of the optimizer's.
"""
from __future__ import annotations

from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer",
           "L2DecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = LayerHelper("l2_decay").create_variable_for_type_inference(
            param.dtype)
        block.append_op("scale", {"X": param}, {"Out": decay},
                        {"scale": self._coeff, "op_role": "backward"})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(param.dtype)
        decay = helper.create_variable_for_type_inference(param.dtype)
        block.append_op("sign", {"X": param}, {"Out": sign},
                        {"op_role": "backward"})
        block.append_op("scale", {"X": sign}, {"Out": decay},
                        {"scale": self._coeff, "op_role": "backward"})
        return decay


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(parameters_and_grads, regularization=None):
    """Each (param, grad) with grad + its decay term summed into
    ``<grad>@REGULARIZED``; a parameter's own regularizer overrides
    `regularization`, and a pair with neither passes unchanged."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        term = reg(param, grad, block)
        new_grad = block.create_var(name=grad.name + "@REGULARIZED",
                                    shape=grad.shape, dtype=grad.dtype)
        block.append_op("sum", {"X": [grad, term]}, {"Out": new_grad},
                        {"op_role": "backward"})
        params_and_grads.append((param, new_grad))
    return params_and_grads
