"""Unary op layers (reference python/paddle/fluid/layers/ops.py; the
port's subset of paddle_tpu/layers/ops.py: the unary ops it registers)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

_UNARY = ["exp", "log", "sqrt", "rsqrt", "square", "floor", "ceil",
          "cos", "sign"]

__all__ = list(_UNARY)


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, input=x, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(op_type, {"X": x}, {"Out": out}, {})
        return out

    layer.__name__ = op_type
    return layer


_g = globals()
for _t in _UNARY:
    _g[_t] = _make_unary(_t)
