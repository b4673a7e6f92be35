"""Unary op layers (reference python/paddle/fluid/layers/ops.py; the
port's subset of paddle_tpu/layers/ops.py: the ops it registers)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["rsqrt"]


def rsqrt(x, name=None):
    helper = LayerHelper("rsqrt", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("rsqrt", {"X": x}, {"Out": out}, {})
    return out
