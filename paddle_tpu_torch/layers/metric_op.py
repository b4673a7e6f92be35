"""Metric layers (reference python/paddle/fluid/layers/metric_op.py; the
port's subset of paddle_tpu/layers/metric_op.py: accuracy)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    """The share of rows whose label is among the k largest of `input`:
    a top_k op, then an accuracy op. `correct` and `total`, if given,
    receive the int32 [1] counts."""
    helper = LayerHelper("accuracy", input=input)
    topk_out = helper.create_variable_for_type_inference(input.dtype)
    topk_indices = helper.create_variable_for_type_inference("int32", True)
    helper.append_op("top_k", {"X": input},
                     {"Out": topk_out, "Indices": topk_indices}, {"k": k})
    acc_out = helper.create_variable_for_type_inference("float32", True)
    correct = correct or helper.create_variable_for_type_inference(
        "int32", True)
    total = total or helper.create_variable_for_type_inference(
        "int32", True)
    helper.append_op(
        "accuracy",
        {"Out": topk_out, "Indices": topk_indices, "Label": label},
        {"Accuracy": acc_out, "Correct": correct, "Total": total}, {})
    return acc_out
