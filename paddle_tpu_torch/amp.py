"""Automatic mixed precision in bf16 (counterpart of
``paddle_tpu/amp.py``).

The policy layer: ``core.registry.run_op`` consults it on every op.

* WHITE ops (the matrix products: matmul, fc, attention, embedding):
  float32 inputs are cast to bfloat16, so the product runs in bf16 on
  the tensor cores and its activations flow onward in bf16.
* BLACK ops (softmax, losses, norm statistics, reductions, optimizer
  updates): bfloat16 inputs are cast up to float32. Parameters are never
  stored in bf16, so the optimizer ops always update fp32 masters.
* Everything else is elementwise glue: when enabled, mixed bf16/fp32
  float inputs are harmonized down to bf16, except for a small KEEP set
  whose output dtype is part of its contract.

A grad op takes its forward op's color, and its kernel recomputes the
forward under ``torch.func.vjp`` on the inputs cast here, so the
backward sees the forward's dtypes: the recompute takes bf16 leaves and
gives bf16 grads, which the optimizer's BLACK cast brings up to fp32.

There is no GradScaler: bf16 has fp32's exponent range, so loss scaling
(which fp16 needs) is not needed, and the JAX package has none either.

Enable it per process with ``enable()``, the ``amp_guard`` context or the
``FLAGS_use_bf16`` environment variable. ``state_token()`` is part of the
Executor's cache keys: a program prepared or captured with AMP on is
another program than the same one with AMP off.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterable, Optional

import torch

# the matrix products: run in bf16
WHITE_LIST = {
    "mul", "matmul", "fc", "conv2d", "depthwise_conv2d",
    "conv2d_transpose", "conv3d", "conv3d_transpose", "attention",
    "attention_block", "ffn_block",
    "lookup_table", "sequence_conv", "bilinear_tensor_product",
}

# numerically sensitive ops: run in fp32
BLACK_LIST = {
    "softmax", "log_softmax",
    "cross_entropy", "sigmoid_cross_entropy_with_logits",
    "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "data_norm", "l2_normalize", "norm", "lrn",
    "mean", "reduce_mean", "reduce_sum", "reduce_prod", "sum",
    "exp", "log", "pow", "square", "rsqrt", "sqrt",
    "softmax_with_cross_entropy_smooth",
    # optimizer ops always touch fp32 master params
    "sgd", "momentum", "lars_momentum", "adam", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "dgc_momentum",
    "clip_by_norm", "squared_l2_norm",
    # accumulation / metric ops
    "accuracy", "auc", "increment",
}

# ops whose output dtype is part of their contract: no harmonize
KEEP_LIST = {"cast", "fill_constant", "assign", "one_hot", "range",
             "uniform_random", "gaussian_random", "eye",
             "fill_zeros_like", "fill_constant_batch_size_like",
             "share_data", "print", "is_empty", "shape",
             # manages its own precision: bf16 [N, V] logits stay put,
             # the xent kernels accumulate in fp32
             "softmax_with_cross_entropy"}

_enabled = [os.environ.get("FLAGS_use_bf16", "") in ("1", "true", "True")]


def enabled() -> bool:
    return _enabled[0]


def enable(on: bool = True) -> None:
    _enabled[0] = bool(on)


def state_token() -> bool:
    """Part of the Executor's cache keys: a program prepared (or captured
    in a CUDA graph) with AMP on runs other dtypes than with it off."""
    return _enabled[0]


@contextlib.contextmanager
def amp_guard(enable_flag: bool = True,
              custom_white_list: Optional[Iterable[str]] = None,
              custom_black_list: Optional[Iterable[str]] = None):
    """bf16 AMP for the programs run inside; `custom_white_list` and
    `custom_black_list` add op types to the lists for that time."""
    added_w = set(custom_white_list or ()) - WHITE_LIST
    added_b = set(custom_black_list or ()) - BLACK_LIST
    prev = _enabled[0]
    WHITE_LIST.update(added_w)
    BLACK_LIST.update(added_b)
    _enabled[0] = bool(enable_flag)
    try:
        yield
    finally:
        _enabled[0] = prev
        WHITE_LIST.difference_update(added_w)
        BLACK_LIST.difference_update(added_b)


def _is_f32(x) -> bool:
    return getattr(x, "dtype", None) == torch.float32


def _is_bf16(x) -> bool:
    return getattr(x, "dtype", None) == torch.bfloat16


def cast_op_inputs(op_type: str, inputs: dict) -> dict:
    """The AMP policy applied to a resolved {slot: [values]} input dict.

    ``run_op`` calls it for every op while AMP is enabled. A grad op
    follows its forward op's color (mul_grad is white like mul), so the
    forward recomputed inside its vjp sees the forward's dtypes."""
    base = op_type[:-5] if op_type.endswith("_grad") else op_type
    if base in WHITE_LIST:
        want, pred = torch.bfloat16, _is_f32
    elif base in BLACK_LIST:
        want, pred = torch.float32, _is_bf16
    elif base in KEEP_LIST:
        return inputs
    else:
        # harmonize: if any float input is bf16, bring fp32 ones down
        if not any(_is_bf16(v) for vals in inputs.values()
                   for v in vals if v is not None):
            return inputs
        want, pred = torch.bfloat16, _is_f32
    return {slot: [v.to(want) if v is not None and pred(v) else v
                   for v in vals]
            for slot, vals in inputs.items()}
