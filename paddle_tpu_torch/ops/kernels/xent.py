"""Fused softmax cross-entropy with hard labels: the CUDA kernels
``csrc/xent.cu`` and their plain PyTorch versions (counterpart of
``paddle_tpu/ops/pallas/xent.py``).

    xent_forward(logits [N,V], label [N])       -> (loss f32 [N], lse f32 [N])
    xent_backward(logits [N,V], label [N], g [N]) -> dlogits [N,V]

loss = (1-eps)(lse - x[label]) + eps(lse - mean x), 0 where label ==
ignore_index; dlogits = (softmax - (1-eps)onehot - eps/V)·g, a zero row
where label == ignore_index, in the logits' dtype. A label outside
[0, V) picks 0 and matches no column. Logits are fp32 or bf16; the
arithmetic is fp32. Neither direction keeps an [N, V] intermediate:
the backward recomputes lse from the logits. The forward kernel takes
a plan by V (a group of lanes a row at V <= 32, a warp a row, a block a
row for wide rows; ``csrc/xent.cu`` `fwd_lanes`), the backward one by
V too (CTAs a row in a cluster, `bwd_plan`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (check_launch, count_launch, current_stream,
               require_cuda_inputs)


def _target_parts(logits, label):
    """fp32 logits, int64 labels, and the per-row validity of the label
    as a column index."""
    x = logits.float()
    lab = label.long()
    inside = (lab >= 0) & (lab < x.shape[1])
    return x, lab, inside


def xent_forward_plain(logits, label, eps=0.0, ignore_index=-100):
    x, lab, inside = _target_parts(logits, label)
    lse = torch.logsumexp(x, dim=1)
    picked = x.gather(1, torch.where(inside, lab, 0)[:, None])[:, 0]
    loss = lse - torch.where(inside, picked, torch.zeros_like(picked))
    if eps:
        loss = (1.0 - eps) * loss + eps * (lse - x.mean(dim=1))
    loss = torch.where(lab == ignore_index, torch.zeros_like(loss), loss)
    return loss, lse


def xent_backward_plain(logits, label, dloss, eps=0.0, ignore_index=-100):
    x, lab, inside = _target_parts(logits, label)
    v = x.shape[1]
    sm = torch.exp(x - torch.logsumexp(x, dim=1, keepdim=True))
    cols = torch.arange(v, device=x.device)
    onehot = (cols[None, :] == lab[:, None]).float()
    tgt = (1.0 - eps) * onehot + (eps / v if eps else 0.0)
    g = torch.where(lab == ignore_index, torch.zeros_like(dloss.float()),
                    dloss.float())
    return ((sm - tgt) * g[:, None]).to(logits.dtype)


@functools.cache
def _kernel(direction):
    """The C entry point `xent_<direction>` with its signature declared:
    (four pointers, n, v, eps, ignore_index, bf16, stream)."""
    from .build import library

    fn = getattr(library("xent"), f"xent_{direction}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, logits, label):
    """The CUDA path's checks; returns the labels as contiguous int64."""
    require_cuda_inputs(name, (logits,), (torch.float32, torch.bfloat16))
    n, v = logits.shape
    if label.shape != (n,) or label.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: label must be int [{n}], got "
                         f"{tuple(label.shape)} {label.dtype}")
    if label.device != logits.device:
        raise ValueError(f"{name}: label on {label.device}, logits on "
                         f"{logits.device}")
    if v >= 2 ** 31:
        raise ValueError(f"{name}: V = {v} does not fit an int")
    return label.to(torch.int64).contiguous()


def xent_forward(logits, label, eps=0.0, ignore_index=-100):
    """logits [N,V] fp32/bf16, label int [N] -> (loss, lse), fp32 [N]."""
    n = logits.shape[0]
    if logits.device.type == "meta":
        loss = torch.empty(n, dtype=torch.float32, device=logits.device)
        return loss, torch.empty_like(loss)
    if logits.device.type == "cpu":
        return xent_forward_plain(logits, label, eps, ignore_index)
    if logits.device.type != "cuda":
        raise ValueError(f"xent_forward: no kernel for device "
                         f"{logits.device}")
    lab = _check("xent_forward", logits, label)
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    err = _kernel("fwd")(
        logits.data_ptr(), lab.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        n, logits.shape[1], float(eps), int(ignore_index),
        int(logits.dtype == torch.bfloat16), current_stream(logits))
    count_launch(xent_forward)
    check_launch("xent_forward", err)
    return loss, lse


def xent_backward(logits, label, dloss, eps=0.0, ignore_index=-100):
    """logits [N,V], label int [N], dloss [N] (taken as fp32) ->
    dlogits [N,V] in the logits' dtype."""
    if logits.device.type == "meta":
        return torch.empty_like(logits)
    if logits.device.type == "cpu":
        return xent_backward_plain(logits, label, dloss, eps, ignore_index)
    if logits.device.type != "cuda":
        raise ValueError(f"xent_backward: no kernel for device "
                         f"{logits.device}")
    lab = _check("xent_backward", logits, label)
    n = logits.shape[0]
    if dloss.shape != (n,) or dloss.device != logits.device:
        raise ValueError(f"xent_backward: dloss must be [{n}] on "
                         f"{logits.device}, got {tuple(dloss.shape)} on "
                         f"{dloss.device}")
    g = dloss.to(torch.float32).contiguous()
    dx = torch.empty_like(logits)
    if n == 0:
        return dx
    err = _kernel("bwd")(
        logits.data_ptr(), lab.data_ptr(), g.data_ptr(), dx.data_ptr(), n,
        logits.shape[1], float(eps), int(ignore_index),
        int(logits.dtype == torch.bfloat16), current_stream(logits))
    count_launch(xent_backward)
    check_launch("xent_backward", err)
    return dx


xent_forward.launches = 0
xent_backward.launches = 0
