"""Deep Gradient Compression (Lin et al., ICLR'18): the port's copy of
the per-worker math of ``paddle_tpu/parallel/dgc.py`` (reference
DGCMomentumOptimizer, python/paddle/fluid/optimizer.py:589, and the
selection of details/all_reduce_op_handle.cc:65-227).

* ``rampup_sparsity``: the sparsity schedule, a device scalar.
* ``_correct_and_select``: momentum correction, then the entries of the
  accumulated velocity at or above the sparsity's quantile of |v|.
* ``dgc_momentum_step``: what the ``dgc_momentum`` op runs; before
  rampup_begin_step exactly the momentum op.
* ``dgc_encode``: what the ``dgc`` op runs.

Every value stays on the device (the step counter too), so a training
step that holds these ops can be captured in a CUDA graph. The
collective forms (``compressed_allreduce``, ``dgc_allreduce_step``) are
not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["rampup_sparsity", "quantile", "dgc_momentum_step",
           "dgc_encode"]


def rampup_sparsity(step, sparsity, rampup_begin_step, rampup_step):
    """The sparsity at device step `step` (a 0-d int tensor): 0 before
    rampup_begin_step, then the entries of `sparsity` (a float32 tensor
    on the step's device) walked over rampup_step steps, the last one
    held after."""
    n = sparsity.shape[0]
    t = (step - rampup_begin_step).to(torch.float32)
    seg = torch.clamp(torch.floor(t * n / max(rampup_step, 1)), 0, n - 1)
    s = sparsity[seg.to(torch.int64)]
    return torch.where(step < rampup_begin_step, torch.zeros_like(s), s)


def quantile(flat, q):
    """``jnp.quantile(flat, q)``, linear interpolation between the two
    order statistics around q (n - 1), in fp32 as there. A sort, so no
    size limit (``torch.quantile`` refuses more than 2^24 elements) and
    no host sync."""
    vals, _ = torch.sort(flat)
    n = vals.shape[0]
    pos = q * (n - 1)
    low = torch.floor(pos)
    high_w = pos - low
    low_i = torch.clamp(low, 0, n - 1).to(torch.int64)
    high_i = torch.clamp(torch.ceil(pos), 0, n - 1).to(torch.int64)
    return vals[low_i] * (1.0 - high_w) + vals[high_i] * high_w


def _correct_and_select(u, v, g, *, m, s, use_nesterov=False):
    """(u_c, v_c, mask, send): the corrected accumulators, the entries
    sent (|v_c| at or above the s-quantile of |v_c|; all when s <= 0)
    and v_c masked to them."""
    if use_nesterov:
        u_c = m * (u + g)
        v_c = v + u_c + g
    else:
        u_c = m * u + g
        v_c = v + u_c
    thr = quantile(torch.abs(v_c.reshape(-1)), torch.clamp(s, 0.0, 1.0))
    mask = (torch.abs(v_c) >= thr) | (s <= 0.0)
    send = torch.where(mask, v_c, torch.zeros_like(v_c))
    return u_c, v_c, mask, send


def dgc_momentum_step(p, g, u, v, lr, *, mu, step, sparsity,
                      rampup_begin_step, rampup_step, use_nesterov=False):
    """One DGC momentum step on one (already reduced) gradient: before
    rampup_begin_step the momentum op's update; after it u <- mu u + g,
    v <- v + u, p <- p - lr send, and the sent entries of u and v
    zeroed (momentum factor masking). Returns (p, u, v)."""
    s = rampup_sparsity(step, sparsity, rampup_begin_step, rampup_step)
    u_dense = mu * u + g
    if use_nesterov:
        p_dense = p - lr * (g + mu * u_dense)
    else:
        p_dense = p - lr * u_dense
    # the correction is the plain one here whatever use_nesterov: the
    # lookahead lives in the dense update, as in the JAX package
    u_c, v_c, mask, send = _correct_and_select(u, v, g, m=mu, s=s)
    zero = torch.zeros_like(v_c)
    dense = step < rampup_begin_step
    return (torch.where(dense, p_dense, p - lr * send),
            torch.where(dense, u_dense, torch.where(mask, zero, u_c)),
            torch.where(dense, v, torch.where(mask, zero, v_c)))


def dgc_encode(u, v, g, *, m, step, sparsity, rampup_begin_step,
               rampup_step, use_nesterov=False):
    """The ``dgc`` op's math (reference operators/dgc_op.h:38): the
    corrected accumulators with the sent entries zeroed, EncodeGrad (a
    dense tensor of the sent entries; the JAX package's static-shape
    form of the reference's 2k (index, value) buffer), Grad_out zeroed,
    and k the count sent; before rampup_begin_step u, v and the
    gradient pass through and nothing is encoded. Returns (u_out, v_out,
    encode_grad, grad_out, k)."""
    s = rampup_sparsity(step, sparsity, rampup_begin_step, rampup_step)
    u_c, v_c, mask, encode = _correct_and_select(
        u, v, g, m=m, s=s, use_nesterov=use_nesterov)
    k = torch.sum(mask.to(torch.float32))
    dense = step < rampup_begin_step
    zero = torch.zeros_like(v_c)
    return (torch.where(dense, u, torch.where(mask, zero, u_c)),
            torch.where(dense, v, torch.where(mask, zero, v_c)),
            torch.where(dense, zero, encode),
            torch.where(dense, g, torch.zeros_like(g)),
            torch.where(dense, torch.zeros_like(k), k))
