"""Paged-KV pool ops (the paged layout of models/decode_engine.py):
``masked_pool_write``, the port's copy of
``paddle_tpu/ops/paged_ops.py``, and ``paged_decode_attention``, an op
the JAX package does not register.

The shared block pool follows vLLM's PagedAttention block tables: the
pool is one persistable tensor, lanes address it through host-allocated
int32 tables, and every write goes through ``masked_pool_write``.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .kernels import paged_attention as KPA


@register_op("masked_pool_write", differentiable=False)
def masked_pool_write(ctx):
    """Indexed row write into a shared KV pool, in place.

    inputs: Pool [N0(, N1), ...tail] (the pool var, also the op's
    output); New [R, ...tail]; Index [R] int (the flattened leading
    index of each row's target cell); Gate [R] optional 0/1. attrs:
    leading_dims (how many leading Pool axes Index addresses),
    exclusive_via (why the rows' targets cannot alias: "block_table",
    "host_indices" or "cow_dst", as in the JAX package). All slots are
    non-differentiable.

    Gated-off and out-of-range rows write nothing; a cell hit by a
    kept row takes exactly its new value. The JAX package scatters
    into a copy of the pool padded with a trash row. The port writes
    the pool's own storage instead: a new pool per layer per tick
    would copy 8 MiB twelve times a tick at Transformer-base's paged
    serving shape. A row that writes nothing is pointed at the cell of
    the first kept row with that row's value (or, with no kept row, at
    cell 0 with its current value), so every copy into a cell carries
    the same value and the order of the copies does not matter. Kept
    rows target distinct cells: that is the exclusivity contract the
    host allocator keeps (padded admission rows aim at the dustbin
    entry, where whatever lands is garbage by design). The ownership
    prover's index marks of the JAX package (analysis metadata) are
    not carried over.
    """
    pool = ctx.input("Pool")
    if pool.device.type == "meta":
        return pool
    new = ctx.input("New")
    idx = ctx.input("Index")
    gate = ctx.input("Gate")
    lead = int(ctx.attr("leading_dims", 1))
    n = 1
    for d in pool.shape[:lead]:
        n *= int(d)
    flat = pool.view(n, -1)
    rows = new.shape[0]
    vals = new.reshape(rows, -1).to(flat.dtype)
    idx = idx.reshape(rows).to(torch.int64)
    keep = (idx >= 0) & (idx < n)
    if gate is not None:
        keep = keep & (gate.reshape(rows) > 0)
    first = torch.argmax(keep.to(torch.int32))
    any_keep = keep.any()
    tgt = torch.where(keep, idx, idx[first])
    tgt = torch.where(any_keep, tgt, torch.zeros_like(tgt))
    src = torch.where(keep[:, None], vals, vals[first][None])
    src = torch.where(any_keep, src, flat[0][None])
    flat.index_copy_(0, tgt, src)
    return pool


@register_op("paged_decode_attention", differentiable=False)
def paged_decode_attention(ctx):
    """Single-query self-attention of the paged decode step over the
    shared pools, through the block table.

    inputs: Q [R,H,1,Dh]; PoolK, PoolV [NB,BS,H,Dh]; BlockTab [R,NP]
    int32; Step [R] int64 (positions <= Step are visible). attr: scale.
    output: Out [R,H,1,Dh].

    The JAX package registers no such op: its Pallas kernel
    (``paddle_tpu/ops/pallas/paged_attention.py``, whose docstring at
    lines 1-20 names it the intended lowering of this step) was never
    routed, and its paged step computes the same function as a gather
    of the dense [R,H,maxT,Dh] view followed by a biased softmax
    (``decode_engine._PagedLaneCache``, ``decode_engine.py:412-451``,
    and ``cached_decoder_step``). The port routes that computation
    here, so the card runs kernel #9 (``csrc/paged_attention.cu``); on
    the CPU the op runs the kernel's plain version, the reference's
    ``paged_decode_attention_reference``.
    """
    q = ctx.input("Q")
    r, h, _, d = q.shape
    out = KPA.paged_decode_attention(
        q.reshape(r, h, d).contiguous(), ctx.input("PoolK"),
        ctx.input("PoolV"), ctx.input("BlockTab"), ctx.input("Step"),
        ctx.attr("scale", 1.0))
    return out.reshape(r, h, 1, d)
