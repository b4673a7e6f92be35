"""Paged single-query decode attention: the CUDA kernel
``csrc/paged_attention.cu`` and its plain PyTorch version (counterpart of
``paddle_tpu/ops/pallas/paged_attention.py``).

    paged_decode_attention(q [R,H,Dh], pool_k [NB,BS,H,Dh], pool_v,
                           block_tab [R,NP] int32, step [R], scale)
                                                      -> out [R,H,Dh]

Per lane r and head h: softmax over the cache positions t <= step[r] of
scale * q . k_t, where position t lives at pool[block_tab[r, t // BS],
t % BS]; the output is the weighted sum of the v_t. A lane with a
negative step sees no position and gets the average of v over all NP*BS
cells, as the reference's all-masked softmax gives. Forward only:
serving never differentiates it.

Where the kernel runs: ``usable`` keeps the reference's structural
conditions (pool heads and head dim equal q's, Dh % 8 == 0, BS % 8 == 0,
one table row per lane) and the kernel's own limit Dh <= 256 (a chunk of
positions and q's slices sized by Dh). The reference's TPU gate and its
``PADDLE_TPU_DISABLE_PAGED_ATTN`` switch have no counterpart: on a CUDA
tensor the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import (check_launch, count_launch, current_stream,
               require_cuda_inputs)

MAX_HEAD_DIM = 256


def usable(q, pool_k, block_tab) -> bool:
    """Whether the kernel takes these shapes. Reads only ``.shape``, so
    it answers for tensors and for a Program's variables alike; q may
    carry the op's query axis of 1 ([R,H,1,Dh])."""
    qs, ps, ts = tuple(q.shape), tuple(pool_k.shape), tuple(block_tab.shape)
    if len(qs) == 4 and qs[2] == 1:
        qs = (qs[0], qs[1], qs[3])
    if len(qs) != 3 or len(ps) != 4 or len(ts) != 2:
        return False
    r, h, d = qs
    _, bs, hp, dp = ps
    return (hp == h and dp == d and d % 8 == 0 and bs % 8 == 0
            and ts[0] == r and d <= MAX_HEAD_DIM)


def paged_decode_attention_plain(q, pool_k, pool_v, block_tab, step,
                                 scale=1.0):
    """The JAX package's ``paged_decode_attention_reference``: gather every
    lane's NP pages into a dense [R, NP*BS, H, Dh] view, score, mask the
    positions past the step with -1e9, softmax, weight v."""
    r, h, d = q.shape
    bs = pool_k.shape[1]
    t = block_tab.shape[1] * bs
    tab = block_tab.to(torch.int64)
    kv_k = pool_k[tab].reshape(r, t, h, d).float()
    kv_v = pool_v[tab].reshape(r, t, h, d).float()
    s = torch.einsum("rhd,rthd->rht", q.float(), kv_k) * scale
    pos = torch.arange(t, device=q.device)
    keep = pos[None, None, :] <= step.reshape(r, 1, 1).to(torch.int64)
    s = torch.where(keep, s, torch.full_like(s, -1e9))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rht,rthd->rhd", p, kv_v).to(q.dtype)


@functools.cache
def _kernel():
    from .build import library

    fn = library("paged_attention").paged_decode_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, pool_k, pool_v, block_tab, step, scale):
    if not usable(q, pool_k, block_tab):
        raise ValueError(
            f"paged_decode_attention: no kernel for q {tuple(q.shape)}, "
            f"pool {tuple(pool_k.shape)}, block table "
            f"{tuple(block_tab.shape)} (needs matching heads and head "
            f"dim, Dh % 8 == 0, Dh <= {MAX_HEAD_DIM}, BS % 8 == 0, one "
            f"table row per lane)")
    if tuple(pool_v.shape) != tuple(pool_k.shape) \
            or tuple(step.shape) != (q.shape[0],):
        raise ValueError(
            f"paged_decode_attention: pool_v {tuple(pool_v.shape)} / step "
            f"{tuple(step.shape)} do not match pool_k "
            f"{tuple(pool_k.shape)} / {q.shape[0]} lanes")
    require_cuda_inputs("paged_decode_attention", (q, pool_k, pool_v),
                        (torch.float32,))
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_decode_attention: the pools must start on "
                         "a 16-byte boundary (the kernel copies 16-byte "
                         "rows)")
    tab = block_tab.to(torch.int32).contiguous()
    st = step.to(torch.int64).contiguous()
    for t in (tab, st):
        if t.device != q.device:
            raise ValueError(f"paged_decode_attention: index on "
                             f"{t.device}, q on {q.device}")
    r, h, d = q.shape
    bs, n_pages = pool_k.shape[1], tab.shape[1]
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        st.data_ptr(), out.data_ptr(), r, h, d, bs, n_pages, float(scale),
        current_stream(q))
    count_launch(paged_decode_attention)
    check_launch("paged_decode_attention", err)
    return out


def paged_decode_attention(q, pool_k, pool_v, block_tab, step, scale=1.0):
    """q [R,H,Dh] fp32; pool_k/pool_v [NB,BS,H,Dh] fp32; block_tab [R,NP]
    int32; step [R] integer. Returns [R,H,Dh]."""
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, pool_k, pool_v, block_tab,
                                            step, scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_decode_attention: no kernel for device {q.device}")
    return _launch(q, pool_k, pool_v, block_tab, step, scale)


paged_decode_attention.launches = 0
