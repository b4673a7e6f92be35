"""The sampled-emission ops of the decode engine: the port's copy of
``filtered_softmax`` and ``sample_categorical`` from
``paddle_tpu/ops/spec_ops.py`` (the speculative-decode ops of that
module, ``span_scatter`` and ``spec_accept``, belong to the drafts slice).

Noise discipline (as in the JAX package): serving's emission noise must
not depend on which serve program processes a position. Admission order,
burst boundaries and paged recompute-preemption all change the dispatch
sequence, and a preempted lane is re-decoded byte for byte only when the
draw at (request, position) is a pure function of those two. So every
draw derives from ``fold_in`` chains over (base_seed attr, noise_tag
attr, the lane's seed, the lane's position), never from the executor's
step key or the op's uid.

The port derives that noise exactly as JAX does, so its sampled tokens
match the JAX package's token for token: ``threefry2x32`` (the
Threefry-2x32 block cipher of Salmon et al., 20 rounds, JAX's
``jax.random`` default) written on int64 tensors masked to 32 bits, run on
the device of its inputs. ``PRNGKey(s)`` is the pair ``(0, s)``;
``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``; the 32-bit draws of
a ``[V]`` sample are ``x0 ^ x1`` of ``threefry2x32(key, (0, i))`` for
``i < V`` (JAX's ``jax_threefry_partitionable`` layout, its default since
0.5); a uniform takes the top 23 bits as the mantissa of a float in
[1, 2), minus 1, floored at ``finfo(float32).tiny``; the categorical draw
is ``argmax(-log(-log(u)) + log(p + 1e-20))``, the lowest index on a tie.
The JAX package runs this as plain XLA (no Pallas kernel), so the port
keeps it plain PyTorch.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the key words (k0, k1) over the
    counter words (x0, x1): int64 tensors holding uint32 values, which
    broadcast against each other. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^32: (0, seed)."""
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.tensor(int(seed) & _M32, dtype=torch.int64,
                         device=device))


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` with ``data`` cast to uint32 as
    JAX casts it (an int64 tensor or an int; it wraps modulo 2^32)."""
    k0, k1 = key
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=k0.device)
    return threefry2x32(k0, k1, torch.zeros_like(data), data & _M32)


def random_bits(key, n: int):
    """The [..., n] 32-bit draws of ``jax.random.bits(key, (n,))`` for
    key words of shape [...]: x0 ^ x1 over the counters (0, iota(n))."""
    k0, k1 = key
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    x0, x1 = threefry2x32(k0.unsqueeze(-1), k1.unsqueeze(-1),
                          torch.zeros_like(i), i)
    return x0 ^ x1


def uniform(key, n: int):
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1)`` over the
    key words' leading shape: float32 in [tiny, 1)."""
    bits = random_bits(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, _TINY)


def base_key(base_seed: int, tag: int, device=None):
    """fold_in(PRNGKey(base_seed & 0x7FFFFFFF), tag)."""
    return fold_in(prng_key(int(base_seed) & 0x7FFFFFFF, device), int(tag))


def lane_keys(base, seed, pos):
    """[R] key words fold_in(fold_in(base, seed[r]), pos[r]): a pure
    function of (seed, pos), so admission order, burst length and
    preemption replay cannot move a draw."""
    k0, k1 = base
    seed = seed.reshape(-1).to(torch.int64)
    pos = pos.reshape(-1).to(torch.int64)
    key = fold_in((k0.expand_as(seed), k1.expand_as(seed)), seed)
    return fold_in(key, pos)


def gumbel_argmax(keys, logp):
    """``jax.vmap(jax.random.categorical)(keys, logp)`` over [R, V] log
    probabilities: argmax of the Gumbel noise plus logp, the first index
    on a tie."""
    u = uniform(keys, logp.shape[-1])
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logp, dim=-1)


def filter_probs(logits, temperature, top_k, top_p):
    """Temperature, top-k and top-p filtered, renormalized probabilities
    over the last axis (``_filter_probs`` in the JAX package).
    temperature 0 is greedy: a one-hot at the argmax."""
    v = logits.shape[-1]
    if temperature == 0.0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, dim=-1), v).to(torch.float32)
    z = (logits / float(temperature)).to(torch.float32)
    if top_k and 0 < int(top_k) < v:
        kth = torch.topk(z, int(top_k), dim=-1).values[..., -1:]
        z = torch.where(z >= kth, z, torch.full_like(z, float("-inf")))
    p = torch.softmax(z, dim=-1)
    if top_p and float(top_p) < 1.0:
        ps = torch.sort(p, dim=-1, descending=True).values
        cs = torch.cumsum(ps, dim=-1)
        # the nucleus: the smallest set whose mass reaches top_p (the
        # top-1 token always survives: its exclusive cumsum is 0)
        keep_sorted = (cs - ps) < float(top_p)
        cutoff = torch.where(keep_sorted, ps,
                             torch.full_like(ps, float("inf"))).amin(
            dim=-1, keepdim=True)
        p = torch.where(p >= cutoff, p, torch.zeros_like(p))
        p = p / p.sum(dim=-1, keepdim=True)
    return p


@register_op("filtered_softmax", differentiable=False,
             stop_gradient_slots=("X",))
def filtered_softmax(ctx):
    """[..., V] logits -> temperature/top-k/top-p filtered probabilities
    (temperature 0: the one-hot argmax). attrs: temperature, top_k,
    top_p."""
    x = ctx.input("X")
    if x.device.type == "meta":
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return filter_probs(x, float(ctx.attr("temperature", 1.0)),
                        int(ctx.attr("top_k", 0) or 0),
                        float(ctx.attr("top_p", 1.0)))


@register_op("sample_categorical", differentiable=False, needs_rng=True,
             stop_gradient_slots=("Probs", "Seed", "Pos"))
def sample_categorical(ctx):
    """One int64 token a lane from [R, V] probabilities, keyed only by
    (base_seed, noise_tag, Seed[r], Pos[r]); the executor's step key
    stays out (module docstring)."""
    probs = ctx.input("Probs")
    if probs.device.type == "meta":
        return torch.empty(probs.shape[:-1], dtype=torch.int64,
                           device=probs.device)
    keys = lane_keys(
        base_key(ctx.attr("base_seed", 0), ctx.attr("noise_tag", 0),
                 probs.device),
        ctx.input("Seed"), ctx.input("Pos"))
    logp = torch.log(probs.to(torch.float32) + 1e-20)
    return gumbel_argmax(keys, logp).to(torch.int64)
