"""The sampled-emission and speculative-decode ops of the decode engine:
the port's copy of ``filtered_softmax``, ``sample_categorical``,
``span_scatter`` and ``spec_accept`` from ``paddle_tpu/ops/spec_ops.py``.

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
The acceptance draws of ``spec_accept`` are scalar uniforms
(``jax.random.uniform(key)``: minval 0, not floored at tiny). The JAX
package runs all of this as plain XLA (no Pallas kernel), so the port
keeps it plain PyTorch, on the device of its inputs.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny
# draw-purpose tags folded in on top of the builder's noise_tag: the same
# (seed, pos) gives independent draws for the acceptance uniform and the
# residual or bonus sample
_TAG_ACCEPT = 101
_TAG_RESID = 102


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


def _unit_floats(bits):
    """The float32 in [0, 1) of 32-bit draws: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, n: int):
    """``jax.random.uniform(key, (n,), minval=tiny, maxval=1)`` over the
    key words' leading shape: float32 in [tiny, 1)."""
    return torch.clamp_min(_unit_floats(random_bits(key, n)), _TINY)


def uniform_scalar(key):
    """``jax.random.uniform(key)`` (shape (), minval 0) over the key
    words' shape: float32 in [0, 1), not floored at tiny."""
    return _unit_floats(random_bits(key, 1)[..., 0])


def base_key(base_seed: int, tag: int, device=None):
    """fold_in(PRNGKey(base_seed & 0x7FFFFFFF), tag)."""
    return fold_in(prng_key(int(base_seed) & 0x7FFFFFFF, device), int(tag))


def lane_keys(base, seed, pos):
    """[R] key words fold_in(fold_in(base, seed[r]), pos[r]) (or [R, J]
    words at pos[r, j] for a 2-D pos): a pure function of (seed, pos),
    so admission order, burst length and preemption replay cannot move a
    draw."""
    k0, k1 = base
    if pos.dim() == 2:
        pos = pos.to(torch.int64)
        seed = seed.reshape(-1, 1).to(torch.int64).expand_as(pos)
    else:
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


@register_op("span_scatter", differentiable=False,
             stop_gradient_slots=("X", "Vals", "Start", "Count"))
def span_scatter(ctx):
    """Write Vals[r, :Count[r]] into Buf[r, Start[r]:Start[r]+Count[r]]
    per row (Out is the Buf var: the accepted-prefix token write of the
    speculative step). Rows are per-lane buffers, so they never alias."""
    buf = ctx.input("X")
    if buf.device.type == "meta":
        return buf
    vals = ctx.input("Vals")
    start = ctx.input("Start").reshape(-1).to(torch.int64)
    count = ctx.input("Count").reshape(-1).to(torch.int64)
    t, w = buf.shape[1], vals.shape[1]
    rel = torch.arange(t, device=buf.device)[None, :] - start[:, None]
    sel = (rel >= 0) & (rel < count[:, None]) & (rel < w)
    vals_at = torch.gather(vals, 1, rel.clamp(0, w - 1))
    return torch.where(sel, vals_at.to(buf.dtype), buf)


@register_op("spec_accept", differentiable=False, needs_rng=True,
             stop_gradient_slots=("Proposals", "DraftProbs",
                                  "TargetProbs", "Seed", "Pos"))
def spec_accept(ctx):
    """Draft-and-verify acceptance (Leviathan et al.'s speculative
    sampling) for one batched lane step.

    inputs (R lanes, k proposals, vocab V): Proposals [R, k] (the draft
    tokens for positions Pos+1..Pos+k), DraftProbs [R, k, V] (the
    filtered draft distributions they were drawn from; one-hot under
    greedy), TargetProbs [R, k+1, V] (the verify step's filtered target
    distributions at Pos+1..Pos+k+1), Seed and Pos [R]. attrs: k,
    end_id, max_len, greedy, base_seed, noise_tag.

    Per lane: accept proposal j while u_j * q_j(x_j) < p_j(x_j), u_j the
    scalar uniform keyed on (seed, pos+1+j) under noise_tag + 101 (the
    strict < makes greedy exact: a match always accepts, a mismatch
    never does). At the first rejection the correction comes from
    norm(max(p - q, 0)) (p where that sums to 0); with all k accepted
    the bonus comes from p_k. Under greedy the correction is an argmax,
    otherwise a Gumbel draw keyed on (seed, pos+1+a) under noise_tag +
    102. The run is clipped at the first end_id (the lane finishes
    there) and at the room max_len-1 - Pos.

    outputs: Advance [R] (tokens emitted, 0..k+1), Tokens [R, k+1] (the
    first Advance valid), Accepted [R] (accepted proposals among them),
    Fin [R] (1 iff the advance ends on end_id)."""
    tprobs = ctx.input("TargetProbs")
    k = int(ctx.attr("k"))
    r = tprobs.shape[0]
    dev = tprobs.device
    if dev.type == "meta":
        return {name: torch.empty(shape, dtype=torch.int64, device=dev)
                for name, shape in (("Advance", (r,)),
                                    ("Tokens", (r, k + 1)),
                                    ("Accepted", (r,)), ("Fin", (r,)))}
    tprobs = tprobs.to(torch.float32)
    seed = ctx.input("Seed").reshape(-1)
    pos = ctx.input("Pos").reshape(-1).to(torch.int64)
    end_id = int(ctx.attr("end_id"))
    max_len = int(ctx.attr("max_len"))
    greedy = bool(ctx.attr("greedy", True))
    base_seed = ctx.attr("base_seed", 0)
    tag = int(ctx.attr("noise_tag", 0))
    cols = torch.arange(k + 1, device=dev)
    lanes = torch.arange(r, device=dev)
    props = ctx.input("Proposals").to(torch.int64).reshape(r, k)
    if k > 0:
        dprobs = ctx.input("DraftProbs").to(torch.float32)
        posj = pos[:, None] + 1 + cols[None, :k]
        u = uniform_scalar(lane_keys(
            base_key(base_seed, tag + _TAG_ACCEPT, dev), seed, posj))
        px = torch.gather(tprobs[:, :k], 2, props[..., None])[..., 0]
        qx = torch.gather(dprobs, 2, props[..., None])[..., 0]
        acc = u * qx < px
        a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)
        ai = a.clamp(0, k - 1)
        p_a, q_a = tprobs[lanes, ai], dprobs[lanes, ai]
        resid = (p_a - q_a).clamp_min(0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(
            rs > 0, resid / torch.where(rs > 0, rs, torch.ones_like(rs)),
            p_a)
        corr_dist = torch.where((a < k)[:, None], resid, tprobs[:, k])
    else:
        a = torch.zeros((r,), dtype=torch.int64, device=dev)
        corr_dist = tprobs[:, 0]
    if greedy:
        corr_tok = torch.argmax(corr_dist, dim=-1)
    else:
        corr_tok = gumbel_argmax(
            lane_keys(base_key(base_seed, tag + _TAG_RESID, dev), seed,
                      pos + 1 + a),
            torch.log(corr_dist + 1e-20))
    toks = torch.cat([props, torch.zeros((r, 1), dtype=torch.int64,
                                         device=dev)], dim=1)
    toks = torch.where(cols[None, :] == a[:, None],
                       corr_tok.to(torch.int64)[:, None], toks)
    adv = a + 1
    # the lane finishes at its first emitted end_id
    is_eos = (toks == end_id) & (cols[None, :] < adv[:, None])
    eos_any = is_eos.any(dim=1)
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
    adv = torch.where(eos_any, first_eos + 1, adv)
    # never write past buffer position max_len - 1
    adv = torch.minimum(adv, (max_len - 1 - pos).clamp(0, k + 1))
    fin = (eos_any & (first_eos + 1 <= adv)).to(torch.int64)
    return {"Advance": adv, "Tokens": toks,
            "Accepted": torch.minimum(a, adv), "Fin": fin}
