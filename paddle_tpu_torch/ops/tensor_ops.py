"""Tensor creation / manipulation ops: the port's subset of
``paddle_tpu/ops/tensor_ops.py`` (reference fill_constant_op.cc,
fill_any_like_op.cc, uniform_random_op.cc, gaussian_random_op.cc,
reshape_op.cc, transpose_op.cc, split_op.cc, sum_op.cc, cast_op.cc,
assign_op.cc, scale_op.cc, range_op.cc, arg_max, gather_op.cc,
scatter_op.cc, expand_op.cc, clip_op.cc, clip_by_norm_op.cc, ...).

Creation ops allocate on ``ctx.device``; at build time that is the meta
device, so shape inference allocates nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from ..core.types import to_torch_dtype


@register_op("fill_constant", differentiable=False)
def fill_constant(ctx):
    shape = [int(s) for s in ctx.attr("shape", [1])]
    return torch.full(shape, ctx.attr("value", 0.0),
                      dtype=to_torch_dtype(ctx.attr("dtype", "float32")),
                      device=ctx.device)


@register_op("fill_any_like", differentiable=False)
def fill_any_like(ctx):
    """The loss-grad seed of append_backward: ones like the loss."""
    x = ctx.input("X")
    return torch.full_like(x, ctx.attr("value", 0.0))


def _seeded_generator(ctx):
    """A nonzero ``seed`` attr pins the draw; else the op's generator."""
    if ctx.attr("seed", 0):
        gen = torch.Generator()
        gen.manual_seed(int(ctx.attr("seed")))
        return gen
    return ctx.generator()


@register_op("uniform_random", differentiable=False, host_rng=True)
def uniform_random(ctx):
    """Draws on the CPU from the op's generator (the program's seed, the
    step key, the op's uid), then moves: the same seed gives the same
    weights on every device, and each run of a program draws anew. A
    nonzero ``seed`` attr pins the draw, as in the JAX package."""
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=ctx.device)
    out = torch.empty(shape, dtype=torch.float32)
    out.uniform_(ctx.attr("min", -1.0), ctx.attr("max", 1.0),
                 generator=_seeded_generator(ctx))
    return out.to(device=ctx.device, dtype=dtype)


@register_op("gaussian_random", differentiable=False, host_rng=True)
def gaussian_random(ctx):
    """Normal values of `mean` and `std`, drawn in fp32 on the CPU as
    ``uniform_random`` draws (the same seed gives the same values on
    every device) and cast to `dtype`. The bits are torch's, not JAX's
    threefry: the JAX package's draw is matched in distribution only."""
    shape = [int(s) for s in ctx.attr("shape")]
    dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=ctx.device)
    out = torch.randn(shape, dtype=torch.float32,
                      generator=_seeded_generator(ctx))
    out = out * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)
    return out.to(device=ctx.device, dtype=dtype)


@register_op("assign")
def assign(ctx):
    return ctx.input("X")


def _constant(ctx, make):
    """A value fixed by the op's attributes, made by `make()` on
    ``ctx.device`` once per op and device and reused by every later run.
    A run copies nothing from the host for it, so a step that holds the
    op can be captured in a CUDA graph (a pageable host-to-device copy
    cannot be). Sharing one tensor is safe: ops allocate their outputs
    (only ``masked_pool_write`` writes its input, a pool, in place)."""
    made = ctx.op.__dict__.setdefault("_constants", {})
    t = made.get(ctx.device)
    if t is None:
        t = made[ctx.device] = make()
    return t


@register_op("assign_value", differentiable=False)
def assign_value(ctx):
    def make():
        vals = np.asarray(ctx.attr("values"))
        dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
        shape = ctx.attr("shape", list(vals.shape))
        return torch.from_numpy(np.ascontiguousarray(vals)).to(
            device=ctx.device, dtype=dtype).reshape(shape)

    return _constant(ctx, make)


@register_op("cast")
def cast(ctx):
    return ctx.input("X").to(to_torch_dtype(ctx.attr("out_dtype")))


def _weak_scalar(v, x):
    """The Python scalar `v` as JAX applies it to an array `x` of a
    floating dtype narrower than fp32: rounded to that dtype."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(float(v), dtype=x.dtype))
    return v


@register_op("scale")
def scale(ctx):
    """x * scale + bias (or (x + bias) * scale). The attrs reach a bf16 x
    rounded to bf16 first, as JAX's weak typing rounds a Python scalar
    to the array's dtype in the JAX package."""
    x = ctx.input("X")
    s = _weak_scalar(ctx.attr("scale", 1.0), x)
    b = _weak_scalar(ctx.attr("bias", 0.0), x)
    if ctx.attr("bias_after_scale", True):
        return x * s + b
    return (x + b) * s


def _with_xshape(ctx, out):
    res = {"Out": out}
    if "XShape" in ctx.op.outputs:
        res["XShape"] = torch.zeros((0,) + tuple(ctx.input("X").shape),
                                    device=out.device)
    return res


@register_op("reshape2")
def reshape2(ctx):
    """fluid semantics (reference reshape_op.cc): 0 copies the input
    dim, -1 is inferred."""
    x = ctx.input("X")
    shape = [x.shape[i] if s == 0 else s
             for i, s in enumerate(ctx.attr("shape"))]
    return _with_xshape(ctx, x.reshape(shape))


@register_op("transpose2")
def transpose2(ctx):
    return _with_xshape(ctx, ctx.input("X").permute(*ctx.attr("axis")))


@register_op("unsqueeze2")
def unsqueeze2(ctx):
    x = ctx.input("X")
    out = x
    for a in sorted(ctx.attr("axes")):
        out = out.unsqueeze(a)
    return _with_xshape(ctx, out)


@register_op("concat")
def concat(ctx):
    return torch.cat(ctx.inputs("X"), dim=ctx.attr("axis", 0))


@register_op("split")
def split(ctx):
    x = ctx.input("X")
    axis = ctx.attr("axis", 0)
    num = ctx.attr("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError(
                f"split: axis {axis} of extent {x.shape[axis]} does not "
                f"divide into {num} equal parts")
        return {"Out": list(torch.chunk(x, num, dim=axis))}
    sections = list(ctx.attr("sections", []))
    neg = [i for i, s in enumerate(sections) if s == -1]
    if len(neg) > 1:
        raise ValueError(
            f"split: more than one -1 entry in sections {sections}")
    if neg:
        rest = int(x.shape[axis]) - sum(s for s in sections if s != -1)
        if rest < 0:
            raise ValueError(
                f"split: explicit sections {sections} exceed the axis "
                f"extent {int(x.shape[axis])}; cannot infer the -1 "
                f"section")
        sections[neg[0]] = rest
    return {"Out": list(torch.split(x, sections, dim=axis))}


@register_op("sum")
def sum_op(ctx):
    """Elementwise sum of the X list: how append_backward adds the
    partial grads of a var read by several ops."""
    xs = [x for x in ctx.inputs("X") if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


@register_op("range", differentiable=False)
def range_op(ctx):
    """Static bounds from attrs, computed on the host in float64 and
    cast to the declared dtype (as the JAX package does)."""
    start = ctx.attr("start", None)
    if start is None:
        raise NotImplementedError(
            "range: tensor-valued Start/End/Step are not supported; "
            "pass python scalars")

    def make():
        vals = np.arange(float(start), float(ctx.attr("end")),
                         float(ctx.attr("step")))
        dtype = to_torch_dtype(ctx.attr("dtype", "float32"))
        return torch.from_numpy(vals).to(device=ctx.device, dtype=dtype)

    return _constant(ctx, make)


@register_op("arg_max", differentiable=False)
def arg_max(ctx):
    return torch.argmax(ctx.input("X"), dim=ctx.attr("axis", -1))


@register_op("one_hot", differentiable=False)
def one_hot(ctx):
    """float32 one-hot rows of depth `depth` (a trailing axis of 1 on
    the ids is dropped, as in the JAX package); ids outside [0, depth)
    give a zero row, as ``jax.nn.one_hot`` does."""
    x = ctx.input("X")
    depth = int(ctx.attr("depth"))
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x[..., 0]
    x = x.to(torch.int64)
    return (x[..., None] == torch.arange(depth, device=x.device)).to(
        torch.float32)


@register_op("top_k", differentiable=False)
def top_k(ctx):
    """The k largest of each row along the last axis, largest first, and
    their int32 indices (``jax.lax.top_k``): equal values in the order of
    their indices, NaN above every number. ``torch.topk`` promises no
    order among equal values, so this sorts stably."""
    x = ctx.input("X")
    k = int(ctx.attr("k", 1))
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": vals[..., :k].contiguous(),
            "Indices": idx[..., :k].to(torch.int32)}


@register_op("fill_constant_batch_size_like", differentiable=False)
def fill_constant_batch_size_like(ctx):
    ref = ctx.input("Input")
    shape = list(ctx.attr("shape"))
    shape[ctx.attr("output_dim_idx", 0)] = \
        ref.shape[ctx.attr("input_dim_idx", 0)]
    return torch.full(shape, ctx.attr("value", 0.0),
                      dtype=to_torch_dtype(ctx.attr("dtype", "float32")),
                      device=ref.device)


@register_op("increment")
def increment(ctx):
    """X + step, promoted as ``x + step`` promotes in the JAX package: an
    integer X with a float step gives float32, with an int step stays an
    integer (the ``increment`` layer makes an integral step an int for an
    integer X, so a loop counter stays a counter)."""
    return ctx.input("X") + ctx.attr("step", 1.0)


def _take_fill(dtype):
    """What ``jnp.take``'s default "fill" mode puts at an out-of-range
    index: NaN for a float, the most negative value for a signed
    integer, the largest for an unsigned one, True for a bool."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register_op("gather", stop_gradient_slots=("Index",))
def gather(ctx):
    """Rows of X at Index along axis 0, shaped Index.shape +
    X.shape[1:] (reference gather_op.cc; ``paddle_tpu/ops/tensor_ops.py``
    gather, ``jnp.take``). As there, an index in [-N, 0) counts from the
    end and any other index outside [0, N) reads the fill value of
    `_take_fill`: clamped indices and a ``torch.where``, so the card
    needs no device assert and no host sync."""
    x = ctx.input("X")
    idx = ctx.input("Index").to(torch.int64)
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    rows = torch.index_select(x, 0, torch.where(valid, idx, 0).reshape(-1))
    rows = rows.reshape(*idx.shape, *x.shape[1:])
    valid = valid.reshape(*idx.shape, *[1] * (x.dim() - 1))
    return torch.where(valid, rows, _take_fill(x.dtype))


@register_op("scatter", stop_gradient_slots=("Ids",))
def scatter(ctx):
    """X with the rows at Ids replaced by Updates (`overwrite`) or
    Updates added to them (reference scatter_op.cc; ``x.at[ids].set`` /
    ``.add`` in the JAX package). JAX's index rule: an id in [-N, 0)
    counts from the end, and an update at any other id outside [0, N) is
    dropped. The dropped rows go to a spare row past the end, so the
    card needs no device assert and no host sync. Under `overwrite` the
    row of an id given twice takes one of its updates, as in XLA, which
    defines no order either."""
    x = ctx.input("X")
    ids = ctx.input("Ids").to(torch.int64).reshape(-1)
    n = x.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    upd = torch.broadcast_to(ctx.input("Updates").to(x.dtype),
                             (ids.shape[0], *x.shape[1:]))
    padded = torch.cat([x, x.new_zeros((1, *x.shape[1:]))])
    if ctx.attr("overwrite", True):
        out = torch.index_copy(padded, 0, ids, upd)
    else:
        out = torch.index_add(padded, 0, ids, upd)
    return out[:n]


@register_op("expand")
def expand(ctx):
    """Tile X `expand_times` times along each axis (reference
    expand_op.cc; ``jnp.tile`` in the JAX package). Fewer times than
    axes take leading 1s, as ``jnp.tile`` pads them."""
    x = ctx.input("X")
    times = [int(t) for t in ctx.attr("expand_times")]
    return x.repeat(*[1] * (x.dim() - len(times)), *times)


@register_op("clip")
def clip(ctx):
    """x limited to [min, max], as ``jnp.clip``: max(x, min) then min(.,
    max), so at a bound the gradient splits half and half as JAX's does
    (``torch.clamp`` passes all of it). An integer X with a float bound
    gives float32, as ``jnp.clip`` promotes it."""
    x = ctx.input("X")
    lo, hi = ctx.attr("min"), ctx.attr("max")
    if not x.is_floating_point() and any(isinstance(b, float)
                                         for b in (lo, hi)):
        x = x.to(torch.float32)
    lo = torch.full_like(x, lo)
    hi = torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


@register_op("clip_by_norm")
def clip_by_norm(ctx):
    """x scaled by max_norm / |x| where its L2 norm exceeds max_norm; at
    or below it (a zero x too), x itself."""
    x = ctx.input("X")
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)
