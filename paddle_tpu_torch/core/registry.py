"""Op registry: kernels, build-time shape inference and grad-op makers.

Counterpart of ``paddle_tpu/core/registry.py`` (reference
op_registry.h:197-270, shape_inference.h, grad_op_desc_maker.h). A
kernel is a plain function ``fn(ctx) -> {out_slot: tensor | [tensors]}``
over torch tensors. The Executor calls it once per op per run.

Gradients are derived as in the JAX package: every differentiable op
gets a ``<type>_grad`` op whose kernel recomputes the forward on the
saved inputs under ``torch.func.vjp`` and applies the output
cotangents; ops whose grads differ (sparse embedding, the fused
softmax cross-entropy) register their own grad makers.

Shape inference is generic, as in the JAX package: the kernel runs on
``device="meta"`` tensors at two probe batch sizes, and an output dim
that moves with the probe is a batch dim (-1). A meta tensor has a
shape and a dtype but no storage, so this launches nothing; every
kernel wrapper answers a meta input with an empty output of the right
shape. The sharding, index and acquire rule tables of the JAX registry
are not part of this package yet.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional

import torch

from .. import amp
from .program import GRAD_SUFFIX, Block, Operator, grad_var_name
from .types import as_datatype, to_torch_dtype

# placeholder input name meaning "no value" (registry.py EMPTY_VAR)
EMPTY_VAR = "@EMPTY@"

META = torch.device("meta")


class OpInfo:
    def __init__(self, type: str, kernel: Callable,
                 infer_shape: Optional[Callable] = None,
                 grad_maker=None, differentiable: bool = True,
                 stop_gradient_slots=(), needs_rng: bool = False,
                 host_rng: bool = False):
        self.type = type
        self.kernel = kernel
        self.infer_shape = infer_shape
        self.grad_maker = grad_maker
        self.differentiable = differentiable
        # input slots that take no gradient whatever their dtype
        self.stop_gradient_slots = tuple(stop_gradient_slots)
        # draws random numbers: from OpContext.keep_mask or .normal (on
        # the device, from the step key the Executor keeps there) or, with
        # `host_rng`, from OpContext.generator() (a CPU generator)
        self.needs_rng = needs_rng or host_rng
        self.host_rng = host_rng


_REGISTRY: Dict[str, OpInfo] = {}


def get_op_info(type: str) -> OpInfo:
    if type not in _REGISTRY:
        raise KeyError(f"Operator {type!r} is not registered "
                       f"({len(_REGISTRY)} ops registered)")
    return _REGISTRY[type]


def is_registered(type: str) -> bool:
    return type in _REGISTRY


class OpContext:
    """What a kernel sees: resolved inputs, attrs, the device that
    creation ops allocate on, the program's seed and the step key for
    sampling ops (``key`` on the host, ``dkey`` a 0-d int64 tensor on the
    device), and which outputs a later op or a fetch reads (``needed``;
    None: all)."""

    __slots__ = ("op", "attrs", "_inputs", "device", "seed", "key",
                 "dkey", "_needed", "_rng_calls")

    def __init__(self, op: Operator, inputs: Dict[str, List],
                 device: torch.device, seed: int = 0, needed=None,
                 key: int = 0, dkey: Optional[torch.Tensor] = None):
        self.op = op
        self.attrs = op.attrs
        self._inputs = inputs
        self.device = device
        self.seed = seed
        self.key = key
        self.dkey = dkey
        self._needed = needed
        self._rng_calls = 0

    def output_needed(self, slot) -> bool:
        """Whether anything reads an output of `slot`. A kernel may skip
        an unread output, as XLA dead-codes it in the JAX package (the
        [N, V] Softmax of softmax_with_cross_entropy)."""
        if self._needed is None:
            return True
        return any(n in self._needed for n in self.op.outputs.get(slot, ()))

    def input(self, slot, idx=0):
        vals = self._inputs.get(slot)
        if not vals:
            return None
        return vals[idx]

    def inputs(self, slot) -> List:
        return list(self._inputs.get(slot, []))

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def generator(self) -> torch.Generator:
        """A CPU generator for this op, seeded from the program's seed,
        the step key (which the Executor advances every step) and the
        op's structural uid: each step and each op draws anew, and
        identical program builds under one seed draw identical values
        whatever the device (sampling ops draw on the CPU and move the
        result). Counterpart of ``OpContext.rng`` in the JAX package,
        ``fold_in(step_key, uid)``."""
        g = torch.Generator()
        g.manual_seed(mix64(self.seed, self.key, self.op._uid))
        return g

    def keep_mask(self, shape, keep_prob: float, dtype: torch.dtype,
                  device: torch.device, seed: int = 0) -> torch.Tensor:
        """A keep mask of `shape` in `dtype` on `device`, 1 with
        probability `keep_prob`, drawn on the device with no host round
        trip, so a CUDA graph can capture it (``OpContext.rng`` in the JAX
        package). Each element is a pure function of (program seed, step
        key, op uid, call index, element index): the Executor advances the
        step key inside each step, so every step draws anew and a replayed
        step draws what the same step run eagerly draws; an op's vjp
        recompute (the same uid, calls counted from 0) draws its forward's
        mask again. A nonzero `seed` (the op's attr) pins the draw in place
        of the program seed and step key."""
        if device.type == "meta":
            self._rng_calls += 1
            return torch.empty(shape, dtype=dtype, device=device)
        key, salt = self._device_draw(device, seed)
        return keep_bits(key, salt, shape, keep_prob).to(dtype)

    def normal(self, shape, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
        """Standard normal values of `shape` in `dtype` on `device`
        (``normal_bits``), keyed as `keep_mask` keys its mask: drawn on the
        device with no host round trip, anew every step, the same values
        in a replayed step as in the eager one."""
        if device.type == "meta":
            self._rng_calls += 1
            return torch.empty(shape, dtype=dtype, device=device)
        key, salt = self._device_draw(device, 0)
        return normal_bits(key, salt, shape).to(dtype)

    def _device_draw(self, device, seed):
        """(key tensor on `device`, salt) of this op's next device draw."""
        call = self._rng_calls
        self._rng_calls += 1
        if seed:
            # a fill, not a host copy: capturable
            key = torch.full((), _signed(mix64(seed, 0)), dtype=torch.int64,
                             device=device)
            return key, mix64(self.op._uid, call)
        if self.dkey is None:
            raise RuntimeError(
                f"op {self.op.type!r} draws on the device but was run "
                f"without a device step key (run it through the "
                f"Executor)")
        return self.dkey.to(device), mix64(self.seed, self.op._uid, call)


_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """One step of SplitMix64 (Steele, Lea and Flood, 2014): a bijection
    of 64-bit integers whose outputs pass BigCrush."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix64(*vals: int) -> int:
    """A 64-bit hash of the integers `vals`, in order."""
    h = 0
    for v in vals:
        h = splitmix64(h ^ (int(v) & _MASK64))
    return h


def _signed(x: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """The logical right shift of the int64 bit patterns in `x`."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64_t(x: torch.Tensor) -> torch.Tensor:
    """`splitmix64` on int64 tensors, element by element: the same bit
    patterns, with the products wrapping mod 2^64 as int64 products do."""
    x = x + _signed(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _signed(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _signed(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def advance_key_t(key: torch.Tensor) -> torch.Tensor:
    """The next step key from a 0-d int64 device tensor: what the
    Executor's host-side ``_step_key`` computes, ``splitmix64(key) >>
    1``, in device arithmetic (capturable)."""
    return _shr(splitmix64_t(key), 1)


def _stream24(key: torch.Tensor, salt: int, n: int) -> torch.Tensor:
    """n int64 values in [0, 2^24): element i the top 24 bits of
    SplitMix64(splitmix64(key ^ salt) + i * golden) (SplitMix64's own
    stream, started from the key mixed with the salt). `key` is a 0-d
    int64 tensor; the arithmetic is int64 tensor ops, so the same key
    gives the same values on the CPU and on the card."""
    base = splitmix64_t(key ^ _signed(salt))
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return _shr(splitmix64_t(base + idx * _signed(0x9E3779B97F4A7C15)), 40)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def keep_bits(key: torch.Tensor, salt: int, shape, keep_prob: float
              ) -> torch.Tensor:
    """A bool keep mask of `shape`: element i keeps where the i-th value
    of `_stream24` falls below `keep_prob` * 2^24."""
    thresh = int(round(float(keep_prob) * (1 << 24)))
    return (_stream24(key, salt, _numel(shape)) < thresh).reshape(
        tuple(shape))


def normal_bits(key: torch.Tensor, salt: int, shape) -> torch.Tensor:
    """fp32 standard normal values of `shape` from `_stream24` by
    Box-Muller: element i from stream values 2i and 2i+1 as uniforms in
    (0, 1] and [0, 1), so |value| stays below sqrt(2 ln 2^24), 5.77."""
    n = _numel(shape)
    z = _stream24(key, salt, 2 * n).to(torch.float32) * 2.0 ** -24
    u1, u2 = 1.0 - z[0::2], z[1::2]
    r = torch.sqrt(-2.0 * torch.log(u1))
    return (r * torch.cos((2.0 * torch.pi) * u2)).reshape(tuple(shape))


def register_op(type: str, *, infer_shape=None, grad_maker=None,
                differentiable=True, stop_gradient_slots=(),
                needs_rng=False, host_rng=False):
    """Decorator: register ``fn(ctx) -> {out_slot: value|[values]}``.
    `stop_gradient_slots`: input slots whose grad op declares and
    computes no gradient (an index, a label). `needs_rng`: the kernel
    draws from ``ctx.keep_mask`` (the device step key); `host_rng`: from
    ``ctx.generator()``, a CPU generator, which a CUDA graph cannot
    capture."""

    def deco(fn):
        _REGISTRY[type] = OpInfo(
            type, fn, infer_shape=infer_shape, grad_maker=grad_maker,
            differentiable=differentiable,
            stop_gradient_slots=stop_gradient_slots, needs_rng=needs_rng,
            host_rng=host_rng)
        return fn

    return deco


def _normalize_outputs(op: Operator, raw) -> Dict[str, List]:
    out: Dict[str, List] = {}
    if raw is None:
        return out
    if not isinstance(raw, dict):
        slots = [s for s in op.outputs if op.outputs[s]]
        if len(slots) != 1:
            raise ValueError(
                f"op {op.type} returned a bare value but has output slots "
                f"{list(op.outputs)}")
        raw = {slots[0]: raw}
    for slot, vals in raw.items():
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        out[slot] = list(vals)
    return out


def run_op(op: Operator, env: Dict, device: torch.device,
           seed: int = 0, needed=None, key: int = 0,
           dkey: Optional[torch.Tensor] = None) -> None:
    """Execute one op against an env of name -> tensor; write outputs.
    `needed`: the names a later op or a fetch reads (None: all); `seed`,
    `key` and `dkey`: the program's seed and the step key, on the host
    and on the device. While AMP is on (``paddle_tpu_torch.amp``) the
    op's inputs are cast by its policy first (``run_op`` in the JAX
    package)."""
    info = get_op_info(op.type)
    inputs: Dict[str, List] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                vals.append(None)
            elif n not in env:
                raise KeyError(
                    f"op {op.type}: input var {n!r} (slot {slot}) not "
                    f"materialized; known={sorted(env)[:20]}...")
            else:
                vals.append(env[n])
        inputs[slot] = vals
    if amp.enabled():
        inputs = amp.cast_op_inputs(op.type, inputs)
    ctx = OpContext(op, inputs, device, seed, needed, key, dkey)
    outs = _normalize_outputs(op, info.kernel(ctx))
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        if len(vals) != len(names):
            raise ValueError(
                f"op {op.type}: slot {slot} produced {len(vals)} values for "
                f"{len(names)} output vars")
        for n, v in zip(names, vals):
            env[n] = v


# ---------------------------------------------------------------------------
# Generic shape inference: meta tensors at two probe batch sizes.
# ---------------------------------------------------------------------------
_PROBE_A, _PROBE_B = 7, 11
_INFER_WARNED: set = set()


def _probe_tensor(var, probe):
    shape = tuple(probe if d == -1 else d for d in (var.shape or ()))
    return torch.empty(shape, dtype=to_torch_dtype(var.dtype or "float32"),
                       device=META)


def infer_shape_for_op(op: Operator, block: Block) -> None:
    info = _REGISTRY.get(op.type)
    if info is None:
        return  # unregistered (feed/fetch placeholders): skip
    if info.infer_shape is not None:
        info.infer_shape(op, block)
        return
    results = []
    try:
        for probe in (_PROBE_A, _PROBE_B):
            ins = {}
            for slot, names in op.inputs.items():
                vals = []
                for n in names:
                    v = block._find_var_recursive(n)
                    if v is None or v.shape is None or v.dtype is None:
                        return
                    vals.append(_probe_tensor(v, probe))
                ins[slot] = vals
            ctx = OpContext(op, ins, META)
            results.append(_normalize_outputs(op, info.kernel(ctx)))
    except (RuntimeError, ValueError, TypeError, IndexError,
            NotImplementedError) as e:
        # as in the JAX registry: warn once per op type and defer;
        # errors then surface when the op runs
        if op.type not in _INFER_WARNED:
            _INFER_WARNED.add(op.type)
            warnings.warn(
                f"shape inference for op {op.type!r} failed at build "
                f"time ({type(e).__name__}: {e}); output shapes left "
                f"unset")
        return
    ra, rb = results
    for slot, names in op.outputs.items():
        if slot not in ra:
            continue
        for n, ta, tb in zip(names, ra[slot], rb[slot]):
            var = block._find_var_recursive(n)
            if var is None:
                var = block.create_var(name=n)
            var.shape = tuple(da if da == db else -1
                              for da, db in zip(ta.shape, tb.shape))
            var.dtype = as_datatype(ta.dtype)


# ---------------------------------------------------------------------------
# Generic grad machinery: <type>_grad derived through torch.func.vjp.
# ---------------------------------------------------------------------------
def make_vjp_grad_kernel(fwd_type: str, fwd_kernel=None):
    """The kernel of `<fwd_type>_grad` (registry.py:565 in the JAX
    package).

    The grad op's inputs are the forward inputs plus `<slot>@GRAD` for
    each forward output slot; its outputs are `<slot>@GRAD` for each
    differentiable forward input slot. The forward is recomputed inside
    the vjp on the saved inputs. Integer and other non-float inputs get
    no gradient. ``torch.func.vjp`` differentiates even under the
    Executor's ``torch.no_grad()``: a function transform sets its own
    grad mode. `fwd_kernel` recomputes the forward in place of the
    registered kernel: an op whose kernel launches a CUDA kernel gives
    its plain version here, whose vjp is the op's gradient.
    """

    def kernel(ctx: OpContext):
        info = get_op_info(fwd_type)
        fwd = fwd_kernel or info.kernel
        fwd_op = ctx.attr("__fwd_op__")
        fwd_inputs = {s: ctx.inputs(s) for s in fwd_op.inputs}
        diff_paths, diff_leaves, const = [], [], {}
        for slot, vals in fwd_inputs.items():
            keep = slot not in info.stop_gradient_slots
            for i, v in enumerate(vals):
                if keep and v is not None and v.is_floating_point():
                    diff_paths.append((slot, i))
                    diff_leaves.append(v)
                else:
                    const[(slot, i)] = v

        def f(*leaves):
            ins = {s: [None] * len(v) for s, v in fwd_inputs.items()}
            for (s, i), v in const.items():
                ins[s][i] = v
            for (s, i), v in zip(diff_paths, leaves):
                ins[s][i] = v
            # the forward's uid and the same step keys: a sampling op's
            # recompute draws the forward's values again
            inner = OpContext(fwd_op, ins, ctx.device, ctx.seed,
                              key=ctx.key, dkey=ctx.dkey)
            return _normalize_outputs(fwd_op, fwd(inner))

        outs, vjp_fn = torch.func.vjp(f, *diff_leaves)
        cots = {}
        for slot, vals in outs.items():
            gs = ctx.inputs(slot + GRAD_SUFFIX)
            slot_cots = []
            for i, v in enumerate(vals):
                g = gs[i] if i < len(gs) else None
                if g is None or not v.is_floating_point():
                    g = torch.zeros_like(v)
                elif g.dtype != v.dtype:
                    g = g.to(v.dtype)
                slot_cots.append(g)
            cots[slot] = slot_cots
        grads = vjp_fn(cots)
        result: Dict[str, List] = {}
        for (slot, i), g in zip(diff_paths, grads):
            names = fwd_op.inputs[slot]
            result.setdefault(slot + GRAD_SUFFIX, [None] * len(names))[i] = g
        return {s: v for s, v in result.items()
                if any(x is not None for x in v)}

    return kernel


def default_grad_maker(op: Operator, no_grad_set=frozenset()):
    """The grad op desc of `op` (reference grad_op_desc_maker.h): a list
    of Operators, not yet appended to any block."""
    info = get_op_info(op.type)
    if not info.differentiable:
        return []
    grad_type = op.type + "_grad"
    if not is_registered(grad_type):
        register_op(grad_type, differentiable=False)(
            make_vjp_grad_kernel(op.type))
    inputs = {s: list(v) for s, v in op.inputs.items()}
    for slot, names in op.outputs.items():
        inputs[slot + GRAD_SUFFIX] = [grad_var_name(n) for n in names]
    outputs = {}
    for slot, names in op.inputs.items():
        if slot in info.stop_gradient_slots:
            continue
        grads = [grad_var_name(n) for n in names]
        if all(g in no_grad_set or n in no_grad_set
               for g, n in zip(grads, names)):
            continue
        outputs[slot + GRAD_SUFFIX] = grads
    if not outputs:
        return []
    attrs = dict(op.attrs)
    attrs["__fwd_op__"] = op
    return [Operator(op.block, grad_type, inputs, outputs, attrs)]


def make_grad_ops(op: Operator, no_grad_set=frozenset()):
    info = get_op_info(op.type)
    if info.grad_maker is not None:
        return info.grad_maker(op, no_grad_set)
    return default_grad_maker(op, no_grad_set)
