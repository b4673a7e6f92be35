"""Executable cost models: static flops and bytes per prepared program
(the port's copy of ``paddle_tpu/observability/costmodel.py``).

A wall time alone cannot tell "the model got more expensive" from "the
host was slow"; this module supplies the static side.

* **Snapshots**: one per (``Program.fingerprint()``, feed specs, kind),
  noted by the Executor each time it builds a PreparedProgram (the
  port's counterpart of an XLA compile). The JAX package reads XLA's
  ``cost_analysis()``; the port has no compiler to ask, so
  ``program_cost`` counts the Program itself, over its ops and var
  shapes:

  - 2·M·N·K for ``mul``, ``matmul`` and ``fc`` (and the products of the
    fused ``attention_block`` / ``ffn_block`` ops);
  - 4·B·H·Tq·Tk·Dh for ``attention`` and ``paged_decode_attention``
    (Tk of the paged op: the block table's pages times the page size,
    the positions it may read);
  - one a output element for the elementwise and reduction ops;
  - bytes: every counted op's inputs read once and outputs written once.

  A ``while`` body is counted once, as XLA counts it (its trip count is
  data), so a decode serve program's ``flops`` is the cost of one TICK
  plus its admission prologue: the unit the expected-vs-actual
  annotation needs. Noting is lazy: the Executor records the program
  and its feed specs, and the first ``lookup`` at ``metrics`` or
  ``trace`` counts it, so ``off`` pays nothing.

* **Calibration**: ``observe(flops, seconds)`` feeds achieved-rate
  samples (the servers report tick-flops x ticks a burst);
  ``flops_per_s()`` is the median of a bounded window, and
  ``expected_ms(flops)`` divides by it.
"""
from __future__ import annotations

import collections
import math
import statistics
import threading
import weakref
from typing import Dict, Optional, Tuple

import numpy as np

from .metrics import REGISTRY, metrics_on

__all__ = ["ExecutableCostModel", "MODEL", "note_executable",
           "lookup", "observe", "flops_per_s", "expected_ms",
           "snapshot_fields", "feed_specs_of", "program_cost"]

_COST_FIELDS = ("flops", "bytes_accessed", "product_flops",
                "attention_flops", "elementwise_flops")

# ops costed one flop an output element
_ELEMENTWISE = frozenset((
    "relu", "exp", "sqrt", "rsqrt", "square", "sign", "ceil", "floor",
    "cos", "scale", "clip", "softmax", "filtered_softmax", "layer_norm",
    "dropout", "increment", "equal", "not_equal", "less_than",
    "less_equal", "greater_than", "greater_equal", "mean", "sum",
    "arg_max", "squared_l2_norm", "softmax_with_cross_entropy"))
_ELEMENTWISE_PREFIXES = ("elementwise_", "reduce_", "logical_")
# plumbing whose bytes belong to the ops around it, not to a kernel
_SKIP = frozenset(("feed", "fetch", "while", "conditional_block"))
_SUB_BLOCK_OPS = ("while", "conditional_block")


def snapshot_fields() -> Tuple[str, ...]:
    """The keys a resolved snapshot may carry."""
    return _COST_FIELDS + ("kind", "fingerprint")


def _np_dtype_name(dtype) -> str:
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else str(
        np.dtype(s))


def feed_specs_of(program, feed) -> Optional[tuple]:
    """The sorted (name, shape, dtype) specs of a feed as the Executor
    stages it (a value is cast to its declared dtype within the same
    float/int family), read off the values in place. `feed` is a dict of
    values, or (name, shape, dtype) entries as a decode bundle's
    ``serve_feed_spec`` gives them. None when anything defies it."""
    from ..core.types import to_np_dtype

    try:
        block = program.global_block
        items = feed.items() if isinstance(feed, dict) else (
            (f[0], f) for f in feed)
        specs = []
        for name, val in items:
            if isinstance(val, tuple) and len(val) == 3 \
                    and isinstance(val[0], str):
                shape, dtype = tuple(val[1]), _np_dtype_name(val[2])
            else:
                if not hasattr(val, "shape"):
                    val = np.asarray(val)
                shape, dtype = tuple(val.shape), _np_dtype_name(val.dtype)
            var = block._find_var_recursive(name)
            if var is not None and var.dtype is not None:
                decl = np.dtype(to_np_dtype(var.dtype)).name
                if decl != dtype and np.issubdtype(np.dtype(dtype),
                                                   np.floating) \
                        == np.issubdtype(np.dtype(decl), np.floating):
                    dtype = decl
            specs.append((name, shape, dtype))
        return tuple(sorted(specs))
    except Exception:
        return None


# --- the static count ----------------------------------------------------
def _dim_resolver(program, feed_specs):
    """Declared shape -> concrete shape: a -1 dim takes the fed batch when
    it is its var's first -1, else the fed sequence length (the dims a
    feed's declared -1s take), 1 when no feed says."""
    batch = seq = None
    block = program.global_block
    for name, shape, _ in feed_specs or ():
        var = block._find_var_recursive(name)
        if var is None or not var.shape or len(var.shape) != len(shape):
            continue
        negs = [ax for ax, d in enumerate(var.shape) if d == -1]
        for i, ax in enumerate(negs):
            if i == 0 and batch is None:
                batch = int(shape[ax])
            elif i > 0 and seq is None:
                seq = int(shape[ax])

    def resolve(shape):
        out, first = [], True
        for d in shape:
            if d == -1:
                d = (batch if first else seq) or 1
                first = False
            out.append(int(d))
        return tuple(out)

    return resolve


def _op_flops(op, shape):
    """(products, attention, elementwise) flops of one op."""
    t = op.type
    if t == "mul":
        x, y = shape("X"), shape("Y")
        xn = int(op.attrs.get("x_num_col_dims", 1))
        yn = int(op.attrs.get("y_num_col_dims", 1))
        return 2 * math.prod(x[:xn]) * math.prod(x[xn:]) \
            * math.prod(y[yn:]), 0, 0
    if t == "fc":
        x, w = shape("Input"), shape("W")
        n = int(op.attrs.get("in_num_col_dims", 1))
        return 2 * math.prod(x[:n]) * math.prod(x[n:]) * w[-1], 0, 0
    if t == "matmul":
        x = shape("X")
        k = x[-2] if op.attrs.get("transpose_X") else x[-1]
        return 2 * math.prod(shape("Out", out=True)) * k, 0, 0
    if t == "attention":
        q, k = shape("Q"), shape("K")
        if op.attrs.get("layout", "bthd") == "bthd":
            b, tq, h, dh = q
            tk = k[1]
        else:
            b, h, tq, dh = q
            tk = k[2]
        return 0, 4 * b * h * tq * tk * dh, 0
    if t == "paged_decode_attention":
        r, h, tq, dh = shape("Q")
        tk = shape("BlockTab")[1] * shape("PoolK")[1]
        return 0, 4 * r * h * tq * tk * dh, 0
    if t == "attention_block":
        b, tq, d = shape("X")  # H * Dh = d
        return 2 * b * tq * d * (3 * d + d), 4 * b * tq * tq * d, 0
    if t == "ffn_block":
        x, w1 = shape("X"), shape("W1")
        return 4 * math.prod(x[:-1]) * w1[0] * w1[1], 0, 0
    if t in _ELEMENTWISE or t.startswith(_ELEMENTWISE_PREFIXES):
        return 0, 0, sum(math.prod(shape(s, out=True))
                         for s in op.outputs)
    return 0, 0, 0


def _var_bytes(var, resolve):
    from ..core.types import to_np_dtype

    if var is None or var.shape is None or var.dtype is None:
        return 0
    return math.prod(resolve(var.shape)) \
        * np.dtype(to_np_dtype(var.dtype)).itemsize


def program_cost(program, feed_specs=()) -> Dict[str, int]:
    """Static cost of one run of `program` at `feed_specs` ((name, shape,
    dtype) entries; the dims that the program declares -1 take them):
    ``flops`` = ``product_flops`` + ``attention_flops`` +
    ``elementwise_flops`` and ``bytes_accessed`` (module docstring). A
    ``while`` or ``conditional_block`` body counts once."""
    resolve = _dim_resolver(program, feed_specs)
    tot = dict.fromkeys(("product_flops", "attention_flops",
                         "elementwise_flops", "bytes_accessed"), 0)
    seen = set()

    def walk(block):
        if block.idx in seen:
            return
        seen.add(block.idx)
        for op in block.ops:
            if op.type in _SUB_BLOCK_OPS:
                sub = op.attrs.get("sub_block")
                if sub is not None:
                    walk(sub)
            if op.type in _SKIP:
                continue

            def shape(slot, out=False, op=op):
                names = (op.outputs if out else op.inputs).get(slot) or []
                var = block._find_var_recursive(names[0]) if names \
                    else None
                return resolve(var.shape) if var is not None \
                    and var.shape is not None else ()

            try:
                p, a, e = _op_flops(op, shape)
            except (KeyError, ValueError, TypeError, IndexError):
                p = a = e = 0  # a shape the rule cannot read: uncounted
            tot["product_flops"] += p
            tot["attention_flops"] += a
            tot["elementwise_flops"] += e
            for names in list(op.inputs.values()) \
                    + list(op.outputs.values()):
                for n in names:
                    tot["bytes_accessed"] += _var_bytes(
                        block._find_var_recursive(n), resolve)

    walk(program.global_block)
    tot["flops"] = tot["product_flops"] + tot["attention_flops"] \
        + tot["elementwise_flops"]
    return tot


class ExecutableCostModel:
    """Process-global snapshot store and achieved-rate calibration
    (module docstring). Thread-safe: the Executor and the serving
    threads touch it concurrently."""

    def __init__(self, rate_window: int = 64):
        self._lock = threading.Lock()
        self._snapshots: Dict[tuple, dict] = {}
        self._latest: Dict[str, dict] = {}      # fingerprint -> snap
        # (uid, version, specs, kind) -> (program weakref, specs, kind)
        self._probes: Dict[tuple, tuple] = {}
        self._noted: set = set()
        self._rates = collections.deque(maxlen=rate_window)
        self.probe_resolutions = 0   # static counts actually run
        self.probe_failures = 0
        REGISTRY.register_provider(self)

    # --- capture (the Executor's build hook) ------------------------
    def note_executable(self, program, kind: str = "block",
                        feed_specs=()):
        """Note one PreparedProgram build: the program (weakly) and its
        feed specs, counted at the first metrics-on lookup. Never
        raises."""
        try:
            specs = tuple(sorted(feed_specs or ()))
            key = (program._uid, program._version, specs, kind)
            with self._lock:
                if key in self._noted:
                    return
                self._noted.add(key)
                self._probes[key] = (weakref.ref(program), specs, kind)
        except Exception:
            pass

    # --- query --------------------------------------------------------
    def lookup(self, program, feed_arrays=None) -> Optional[dict]:
        """The snapshot of `program` (by fingerprint), counting its noted
        builds on the first call at ``metrics`` or ``trace``. With
        ``feed_arrays`` (a feed dict) the snapshot of those feed specs
        is preferred; else the latest for the fingerprint. At ``off`` a
        pending build stays pending and what is known is returned."""
        try:
            fp = program.fingerprint()
            uid = program._uid
        except Exception:
            return None
        specs = feed_specs_of(program, feed_arrays) \
            if feed_arrays else None
        with self._lock:
            if specs is not None:
                exact = self._snapshots.get((fp, specs, "block"))
                if exact is not None:
                    return exact
            pending = [(k, v) for k, v in self._probes.items()
                       if k[0] == uid]
            fallback = self._latest.get(fp)
        if not pending or not metrics_on():
            return fallback
        snap = fallback
        for key, (ref, pspecs, kind) in pending:
            got = self._resolve(key, ref(), fp, pspecs, kind)
            if specs is None or pspecs == specs:
                snap = got
        return snap

    def _resolve(self, key, program, fp, specs, kind) -> dict:
        snap = {"kind": kind, "fingerprint": fp[:16]}
        if program is not None:
            try:
                snap.update({k: float(v) for k, v in
                             program_cost(program, specs).items()})
                self.probe_resolutions += 1
            except Exception:
                self.probe_failures += 1
        else:
            self.probe_failures += 1
        with self._lock:
            self._probes.pop(key, None)
            self._snapshots[(fp, specs, kind)] = snap
            self._latest[fp] = snap
        return snap

    # --- calibration --------------------------------------------------
    def observe(self, flops: float, seconds: float):
        """One achieved-rate sample (the flops a dispatch moved over the
        wall seconds it took)."""
        if flops and seconds and seconds > 0:
            with self._lock:
                self._rates.append(flops / seconds)

    def flops_per_s(self) -> Optional[float]:
        """Median achieved rate over the bounded sample window."""
        with self._lock:
            if not self._rates:
                return None
            return statistics.median(self._rates)

    def expected_ms(self, flops: Optional[float]) -> Optional[float]:
        """Calibrated expectation for moving `flops` once (for a serve
        program: one tick, its while body counted once)."""
        rate = self.flops_per_s()
        if not flops or not rate:
            return None
        return flops / rate * 1e3

    # --- the observer observed ----------------------------------------
    def _metrics_samples(self):
        with self._lock:
            n_snap = len(self._snapshots)
            n_pending = len(self._probes)
            rate = (statistics.median(self._rates)
                    if self._rates else 0.0)
        return [
            ("paddle_tpu_costmodel_snapshots", {}, n_snap),
            ("paddle_tpu_costmodel_pending_probes", {}, n_pending),
            ("paddle_tpu_costmodel_probe_resolutions_total", {},
             self.probe_resolutions),
            ("paddle_tpu_costmodel_flops_per_s", {}, rate),
        ]

    def reset(self):
        """Tests: drop snapshots, pending builds and calibration."""
        with self._lock:
            self._snapshots.clear()
            self._latest.clear()
            self._probes.clear()
            self._noted.clear()
            self._rates.clear()
            self.probe_resolutions = 0
            self.probe_failures = 0


MODEL = ExecutableCostModel()

# the module-level call surface, as observability.metrics'
note_executable = MODEL.note_executable
lookup = MODEL.lookup
observe = MODEL.observe
flops_per_s = MODEL.flops_per_s
expected_ms = MODEL.expected_ms
