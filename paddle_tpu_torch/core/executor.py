"""Executor: interprets a Block op by op over torch tensors.

Counterpart of ``paddle_tpu/core/executor.py``. The JAX package traces a
whole Block into one XLA computation; this port runs the reference
Fluid design instead (framework/executor.cc:377): each op's kernel is
called in program order on the place's device, and control-flow ops
interpret their sub-blocks the same way. ``Executor.prepare`` binds a
program to its fetch list once, as the serving loops run the same
programs over and over. The executable caches, the on-disk compile
cache, native builds, ``run_steps`` and sharding of the JAX package
have no counterpart here yet.

``Executor()`` with no place runs on the card (``CUDAPlace(0)``). With
no card it raises and names ``CPUPlace()``; it never carries on on the
CPU unless asked to.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .program import Program, Variable, default_main_program
from .registry import EMPTY_VAR, is_registered, run_op
from .scope import Scope, global_scope
from .types import to_torch_dtype

# feed/fetch are plumbing, never kernels
_SKIP_OP_TYPES = ("feed", "fetch")

def _init_cuda_context():
    """The JAX package computes in float32; TF32 would change the
    digits of every product, so both switches are off wherever the
    port runs on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class CPUPlace:
    """Host placement (reference platform/place.h CPUPlace)."""

    def device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace()"


class CUDAPlace:
    """One card (reference platform/place.h CUDAPlace)."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{self!r}: no CUDA device is available. Pass "
                f"CPUPlace() to run on the host instead.")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"{self!r}: only {torch.cuda.device_count()} CUDA "
                f"device(s) present")
        _init_cuda_context()
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


def _check_feed_shape(block, name, value):
    """A rank or fixed-dim mismatch is named at the Executor boundary
    (executor.py:607 in the JAX package)."""
    var = block._find_var_recursive(name)
    if var is None or var.shape is None:
        return
    got = tuple(value.shape)
    want = tuple(var.shape)
    ok = len(got) == len(want) and all(
        w < 0 or g == w for g, w in zip(got, want))
    if not ok:
        raise ValueError(
            f"feed {name!r} has shape {got} but the "
            f"program declares {want} (-1 = any); check the "
            f"batch layout or the data() declaration")


def _coerce_feed(block, name, val, device) -> torch.Tensor:
    t = val if isinstance(val, torch.Tensor) \
        else torch.as_tensor(np.asarray(val))
    var = block._find_var_recursive(name)
    if var is not None and var.dtype is not None:
        want = to_torch_dtype(var.dtype)
        if t.dtype != want and t.is_floating_point() \
                == want.is_floating_point:
            t = t.to(want)
    return t.to(device)


def _to_fetch_names(fetch_list) -> List[str]:
    names = []
    if fetch_list is None:
        return names
    if not isinstance(fetch_list, (list, tuple)):
        fetch_list = [fetch_list]
    for f in fetch_list:
        if isinstance(f, Variable):
            names.append(f.name)
        elif isinstance(f, str):
            names.append(f)
        else:
            raise TypeError(f"bad fetch entry: {f!r}")
    return names


def _state_inputs(block, feed_names):
    """Names the block reads before writing them: they come from the
    scope. Sub-block reads are declared as the control-flow op's
    inputs, so one pass over the top-level ops finds them all."""
    produced = set(feed_names)
    state_in = []
    for op in block.ops:
        if op.type in _SKIP_OP_TYPES:
            continue
        if not is_registered(op.type):
            raise RuntimeError(f"op {op.type!r} has no registered kernel")
        for n in op.input_arg_names:
            if n != EMPTY_VAR and n not in produced \
                    and n not in state_in:
                state_in.append(n)
        produced.update(op.output_arg_names)
    return state_in


def _read_names(block, fetch_names):
    """Names a run reads after they are written: op inputs, fetches and
    persistables (committed to the scope). An op output outside this set
    may go unmaterialized (``OpContext.output_needed``)."""
    read = set(fetch_names)
    for op in block.ops:
        read.update(op.input_arg_names)
    read.update(n for n, v in block.vars.items() if v.persistable)
    return read


class Executor:
    """fluid.Executor parity (reference python/paddle/fluid/executor.py:451).

    ``compile_count``, ``cache_hit_count``, ``disk_load_count`` and
    ``cache_evict_count`` stay 0: an interpreting executor compiles
    nothing, and the servers' stats keep the JAX package's keys."""

    compile_count = 0
    cache_hit_count = 0
    disk_load_count = 0
    cache_evict_count = 0

    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()

    def _committed(self, scope: Scope, name: str) -> torch.Tensor:
        v = scope._get(name)
        if v is None:
            raise RuntimeError(
                f"Variable {name!r} is used before initialization -- "
                f"run the startup program first")
        if v.device != self.device:
            v = v.to(self.device)
            scope._set(name, v)
        return v

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope: Optional[Scope] = None,
            return_numpy: bool = True):
        program = program or default_main_program()
        feed = dict(feed or {})
        return self.prepare(program, feed, fetch_list, scope).run(
            feed, return_numpy=return_numpy)

    def prepare(self, program: Program, feed=None, fetch_list=None,
                scope: Optional[Scope] = None) -> "PreparedProgram":
        """A handle that runs `program` with this fetch list against
        `scope` (``paddle_tpu/core/executor.py:1313``): the names the
        block reads from the scope and the outputs anything reads are
        found once, here, not at every run. `feed` names the feeds: a
        dict, or a list of (name, shape, dtype) as a decode bundle's
        ``serve_feed_spec`` gives it."""
        if isinstance(feed, dict):
            feed_names = list(feed)
        else:
            feed_names = [f[0] if isinstance(f, (tuple, list)) else f
                          for f in (feed or ())]
        return PreparedProgram(self, program, feed_names,
                               _to_fetch_names(fetch_list),
                               scope or global_scope())

    def _run_block(self, prepared, feed, return_numpy):
        block = prepared.block
        scope = prepared.scope
        env: Dict[str, torch.Tensor] = {}
        for name, value in feed.items():
            t = _coerce_feed(block, name, value, self.device)
            _check_feed_shape(block, name, t)
            env[name] = t
        for name in prepared.state_in:
            if name not in env:
                env[name] = self._committed(scope, name)
        with torch.no_grad():
            for op in prepared.ops:
                run_op(op, env, self.device, prepared.seed,
                       prepared.needed)
        # persistable writes (parameters and optimizer state updated by
        # the optimizer ops, the step counter, a decode bundle's slot
        # state) replace the scope's values
        for name in prepared.persistable_out:
            scope._set(name, env[name])
        fetches = [env[n] if n in env else self._committed(scope, n)
                   for n in prepared.fetch_names]
        if return_numpy:
            return [f.detach().cpu().numpy() for f in fetches]
        return fetches


class PreparedProgram:
    """One program bound to a fetch list and a scope
    (``Executor.prepare``); ``run(feed)`` interprets it."""

    def __init__(self, exe: Executor, program: Program, feed_names,
                 fetch_names: List[str], scope: Scope):
        block = program.global_block
        for name in fetch_names:
            if not block.has_var(name) and name not in feed_names:
                raise KeyError(
                    f"fetch target {name!r} does not exist in the "
                    f"program")
        self.exe = exe
        self.block = block
        self.scope = scope
        self.fetch_names = fetch_names
        self.ops = [op for op in block.ops
                    if op.type not in _SKIP_OP_TYPES]
        self.state_in = _state_inputs(block, feed_names)
        self.needed = _read_names(block, fetch_names)
        # sampling ops seed from the program's seed (0 when unset)
        self.seed = program.random_seed or 0
        written = dict.fromkeys(n for op in self.ops
                                for n in op.output_arg_names)
        self.persistable_out = [
            n for n in written
            if (v := block._find_var_recursive(n)) is not None
            and v.persistable]

    def run(self, feed=None, return_numpy: bool = True):
        return self.exe._run_block(self, dict(feed or {}), return_numpy)
