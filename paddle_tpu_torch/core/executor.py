"""Executor: interprets a Block op by op over torch tensors.

Counterpart of ``paddle_tpu/core/executor.py``. The JAX package traces a
whole Block into one XLA computation; this port runs the reference
Fluid design instead (framework/executor.cc:377): each op's kernel is
called in program order on the place's device, and control-flow ops
interpret their sub-blocks the same way.

* ``Executor.run`` keeps a ``PreparedProgram`` per (program uid and
  version, feed specs, fetch names, scope), so a step walks the block's
  analysis once, not at every call; an entry of an older version of the
  program goes when the new one comes. A prepared program frees each
  intermediate after its last reader (``_last_use_plan_py``, as the JAX
  package plans it).
* ``Executor.run_steps`` runs K steps of one program with the
  reference's contract (stacked ``[K, ...]`` fetches, the K-th step's
  persistables in the scope). On the card it runs step 1 eagerly, then
  captures one step in a CUDA graph and replays it for the rest, so a
  step costs the host one replay in place of every op's dispatch; a
  later call with the same key replays every step and captures nothing
  (``compile_count`` counts captures). An executor's graphs share one
  memory pool, and a program keeps one captured step a scope: capturing
  it for another key drops the older graph. A program whose step cannot be
  captured (a ``while`` reading its condition on the host, a draw on a
  CPU generator) runs K eager steps on the card, with the reason in
  ``last_run_steps_fallback``. On the CPU every step is eager.
* The scope's step key (``RNG_VAR``) advances once per step, and sampling
  ops seed from it, so every run draws anew (``seed`` restarts it). An op
  that draws on the device (``dropout``, ``attention`` with dropout)
  reads a copy of the key that lives on the device and advances there,
  inside the step, with the host's arithmetic: a captured step draws
  anew at every replay, and replays draw what eager steps draw.
* The AMP state (``paddle_tpu_torch.amp``) is part of the cache keys: a
  program prepared or captured with AMP on never runs with it off, nor
  the other way round.

* ``prepare_count`` counts the PreparedPrograms built (the port's
  counterpart of an XLA compile, which is what the JAX package's
  ``compile_count`` counts; serving never captures, so it reads this
  one). Each build is noted in the executable cost model
  (``observability.costmodel``) and, under ``FLAGS_observability=trace``,
  recorded as a global ``compile`` event. The cache of PreparedPrograms
  holds at most ``FLAGS_executor_cache_capacity`` entries (least
  recently used first out; ``cache_evict_count``).

The on-disk compile cache, native builds and sharding of the JAX package
have no counterpart here yet.

``Executor()`` with no place runs on the card (``CUDAPlace(0)``). With
no card it raises and names ``CPUPlace()``; it never carries on on the
CPU unless asked to.
"""
from __future__ import annotations

import collections
import itertools
import time
import warnings
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import amp
from ..flags import FLAGS
from ..observability import costmodel as obs_costmodel
from ..observability import metrics as obs_metrics
from ..observability import tracing as obs_tracing
from .program import Block, Program, Variable, default_main_program
from .registry import (EMPTY_VAR, advance_key_t, get_op_info, is_registered,
                       run_op, splitmix64)
from .scope import Scope, global_scope
from .types import to_torch_dtype

# feed/fetch are plumbing, never kernels
_SKIP_OP_TYPES = ("feed", "fetch")

# the scope's step key: a 0-d int64 tensor on the host
RNG_VAR = "@RNG@"

_global_seed = [0]


def seed(s: int):
    """Set the global seed (``paddle_tpu.seed``): a scope running a
    program with no ``random_seed`` starts its step key from it. Drops
    the global scope's step key, so its draws start again."""
    _global_seed[0] = int(s)
    global_scope()._vars.pop(RNG_VAR, None)
    global_scope()._device_key = None


def _init_cuda_context():
    """The JAX package computes in float32; TF32 would change the
    digits of every product, so both switches are off wherever the
    port runs on the card. Under AMP a bf16 product accumulates in fp32
    (the JAX package's contract), so cuBLAS may not reduce in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False


class CPUPlace:
    """Host placement (reference platform/place.h CPUPlace). `device_id`
    is taken, as the JAX package takes it, and names no other device:
    the host is one."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A fetch as numpy; numpy has no bf16, so a bf16 value (under AMP)
    comes back widened to float32, which holds it exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _feed_specs(feed) -> List[tuple]:
    """(name, shape, dtype) of each feed value, as the cache keys take
    them."""
    specs = []
    for name, val in feed.items():
        if not isinstance(val, (np.ndarray, torch.Tensor)):
            val = np.asarray(val)
        specs.append((name, tuple(val.shape), str(val.dtype)))
    return specs


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


def _last_use_plan_py(block, feed_names, fetch_names):
    """For each op of `block`, the names whose last reader or writer it
    is (``paddle_tpu/core/executor.py`` ``_last_use_plan_py``): a run
    may drop them right after it. Feeds, fetches and persistables are
    never dropped."""
    protect = set(feed_names) | set(fetch_names)
    last_use = {}
    for i, op in enumerate(block.ops):
        for n in op.input_arg_names:
            last_use[n] = i
        for n in op.output_arg_names:
            last_use[n] = i
    plan = [[] for _ in block.ops]
    for name, i in last_use.items():
        if name == EMPTY_VAR or name in protect:
            continue
        var = block._find_var_recursive(name)
        if var is not None and var.persistable:
            continue
        plan[i].append(name)
    return [sorted(p) for p in plan]


# control-flow ops that read nothing back to the host (they select their
# sub-block's results on the device): a CUDA graph captures them
_CAPTURED_BLOCK_OPS = ("run_block_if",)


def _capture_fallback_reason(program, ops=None) -> Optional[str]:
    """Why one step of `program` cannot be captured in a CUDA graph
    (``_scan_fallback_reason`` in the JAX package), or None. An op that
    draws from the device step key is captured, and so is a
    ``run_block_if`` whose sub-block is."""
    for op in program.global_block.ops if ops is None else ops:
        blocks = [v for v in op.attrs.values() if isinstance(v, Block)]
        if blocks and op.type not in _CAPTURED_BLOCK_OPS:
            return (f"op {op.type!r} reads its condition back to the "
                    f"host every iteration, which a CUDA graph cannot "
                    f"replay")
        if is_registered(op.type) and get_op_info(op.type).host_rng:
            return (f"op {op.type!r} draws on a CPU generator; a "
                    f"captured draw would repeat on every replay")
        for blk in blocks:
            reason = _capture_fallback_reason(program, blk.ops)
            if reason is not None:
                return reason
    return None


def _draws_on_device(program) -> bool:
    """Whether an op of `program` draws from the device step key."""
    return any(is_registered(op.type)
               and (info := get_op_info(op.type)).needs_rng
               and not info.host_rng
               for blk in program.blocks for op in blk.ops)


class Executor:
    """fluid.Executor parity (reference python/paddle/fluid/executor.py:451).

    ``compile_count`` counts the steps captured in CUDA graphs,
    ``prepare_count`` the PreparedPrograms built (every lookup that
    missed the cache, every ``prepare`` and every handle a
    ``PreparedCache`` makes: the port's counterpart of an XLA compile),
    ``cache_hit_count`` the calls that found their PreparedProgram
    cached and ``cache_evict_count`` the entries the cache's bound
    (``FLAGS_executor_cache_capacity``) pushed out. ``disk_load_count``
    stays 0: the port has no disk cache. The counters are read at
    ``observability.metrics.expose()`` time (a weakref provider)."""

    disk_load_count = 0
    _obs_seq = itertools.count(1)

    def __init__(self, place=None, donate: bool = True,
                 cache: Optional[Dict] = None):
        """`donate` is taken and changes nothing: the port's ops never
        write into the tensors they read, so there is no buffer to hand
        over (XLA's donation in the JAX package). `cache`, a dict, is
        the program cache to share with other executors: a program one of
        them prepared is a hit for the others of the same place. The
        place is part of each key, so an executor of another place misses
        and prepares its own."""
        self.place = place if place is not None else CUDAPlace(0)
        self.device = self.place.device()
        self.compile_count = 0
        self.prepare_count = 0
        self.cache_hit_count = 0
        self.cache_evict_count = 0
        self._cache_inserts = 0
        # close() calls: a PreparedCache over this executor drops its
        # handles when it moves
        self.close_count = 0
        self.last_run_steps_fallback: Optional[str] = None
        self._cache: Dict[tuple, PreparedProgram] = \
            {} if cache is None else cache
        self._warned = set()
        self._stream = None  # the side stream of warm-ups and captures
        self._pool = None  # the memory pool every captured graph shares
        # (program uid, scope uid): the prepared program whose captured
        # step is alive for them
        self._capture_owner: Dict[tuple, weakref.ref] = {}
        n = next(Executor._obs_seq)
        self._obs_id = f"executor-{n}"
        self._obs_cache_id = f"exe-cache-{n}"
        obs_metrics.register_provider(self)

    def _metrics_samples(self):
        """Pull-provider for observability.metrics.expose(): the counters
        above and the PreparedProgram cache's residency."""
        lab = {"executor": self._obs_id}
        cache = {"cache": self._obs_cache_id}
        cap = FLAGS.executor_cache_capacity
        return [
            ("paddle_tpu_executor_compiles_total", lab,
             self.compile_count),
            ("paddle_tpu_executor_prepares_total", lab,
             self.prepare_count),
            ("paddle_tpu_executor_cache_hits_total", lab,
             self.cache_hit_count),
            ("paddle_tpu_executor_disk_loads_total", lab,
             self.disk_load_count),
            ("paddle_tpu_executor_cache_evictions_total", lab,
             self.cache_evict_count),
            ("paddle_tpu_executable_cache_size", cache, len(self._cache)),
            ("paddle_tpu_executable_cache_capacity", cache,
             cap if cap > 0 else 0),
            ("paddle_tpu_executable_cache_inserts_total", cache,
             self._cache_inserts),
            ("paddle_tpu_executable_cache_evictions_total", cache,
             self.cache_evict_count),
        ]

    def _note_build(self, program, kind, feed_specs, t0):
        """One PreparedProgram built: counted, noted in the cost model
        (counted there at the first metrics-on lookup) and, under
        ``trace``, recorded as a global ``compile`` event."""
        self.prepare_count += 1
        specs = obs_costmodel.feed_specs_of(program, feed_specs) or ()
        obs_costmodel.note_executable(program, kind, specs)
        if obs_tracing.trace_on():
            obs_tracing.record_global_event(
                "compile", t0, time.monotonic(), kind=kind, tier="cold",
                fingerprint=program.fingerprint()[:16],
                executor=self._obs_id)

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
            fetch_list=None, feed_var_name="feed", fetch_var_name="fetch",
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True):
        """One step, through the PreparedProgram cached for this program,
        feed specs, fetch list and scope; the reference's parameters in
        its order. `feed_var_name` and `fetch_var_name` are taken and
        change nothing (the port's programs hold no feed or fetch ops to
        name). With `use_program_cache=False` the step runs through a
        PreparedProgram made for it alone, which is not cached."""
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = dict(feed or {})
        fetch_names = _to_fetch_names(fetch_list)
        key = self._block_cache_key(program, _feed_specs(feed),
                                    fetch_names, scope)
        prepared = self._prepared(key, scope, lambda: PreparedProgram(
            self, program, list(feed), fetch_names, scope,
            feed_specs=feed), use_program_cache)
        return prepared.run(feed, return_numpy=return_numpy)

    def run_steps(self, program: Optional[Program] = None, feed=None,
                  fetch_list=None, steps: Optional[int] = None,
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True,
                  use_program_cache: bool = True):
        """K steps of `program` (``paddle_tpu/core/executor.py``
        ``run_steps``), equal to K ``run`` calls: the step key advances
        once a step and the K-th step's persistables end in the scope.

        `feed` is one dict (the same batch every step; `steps` required)
        or a list of K dicts binding the same names, stacked and staged
        on the device with one transfer a name. Returns one stacked
        ``[K, ...]`` value per fetch: numpy arrays, or with
        ``return_numpy=False`` tensors on the place's device.

        On the card the first call runs step 1 eagerly on a side stream,
        captures one step in a CUDA graph on it and replays the graph for
        the rest; a later call under the same key replays all K (with
        ``use_program_cache=False`` nothing is kept: each call prepares,
        and on the card captures, anew). A step
        that cannot be captured runs eagerly on the card, with the reason
        in ``last_run_steps_fallback`` (None otherwise) and warned once
        per program and reason; any other failure to capture raises. On
        the CPU every step is eager."""
        program = program or default_main_program()
        scope = scope or global_scope()
        stacked = isinstance(feed, (list, tuple))
        if stacked:
            feed = [dict(f) for f in feed]
            if not feed:
                raise ValueError("run_steps: empty feed list")
            if steps is None:
                steps = len(feed)
            if int(steps) != len(feed):
                raise ValueError(
                    f"run_steps: steps={steps} but {len(feed)} feed "
                    f"dicts were given")
            names0 = set(feed[0])
            if any(set(f) != names0 for f in feed):
                raise ValueError(
                    "run_steps: all per-step feed dicts must bind the "
                    "same variable names")
        else:
            feed = dict(feed or {})
            if steps is None:
                raise ValueError(
                    "run_steps: steps=K is required when feeding one "
                    "dict (pass a list of K dicts for per-step batches)")
        steps = int(steps)
        if steps < 1:
            raise ValueError(f"run_steps: steps must be >= 1, got {steps}")
        first = feed[0] if stacked else feed
        fetch_names = _to_fetch_names(fetch_list)
        key = self._block_cache_key(program, _feed_specs(first),
                                    fetch_names, scope) + (steps, stacked)
        prepared = self._prepared(key, scope, lambda: PreparedProgram(
            self, program, list(first), fetch_names, scope, steps=steps,
            feed_specs=first), use_program_cache)
        return self._run_steps(prepared, feed, stacked, return_numpy)

    def prepare(self, program: Program, feed=None, fetch_list=None,
                scope: Optional[Scope] = None,
                steps: Optional[int] = None) -> "PreparedProgram":
        """A handle that runs `program` with this fetch list against
        `scope` (``paddle_tpu/core/executor.py:1313``): the names the
        block reads from the scope, the outputs anything reads and the
        last-use plan are found once, here, not at every run. `feed`
        names the feeds: a dict, or a list of (name, shape, dtype) as a
        decode bundle's ``serve_feed_spec`` gives it. With `steps` = K,
        ``run(feed)`` runs K steps on one feed dict as ``run_steps`` does
        (on the card, through one captured graph kept by the handle),
        and ``fallback_reason`` names why a step would not be captured.
        The handle holds `scope` weakly, as the executor's cache does:
        the caller keeps it."""
        if isinstance(feed, dict):
            feed_names = list(feed)
            specs = feed
        else:
            feed_names = [f[0] if isinstance(f, (tuple, list)) else f
                          for f in (feed or ())]
            specs = [f for f in (feed or ())
                     if isinstance(f, (tuple, list)) and len(f) == 3]
        if steps is not None and int(steps) < 1:
            raise ValueError(f"prepare: steps must be >= 1, got {steps}")
        return PreparedProgram(self, program, feed_names,
                               _to_fetch_names(fetch_list),
                               scope or global_scope(),
                               steps=None if steps is None else int(steps),
                               feed_specs=specs)

    def close(self):
        """Drop every prepared program this executor cached, with the
        steps they captured (``Executor.close`` in the JAX package clears
        its executable cache). A later run prepares again."""
        self._cache.clear()
        self.close_count += 1

    # --- the program cache ---------------------------------------------
    def _block_cache_key(self, program, feed_specs, fetch_names, scope):
        """(``_block_cache_key`` in the JAX package, with the scope the
        prepared program binds and this executor's device, as a shared
        cache needs.) A `_version` bump misses, and so does a change of
        the AMP state."""
        return (program._uid, program._version, tuple(sorted(feed_specs)),
                tuple(fetch_names), scope._uid, amp.state_token(),
                str(self.device))

    def _prepared(self, key, scope, make, use_cache=True):
        """The PreparedProgram cached under `key`, or `make()`'s, kept
        in the cache until `scope` is gone (with it go the tensors of a
        captured step), the program's `_version` moves on (a new entry
        drops those of the program's older versions for this scope) or
        FLAGS_executor_cache_capacity newer entries push it out (least
        recently used first). Without `use_cache`, `make()`'s, neither
        looked up nor kept."""
        if not use_cache:
            return make()
        prepared = self._cache.get(key)
        if prepared is not None:
            self.cache_hit_count += 1
            # the most recently used entry goes last
            self._cache[key] = self._cache.pop(key, prepared)
            return prepared
        uid, version, scope_uid = key[0], key[1], key[4]
        for old in [k for k in self._cache if k[0] == uid
                    and k[4] == scope_uid and k[1] != version]:
            del self._cache[old]
        prepared = self._cache[key] = make()
        self._cache_inserts += 1
        cap = FLAGS.executor_cache_capacity
        while cap > 0 and len(self._cache) > cap:
            self._cache.pop(next(iter(self._cache)))
            self.cache_evict_count += 1
        weakref.finalize(scope, _forget, weakref.ref(self), key)
        return prepared

    # --- one step --------------------------------------------------------
    @staticmethod
    def _current_key(prepared) -> int:
        """The key of the scope's next step. A scope with no key starts
        from the program's seed, or the global seed when the program has
        none."""
        k = prepared.scope._get(RNG_VAR)
        if k is not None:
            return int(k)
        if prepared.program.random_seed is not None:
            return int(prepared.program.random_seed)
        return _global_seed[0]

    def _step_key(self, prepared) -> int:
        """This step's key; the scope's advances once."""
        key = self._current_key(prepared)
        prepared.scope._set(RNG_VAR, torch.tensor(splitmix64(key) >> 1))
        return key

    def _device_key(self, scope, key: int) -> torch.Tensor:
        """The step key `key` as a 0-d int64 tensor on the device: the one
        the scope's last step advanced on the device when it holds that
        key, else a copy from the host (the first step, or after
        ``seed``)."""
        held = scope._device_key
        if held is not None and held[0] == key \
                and held[1].device == self.device:
            return held[1]
        return torch.tensor(key, dtype=torch.int64, device=self.device)

    def _stage(self, prepared, feed) -> Dict[str, torch.Tensor]:
        """The env before the first op: the feeds, coerced and on the
        device, and the values the block reads from the scope."""
        block = prepared.block
        env: Dict[str, torch.Tensor] = {}
        for name, value in feed.items():
            t = _coerce_feed(block, name, value, self.device)
            _check_feed_shape(block, name, t)
            env[name] = t
        for name in prepared.state_in:
            if name not in env:
                env[name] = self._committed(prepared.scope, name)
        return env

    def _step(self, prepared, env, key, dkey=None):
        """The block's ops over `env`, each value dropped after its last
        reader."""
        with torch.no_grad():
            for op, dead in zip(prepared.ops, prepared.frees):
                run_op(op, env, self.device, prepared.seed,
                       prepared.needed, key, dkey)
                for n in dead:
                    env.pop(n, None)

    def _run_block(self, prepared, feed, return_numpy):
        env = self._stage(prepared, feed)
        scope = prepared.scope
        key = self._step_key(prepared)
        dkey = self._device_key(scope, key) if prepared.draws else None
        self._step(prepared, env, key, dkey)
        if dkey is not None:
            # the device's copy advances on the device, with no host copy
            scope._device_key = (splitmix64(key) >> 1,
                                 advance_key_t(dkey))
        # persistable writes (parameters and optimizer state updated by
        # the optimizer ops, the step counter, a decode bundle's slot
        # state) replace the scope's values
        for name in prepared.persistable_out:
            scope._set(name, env[name])
        fetches = [env[n] if n in env else self._committed(scope, n)
                   for n in prepared.fetch_names]
        if return_numpy:
            return [_to_numpy(f) for f in fetches]
        return fetches

    # --- K steps ---------------------------------------------------------
    def _run_steps(self, prepared, feed, stacked, return_numpy):
        reason = prepared.fallback_reason
        self.last_run_steps_fallback = reason
        if reason is not None:
            tok = (prepared.program._uid, reason)
            if tok not in self._warned:
                self._warned.add(tok)
                warnings.warn(f"run_steps: eager steps: {reason}")
        staged = self._stage_feeds(prepared.block, feed, stacked)
        if self.device.type == "cuda" and reason is None:
            outs = self._graph_steps(prepared, staged, stacked)
        else:
            outs = self._eager_steps(prepared, staged, stacked)
        if return_numpy:
            return [_to_numpy(o) for o in outs]
        return outs

    def _stage_feeds(self, block, feed, stacked):
        """The feeds on the device: each stacked ``[K, ...]`` from a list
        of K dicts, moved with one transfer."""
        if not stacked:
            staged = {n: _coerce_feed(block, n, v, self.device)
                      for n, v in feed.items()}
            for n, t in staged.items():
                _check_feed_shape(block, n, t)
            return staged
        staged = {}
        for name in feed[0]:
            cols = [f[name] for f in feed]
            if all(isinstance(c, torch.Tensor) for c in cols):
                t = torch.stack(cols)
            else:
                t = torch.from_numpy(np.stack([np.asarray(c) for c in cols]))
            t = _coerce_feed(block, name, t, self.device)
            _check_feed_shape(block, name, t[0])
            staged[name] = t
        return staged

    def _eager_steps(self, prepared, staged, stacked):
        per_step = [
            self._run_block(prepared, {n: t[k] for n, t in staged.items()}
                            if stacked else staged, return_numpy=False)
            for k in range(prepared.steps)]
        return [torch.stack(col) for col in zip(*per_step)]

    def _graph_steps(self, prepared, staged, stacked):
        steps = prepared.steps
        cap = prepared.captured
        first = 0
        if cap is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            self._drop_older_capture(prepared)
            side = self._stream
            feed0 = {n: t[0] for n, t in staged.items()} if stacked \
                else staged
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                warm = self._run_block(prepared, feed0, return_numpy=False)
                cap = _CapturedStep(self, prepared, feed0, side,
                                    self._pool)
            torch.cuda.current_stream(self.device).wait_stream(side)
            prepared.captured = cap
            self.compile_count += 1
            first = 1
        else:
            cap.load(self, prepared, staged, stacked)
        scope = prepared.scope
        if cap.key is not None:
            # the graph advances its key buffer at each replay
            cap.key.copy_(self._device_key(scope,
                                           self._current_key(prepared)))
        outs = [torch.empty((steps, *f.shape), dtype=f.dtype,
                            device=self.device) for f in cap.fetches]
        if first:
            for o, w in zip(outs, warm):
                o[0].copy_(w)
        for k in range(first, steps):
            if stacked:
                for n, buf in cap.feeds.items():
                    buf.copy_(staged[n][k])
            cap.graph.replay()
            for o, f in zip(outs, cap.fetches):
                o[k].copy_(f)
            self._step_key(prepared)
        if cap.key is not None:
            scope._device_key = (self._current_key(prepared), cap.key)
        for n in prepared.persistable_out:
            scope._set(n, cap.state[n])
        return outs

    def _drop_older_capture(self, prepared):
        """Before `prepared` captures: the captured step its program has
        for this scope under another key (another feed shape, `steps`,
        version) goes, with its buffers, so a program holds one."""
        owner = (prepared.program._uid, prepared.scope._uid)
        ref = self._capture_owner.get(owner)
        old = ref() if ref is not None else None
        if old is not None and old is not prepared:
            old.captured = None
        self._capture_owner[owner] = weakref.ref(prepared)


def _forget(exe_ref, key):
    exe = exe_ref()
    if exe is not None:
        exe._cache.pop(key, None)


class _CapturedStep:
    """One step of a prepared program captured in a CUDA graph on
    `stream`, right after the eager warm-up step that built and loaded
    the kernels, set their attributes and made cuBLAS's workspace for
    the stream. The graph reads static buffers: the feeds and every
    scope value the block reads, which hold the scope's state after the
    warm-up; it ends by copying each new persistable into its buffer.

    The graph allocates from `pool`, which the executor's other graphs
    share: what they leave there is overwritten at their replays. So
    every value that outlives a replay is a buffer made outside the
    pool (the feeds, the state, every persistable the step writes), and
    the fetches, which do lie in the pool, are copied out right after
    each replay."""

    def __init__(self, exe, prepared, feed, stream, pool):
        scope = prepared.scope
        self.feeds = {n: t.clone() for n, t in feed.items()}
        # the persistables the warm-up wrote (a fed one too: its feed
        # buffer must keep the feed), and a fetch the block neither reads
        # nor writes, are read from the scope like the block's inputs
        names = list(dict.fromkeys(prepared.state_in + [
            n for n in prepared.fetch_names if n not in prepared.written]
            + prepared.persistable_out))
        self.state = {n: exe._committed(scope, n).clone() for n in names
                      if n not in self.feeds
                      or n in prepared.persistable_out}
        bufs = {self.state[n].untyped_storage().data_ptr()
                for n in prepared.persistable_out}

        def own(t):
            """`t`, or a copy where it lies in a buffer that the copies
            at the end of the step overwrite (an op may return its input
            or a view of it)."""
            return t.clone() if t.untyped_storage().data_ptr() in bufs \
                else t

        # the device step key the ops draw from, advanced at the end of
        # the step (set before each call's replays)
        self.key = torch.zeros((), dtype=torch.int64, device=exe.device) \
            if prepared.draws else None
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream):
            env = {**self.state, **self.feeds}
            exe._step(prepared, env, key=0, dkey=self.key)
            self.fetches = [own(env[n]) for n in prepared.fetch_names]
            new = {n: own(env[n]) for n in prepared.persistable_out
                   if env[n] is not self.state[n]}
            for n, t in new.items():
                self.state[n].copy_(t)
            if self.key is not None:
                self.key.copy_(advance_key_t(self.key))

    def load(self, exe, prepared, staged, stacked):
        """Before a later call: the feeds and the scope's values into the
        static buffers, where they are not already those buffers."""
        for n, buf in self.feeds.items():
            src = staged[n][0] if stacked else staged[n]
            if src.shape != buf.shape or src.dtype != buf.dtype:
                raise ValueError(
                    f"run_steps: feed {n!r} is {tuple(src.shape)} "
                    f"{src.dtype}, the captured step takes "
                    f"{tuple(buf.shape)} {buf.dtype}; prepare again for "
                    f"another shape")
            if not stacked:
                buf.copy_(src)
        for n, buf in self.state.items():
            v = exe._committed(prepared.scope, n)
            if v is buf:
                continue
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(
                    f"run_steps: scope value {n!r} is {tuple(v.shape)} "
                    f"{v.dtype}, the captured step takes "
                    f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(v)


class PreparedProgram:
    """One program bound to a fetch list and a scope
    (``Executor.prepare``); ``run(feed)`` interprets it, or with `steps`
    runs K steps as ``Executor.run_steps`` does. A program edited since
    (its `_version` moved) is analysed again at the next run."""

    def __init__(self, exe: Executor, program: Program, feed_names,
                 fetch_names: List[str], scope: Scope,
                 steps: Optional[int] = None, feed_specs=()):
        """`feed_specs`: a feed dict or (name, shape, dtype) entries, the
        shapes the cost model counts this build at."""
        t0 = time.monotonic()
        self.exe = exe
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = fetch_names
        self.steps = steps
        self._scope = weakref.ref(scope)
        self._bind()
        exe._note_build(program, "block" if steps is None else "steps",
                        feed_specs, t0)

    def _bind(self):
        program = self.program
        block = program.global_block
        for name in self.fetch_names:
            if not block.has_var(name) and name not in self.feed_names:
                raise KeyError(
                    f"fetch target {name!r} does not exist in the "
                    f"program")
        self.version = program._version
        self.block = block
        self.ops = [op for op in block.ops
                    if op.type not in _SKIP_OP_TYPES]
        self.state_in = _state_inputs(block, self.feed_names)
        self.needed = _read_names(block, self.fetch_names)
        # each op's names to drop after it; a skipped op's pass to the
        # next op that runs
        self.frees, pending = [], []
        for op, dead in zip(block.ops, _last_use_plan_py(
                block, self.feed_names, self.fetch_names)):
            pending += dead
            if op.type not in _SKIP_OP_TYPES:
                self.frees.append(pending)
                pending = []
        # sampling ops seed from the program's seed (0 when unset)
        self.seed = program.random_seed or 0
        written = dict.fromkeys(n for op in self.ops
                                for n in op.output_arg_names)
        self.written = set(written)
        self.persistable_out = [
            n for n in written
            if (v := block._find_var_recursive(n)) is not None
            and v.persistable]
        self.fallback_reason = _capture_fallback_reason(program)
        self.draws = _draws_on_device(program)
        self.amp = amp.state_token()
        self.captured: Optional[_CapturedStep] = None

    @property
    def scope(self) -> Scope:
        scope = self._scope()
        if scope is None:
            raise RuntimeError(
                "the scope this program was prepared against is gone: "
                "keep a reference to it while the handle runs")
        return scope

    def run(self, feed=None, return_numpy: bool = True):
        if self.program._version != self.version \
                or amp.state_token() != self.amp:
            self._bind()
        feed = dict(feed or {})
        if self.steps is None:
            return self.exe._run_block(self, feed, return_numpy)
        return self.exe._run_steps(self, feed, False, return_numpy)


class PreparedCache:
    """Feed-spec-keyed LRU of PreparedPrograms, the serving hot loop's
    helper (``PreparedCache`` in the JAX package): the predictor looks a
    batch's PreparedProgram up by its feeds' names, shapes and dtypes,
    and prepares it on first sight. Capped, so traffic of many shapes
    cannot hold one handle a shape for ever."""

    CAPACITY = 32

    def __init__(self, executor: Executor, program, fetch_names, scope):
        self._exe = executor
        self._program = program
        self._fetch_names = list(fetch_names)
        self._scope = scope
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self._closes = executor.close_count
        # the handles prepared (lookups that missed)
        self.prepare_count = 0

    def lookup(self, feed) -> PreparedProgram:
        """The PreparedProgram for this feed's spec. Feed values that
        are not arrays or tensors become numpy arrays in place. After
        the executor's ``close()`` every handle is prepared again."""
        if self._exe.close_count != self._closes:
            self._d.clear()
            self._closes = self._exe.close_count
        key = []
        for n in sorted(feed):
            v = feed[n]
            if not isinstance(v, (np.ndarray, torch.Tensor)):
                v = feed[n] = np.asarray(v)
            key.append((n, tuple(v.shape), str(v.dtype)))
        key = tuple(key)
        prepared = self._d.get(key)
        if prepared is not None:
            self._d.move_to_end(key)
            return prepared
        prepared = self._exe.prepare(self._program, feed,
                                     fetch_list=self._fetch_names,
                                     scope=self._scope)
        self.prepare_count += 1
        self._d[key] = prepared
        while len(self._d) > self.CAPACITY:
            self._d.popitem(last=False)
        return prepared

    def __len__(self):
        return len(self._d)
