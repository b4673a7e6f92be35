"""Program representation: the program-as-data surface.

The port's own copy of ``paddle_tpu/core/program.py`` (reference
framework.proto ProgramDesc/BlockDesc/OpDesc/VarDesc and
python/paddle/fluid/framework.py:327,877,1339,2660). The structure is
the same, so the two packages build identical programs; here the
Executor interprets a Block op by op over torch tensors, as the
reference Fluid executor does (framework/executor.cc:377).

``to_dict``/``from_dict`` take the JAX package's dict schema key for key,
so a program written by either package loads in the other;
``fingerprint()`` is the sha256 of that dict, canonicalized as the JAX
package canonicalizes it (``canonical_digest``).
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .types import VarType, as_datatype

GRAD_SUFFIX = "@GRAD"


def _canon(o):
    """json.dumps default= hook: numpy values, enums and sets in a
    process-stable form (``paddle_tpu/core/compile_cache.py`` ``_canon``,
    of which the port keeps this copy and nothing else)."""
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return {"__ndarray__": o.reshape(-1).tolist(),
                "dtype": str(o.dtype), "shape": list(o.shape)}
    if isinstance(o, (set, frozenset)):
        return sorted(map(repr, o))
    value = getattr(o, "value", None)
    if value is not None and isinstance(value, (str, int)):
        return value
    return repr(o)


def canonical_digest(parts: Dict[str, Any]) -> str:
    """Stable sha256 of a JSON-canonicalized structure (the digest the
    JAX package's ``Program.fingerprint`` takes)."""
    blob = json.dumps(parts, sort_keys=True, default=_canon).encode()
    return hashlib.sha256(blob).hexdigest()


def grad_var_name(name: str) -> str:
    """The name of `name`'s gradient (reference framework.py
    grad_var_name)."""
    return name + GRAD_SUFFIX


class Variable:
    """A named slot in a Block (reference framework.py:327).

    Holds static metadata only (shape/dtype/lod_level/persistable); runtime
    values live in a Scope. shape may contain -1 for the batch dimension.
    """

    def __init__(self, block, name, shape=None, dtype=None,
                 lod_level=0, persistable=False, stop_gradient=False,
                 trainable=True, type=VarType.LOD_TENSOR, initializer=None,
                 is_data=False, need_check_feed=False, regularizer=None,
                 error_clip=None, do_model_average=False):
        self.block = block
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = as_datatype(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.type = type
        self.initializer = initializer
        self.is_data = is_data
        self.regularizer = regularizer
        self.error_clip = error_clip
        self.do_model_average = do_model_average

    # --- fluid-compatible sugar -------------------------------------------
    def astype(self, dtype):
        from .. import layers

        return layers.cast(self, dtype)

    def _binary(self, other, op, reverse=False):
        from .. import layers

        if not isinstance(other, Variable):
            other_np = np.asarray(other, dtype=self.dtype.value
                                  if self.dtype else "float32")
            other = layers.fill_constant(
                shape=list(other_np.shape) or [1],
                dtype=self.dtype or "float32", value=float(other_np))
        a, b = (other, self) if reverse else (self, other)
        return getattr(layers, op)(a, b)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    def __radd__(self, o):
        return self._binary(o, "elementwise_add", True)

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._binary(o, "elementwise_sub", True)

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    def __rmul__(self, o):
        return self._binary(o, "elementwise_mul", True)

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._binary(o, "elementwise_div", True)

    def __neg__(self):
        from .. import layers

        return layers.scale(self, scale=-1.0)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype.value if self.dtype else None}, "
                f"persistable={self.persistable})")

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype.value if self.dtype else None,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "trainable": self.trainable,
            "type": self.type.value,
            "is_data": self.is_data,
        }

    @staticmethod
    def from_dict(block, d):
        return Variable(
            block, d["name"], shape=d["shape"], dtype=d["dtype"],
            lod_level=d.get("lod_level", 0),
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            trainable=d.get("trainable", True),
            type=VarType(d.get("type", "lod_tensor")),
            is_data=d.get("is_data", False))

class Operator:
    """One op invocation (reference framework.py:877 / op_desc.h).

    inputs/outputs map slot name -> list of variable names. attrs is a plain
    dict (ints/floats/strings/bools/lists, or a Block for control-flow ops).
    """

    def __init__(self, block, type: str, inputs: Dict[str, List[str]],
                 outputs: Dict[str, List[str]], attrs: Optional[Dict] = None):
        # structural per-op id: the PRNG salt for ops that sample
        # (dropout, nce, ...). Derived from (block idx, op position) so
        # identical program builds get identical salts (seeded
        # reproducibility), and the grad op can re-derive the forward's
        # exact noise via its __fwd_op__ attr.
        blk_idx = getattr(block, "idx", 0) or 0
        n_ops = len(getattr(block, "ops", ()) or ())
        self._uid = blk_idx * 100003 + n_ops
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_arg_names(self):
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if k.startswith("__"):
                continue  # runtime-only attrs (the grad op's forward link)
            if isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            elif isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.reshape(-1).tolist(),
                            "dtype": str(v.dtype),
                            "shape": list(v.shape)}
            else:
                attrs[k] = v
        # the structural uid: sampling ops salt their draws with it
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": attrs, "uid": self._uid}

    @staticmethod
    def from_dict(block, d, program):
        attrs = {}
        for k, v in d["attrs"].items():
            if isinstance(v, dict) and "__block__" in v:
                attrs[k] = program.blocks[v["__block__"]]
            elif isinstance(v, dict) and "__ndarray__" in v:
                arr = np.asarray(v["__ndarray__"], dtype=v["dtype"])
                if "shape" in v:
                    arr = arr.reshape(v["shape"])
                attrs[k] = arr
            else:
                attrs[k] = v
        op = Operator(block, d["type"], d["inputs"], d["outputs"], attrs)
        if "uid" in d:
            op._uid = d["uid"]
        return op

class Block:
    """A sequence of ops + a var table (reference framework.py:1339)."""

    def __init__(self, program, idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name=None, **kwargs):
        if name is None:
            from ..unique_name import generate

            name = generate("tmp")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        var = self.create_var(name=name, shape=shape, dtype=dtype, **kwargs)
        self.program._parameters.setdefault(name, var)
        return var

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.insert_op(len(self.ops), type, inputs, outputs, attrs)

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None):
        return self.insert_op(0, type, inputs, outputs, attrs)

    def insert_op(self, index, type, inputs=None, outputs=None, attrs=None):
        """Every change to the op list bumps the program's `_version`,
        which the Executor's cache keys on."""
        inputs = _normalize_io(inputs)
        outputs = _normalize_io(outputs)
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._version += 1
        # infer shapes for outputs eagerly so later layers can read .shape
        from .registry import infer_shape_for_op

        infer_shape_for_op(op, self)
        return op

    def _remove_op(self, index):
        """Drop the op at `index` (reference framework.py Block._remove_op)."""
        del self.ops[index]
        self.program._version += 1

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

def _normalize_io(io) -> Dict[str, List[str]]:
    """Accept {slot: Variable | name | list of either} and normalize."""
    out: Dict[str, List[str]] = {}
    if not io:
        return out
    for slot, val in io.items():
        if val is None:
            continue
        if not isinstance(val, (list, tuple)):
            val = [val]
        names = []
        for v in val:
            if isinstance(v, Variable):
                names.append(v.name)
            elif isinstance(v, str):
                names.append(v)
            else:
                raise TypeError(f"bad io entry for slot {slot}: {v!r}")
        if names:
            out[slot] = names
    return out


_program_uid_counter = itertools.count()


class Program:
    """A whole trainable/executable program (reference framework.py:2660).

    `_uid` (process-unique) and `_version` (bumped by every op insert or
    removal) identify what the Executor caches for it."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._parameters: Dict[str, Variable] = {}
        self._version = 0
        self._uid = next(_program_uid_counter)
        self._seed = None

    # --- structure ---------------------------------------------------------
    @property
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        if parent_idx is None:
            parent_idx = self.current_block_idx
        blk = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def all_parameters(self) -> List[Variable]:
        return list(self._parameters.values())

    def list_vars(self):
        """Every var of every block, block by block in declaration
        order (reference framework.py Program.list_vars)."""
        for blk in self.blocks:
            yield from blk.vars.values()

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = seed

    # --- transforms --------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        """Deep structural copy (reference Program.clone framework.py:3059).

        for_test=True switches is_test-style attrs (dropout/batch_norm) to
        inference behaviour, mirroring the reference's test-program
        cloning -- and additionally prunes backward/optimize-role ops, so
        cloning AFTER minimize() still yields a pure eval program (the
        reference requires cloning before append_backward).
        """
        p = Program()
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            p.blocks.append(nb)
        for blk, nb in zip(self.blocks, p.blocks):
            for name, var in blk.vars.items():
                nv = copy.copy(var)
                nv.block = nb
                nb.vars[name] = nv
            for op in blk.ops:
                if for_test and op.attrs.get("op_role") in (
                        "backward", "optimize", "lr_sched"):
                    continue
                attrs = dict(op.attrs)
                if for_test and "is_test" in attrs:
                    attrs["is_test"] = True
                for k, v in attrs.items():
                    if isinstance(v, Block):
                        attrs[k] = p.blocks[v.idx]
                nop = Operator(nb, op.type, op.inputs, op.outputs,
                               attrs)
                nop._uid = op._uid  # sampling ops seed from the uid
                nb.ops.append(nop)
        p._parameters = {n: p.global_block.vars[n]
                         for n in self._parameters if n in p.global_block.vars}
        p.current_block_idx = 0
        p._seed = self._seed
        p._version = self._version
        return p

    def _prune(self, targets: Sequence[str]) -> "Program":
        """Keep only the global block's ops that the target vars need,
        and the vars those ops name (reference Program._prune, which
        save_inference_model calls, io.py:865)."""
        p = self.clone()
        blk = p.global_block
        needed = set(targets)
        kept = []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed:
                kept.append(op)
                needed.update(op.input_arg_names)
        blk.ops = list(reversed(kept))
        used = set()
        for op in blk.ops:
            used.update(op.input_arg_names)
            used.update(op.output_arg_names)
        blk.vars = {n: v for n, v in blk.vars.items() if n in used}
        p._parameters = {n: v for n, v in p._parameters.items()
                         if n in blk.vars}
        return p

    def fingerprint(self) -> str:
        """Process-stable content hash of the program: op descs and
        attrs, op uids (sampling ops salt their draws with them) and var
        metadata, through ``to_dict`` (``Program.fingerprint`` in the JAX
        package, whose digest it equals for the same program). Cached per
        `_version`: a pass bumps it."""
        cached = getattr(self, "_fingerprint_cache", None)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        digest = canonical_digest(self.to_dict())
        self._fingerprint_cache = (self._version, digest)
        return digest

    # --- serialization -----------------------------------------------------
    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks],
                "parameters": list(self._parameters),
                "version": 1}

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            p.blocks.append(Block(p, bd["idx"], bd["parent_idx"]))
        for bd, blk in zip(d["blocks"], p.blocks):
            for vd in bd["vars"]:
                blk.vars[vd["name"]] = Variable.from_dict(blk, vd)
            for od in bd["ops"]:
                blk.ops.append(Operator.from_dict(blk, od, p))
        for name in d.get("parameters", []):
            if name in p.global_block.vars:
                p._parameters[name] = p.global_block.vars[name]
        return p

    def __repr__(self):
        nops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={nops})"


# --- default program registry (reference framework.py:3390-3458) ----------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(p: Program) -> Program:
    global _main_program
    old, _main_program = _main_program, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program
    old, _startup_program = _startup_program, p
    return old


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Program = None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
