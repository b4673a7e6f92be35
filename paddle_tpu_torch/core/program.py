"""Program representation: the program-as-data surface.

The port's own copy of ``paddle_tpu/core/program.py`` (reference
framework.proto ProgramDesc/BlockDesc/OpDesc/VarDesc and
python/paddle/fluid/framework.py:327,877,1339,2660). The structure is
the same, so the two packages build identical programs; here the
Executor interprets a Block op by op over torch tensors, as the
reference Fluid executor does (framework/executor.cc:377).
"""
from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Dict, List, Optional

import numpy as np

from .types import VarType, as_datatype

GRAD_SUFFIX = "@GRAD"


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

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype.value if self.dtype else None}, "
                f"persistable={self.persistable})")

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
