"""Scope: name -> runtime value map.

Counterpart of ``paddle_tpu/core/scope.py`` (reference
framework/scope.h:45), with its Fluid-facing API: ``var``, ``find_var``
(``global_scope().find_var(n).get_tensor()``), ``new_scope``,
``drop_kids``, ``local_var_names``, ``has`` and ``erase``. Values are
``torch.Tensor``s. A value lives on
the device of the Executor that last wrote or committed it: the
Executor moves a value to its own device the first time a run reads
it, and stores the moved tensor back, so each parameter crosses the
bus once.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_scope_uid_counter = itertools.count()


class TensorValue:
    """fluid LoDTensor-handle parity: ``scope.find_var(x).get_tensor()``.
    ``set`` takes numpy or torch and stores a tensor; ``np.asarray`` of
    the handle gives numpy (a bf16 value widened to float32)."""

    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def value(self) -> Optional[torch.Tensor]:
        return self._scope._get(self._name)

    def set(self, array, place=None):
        t = array if isinstance(array, torch.Tensor) \
            else torch.as_tensor(np.asarray(array))
        if place is not None:
            t = t.to(place.device())
        self._scope._set(self._name, t)

    def set_lod(self, lod):
        self._scope._lods[self._name] = lod

    def lod(self):
        return self._scope._lods.get(self._name, [])

    def shape(self):
        v = self.value()
        return list(v.shape) if v is not None else None

    def __array__(self, dtype=None, copy=None):
        v = self.value()
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            arr = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            arr = np.asarray(v)
        return arr.astype(dtype) if dtype is not None else arr


class ScopeVar:
    def __init__(self, scope, name):
        self._scope = scope
        self.name = name

    def get_tensor(self) -> TensorValue:
        return TensorValue(self._scope, self.name)


class Scope:
    """Names to tensors. A scope made with a `parent` reads a name it
    lacks from its parents, and writes a name where it is found, else in
    itself (reference scope.h)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Optional[torch.Tensor]] = {}
        self._lods: Dict[str, list] = {}
        self.parent = parent
        self._kids = []
        # process-unique identity for the Executor's cache keys
        self._uid = next(_scope_uid_counter)
        # (host step key, the same key as a 0-d int64 device tensor): the
        # copy that device-side draws read, advanced on the device
        self._device_key: Optional[Tuple[int, torch.Tensor]] = None

    # --- fluid-style interface --------------------------------------------
    def var(self, name) -> ScopeVar:
        """The var `name` of this scope, made (holding no value) if it is
        not here."""
        if name not in self._vars:
            self._vars[name] = None
        return ScopeVar(self, name)

    def find_var(self, name) -> Optional[ScopeVar]:
        s = self
        while s is not None:
            if name in s._vars:
                return ScopeVar(s, name)
            s = s.parent
        return None

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    def local_var_names(self):
        return list(self._vars)

    def has(self, name) -> bool:
        """Whether `name` holds a value here or in a parent."""
        s = self
        while s is not None:
            if name in s._vars and s._vars[name] is not None:
                return True
            s = s.parent
        return False

    def erase(self, name):
        self._vars.pop(name, None)
        self._lods.pop(name, None)

    # --- raw access used by the executor ----------------------------------
    def _get(self, name) -> Optional[torch.Tensor]:
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def _set(self, name, value: torch.Tensor):
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value


_global_scope = [Scope()]


def global_scope() -> Scope:
    return _global_scope[0]


def _reset_global_scope() -> Scope:
    _global_scope[0] = Scope()
    return _global_scope[0]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    """Make `scope` the global scope inside the block (fluid
    executor.py scope_guard)."""
    old = _global_scope[0]
    _global_scope[0] = scope
    try:
        yield
    finally:
        _global_scope[0] = old
