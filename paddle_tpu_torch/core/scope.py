"""Scope: name -> runtime value map.

Counterpart of ``paddle_tpu/core/scope.py`` (reference
framework/scope.h:45). Values are ``torch.Tensor``s. A value lives on
the device of the Executor that last wrote or committed it: the
Executor moves a value to its own device the first time a run reads
it, and stores the moved tensor back, so each parameter crosses the
bus once.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Optional, Tuple

import torch

_scope_uid_counter = itertools.count()


class Scope:
    """Names to tensors. A scope made with a `parent` reads a name it
    lacks from its parents, and writes a name where it is found, else in
    itself (reference scope.h)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, torch.Tensor] = {}
        self.parent = parent
        # process-unique identity for the Executor's cache keys
        self._uid = next(_scope_uid_counter)
        # (host step key, the same key as a 0-d int64 device tensor): the
        # copy that device-side draws read, advanced on the device
        self._device_key: Optional[Tuple[int, torch.Tensor]] = None

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
