"""Carrying parameters into and out of a Scope as numpy arrays.

The port does not reproduce the JAX package's initializer RNG. A parity
run instead initializes the JAX program, hands its parameters over by
name (every parameter of the decode program has an explicit name), and
runs both. numpy is the only format the two packages share.

The same two functions carry a training program's optimizer state (Adam
moments, beta powers, the learning-rate step counter): every
persistable of its startup program. Their names (``<param>_moment1_0``,
...) agree in both packages when each builds under a fresh
``unique_name.guard()``.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from .core.scope import Scope


def load_numpy_params(scope: Scope, params: Dict[str, np.ndarray],
                      device) -> None:
    """Set each named array as a tensor on `device` (a torch.device or
    a place) in `scope`."""
    if hasattr(device, "device"):
        device = device.device()
    for name, arr in params.items():
        t = torch.from_numpy(np.array(arr))  # a copy the scope owns
        scope._set(name, t.to(device))


def scope_to_numpy(scope: Scope, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The named scope values as host numpy arrays."""
    out = {}
    for name in names:
        v = scope._get(name)
        if v is None:
            raise KeyError(f"{name!r} has no value in the scope")
        out[name] = v.detach().cpu().numpy()
    return out
