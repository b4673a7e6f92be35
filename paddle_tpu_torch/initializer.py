"""Parameter initializers (reference python/paddle/fluid/initializer.py;
the port's copy of the subset of paddle_tpu/initializer.py that its
models use).

Each initializer appends an op to the startup program. Random ones
emit ``uniform_random`` or ``gaussian_random``, which draw from a seeded
``torch.Generator`` (see ``OpContext.generator``).
"""
from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant", outputs={"Out": var.name},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random", outputs={"Out": var.name},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random", outputs={"Out": var.name},
            attrs={"shape": list(var.shape), "dtype": var.dtype.value,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 2:
        fan_in, fan_out = shape[0], shape[1]
    elif len(shape) > 2:
        recept = int(np.prod(shape[2:]))
        fan_in = shape[1] * recept
        fan_out = shape[0] * recept
    else:
        fan_in = fan_out = int(np.prod(shape))
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (reference initializer.py XavierInitializer): uniform
    within sqrt(6 / (fan_in + fan_out)), or normal of std
    sqrt(2 / (fan_in + fan_out))."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            "assign_value", outputs={"Out": var.name},
            attrs={"shape": list(self.value.shape),
                   "dtype": var.dtype.value,
                   "values": self.value})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
