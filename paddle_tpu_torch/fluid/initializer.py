"""Initializers append init ops to the startup program (counterpart of
``paddle_tpu/fluid/initializer.py``).

They emit ``fill_constant``, ``uniform_random``, ``gaussian_random`` and
``assign_value`` (:class:`NumpyArrayInitializer`);
the startup run executes them on the executor's device, drawing from a
``torch.Generator`` seeded from the program's ``random_seed``
(ops/tensor_ops.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Initializer", "Constant", "Uniform", "Normal", "Xavier",
           "ConstantInitializer", "UniformInitializer",
           "NormalInitializer", "XavierInitializer",
           "NumpyArrayInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            "fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            "uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            "gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": float(self.loc), "std": float(self.scale),
                   "seed": self.seed})


class NumpyArrayInitializer(Initializer):
    """The array's values as an ``assign_value`` op: ``fp32_values`` for
    a float array, ``int64_values`` for int64, else ``int32_values``."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        v = self.value
        flat = v.reshape(-1)
        if v.dtype in (np.float32, np.float64, np.float16):
            attr = {"fp32_values": [float(x) for x in flat]}
        elif v.dtype == np.int64:
            attr = {"int64_values": [int(x) for x in flat]}
        else:
            attr = {"int32_values": [int(x) for x in flat]}
        return block.append_op(
            "assign_value", outputs={"Out": var},
            attrs={"shape": list(v.shape), "dtype": var.dtype, **attr})


def _fans(var):
    """fc weight is [in, out]; conv kernel is [out_c, in_c, *receptive]."""
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1), (shape[0] if shape else 1)
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """Glorot uniform/normal."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (
            uniform, fan_in, fan_out, seed)

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
