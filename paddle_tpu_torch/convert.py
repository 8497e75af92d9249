"""Carrying weights across: numpy arrays keyed by var name into the
port's scope.

Parameter names are the same in both packages
(``gpt_word_embedding``, ``decoder_layer_{i}_att_query_fc.w_0``, ...),
so the JAX package's scope, read out as numpy, loads here by name with
no renaming table.
"""

from __future__ import annotations

import numpy as np
import torch

from .fluid.framework import resolve_place
from .fluid.registry import torch_dtype

__all__ = ["load_params"]


def load_params(scope, arrays, place, program=None):
    """Put ``arrays`` ({var name: numpy array}) into ``scope`` as tensors
    on ``place``.

    With ``program`` given, every parameter of the program must be in
    ``arrays`` with the parameter's shape and dtype; a missing or
    mismatched parameter raises ValueError naming it, and nothing is
    loaded.  Returns the sorted list of names loaded."""
    device = resolve_place(place).torch_device()
    arrays = {str(k): np.asarray(v) for k, v in arrays.items()}
    if program is not None:
        problems = []
        for p in program.all_parameters():
            a = arrays.get(p.name)
            if a is None:
                problems.append(f"{p.name}: missing")
            elif tuple(a.shape) != tuple(p.shape):
                problems.append(f"{p.name}: shape {tuple(a.shape)} != "
                                f"{tuple(p.shape)}")
            elif np.dtype(a.dtype).name != p.dtype:
                problems.append(f"{p.name}: dtype {a.dtype} != {p.dtype}")
        if problems:
            raise ValueError("load_params: parameters do not match the "
                             "program: " + "; ".join(problems))
    for name, a in arrays.items():
        # a copy: ops such as adam update the scope's tensors in place
        t = torch.from_numpy(np.ascontiguousarray(a))
        scope.set(name, t.to(device=device,
                             dtype=torch_dtype(np.dtype(a.dtype).name),
                             copy=True))
    return sorted(arrays)
