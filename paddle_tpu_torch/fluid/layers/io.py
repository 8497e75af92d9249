"""Data-input layers (counterpart of ``paddle_tpu/fluid/layers/io.py``)."""

from __future__ import annotations

from .. import framework

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         stop_gradient=True):
    """Declare a feed slot.  append_batch_size=True prepends a -1 batch
    dim; the concrete shape binds from the fed array."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            lod_level=lod_level, stop_gradient=stop_gradient,
                            is_data=True)
