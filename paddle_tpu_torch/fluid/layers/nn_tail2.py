"""Long-tail layers (counterpart of
``paddle_tpu/fluid/layers/nn_tail2.py``).  Ported so far:
``add_position_encoding``, which Transformer NMT's embeddings use."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _single_out_layer

__all__ = ["add_position_encoding"]


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """alpha·input + beta·(the sinusoid position table) over [B, T, D]."""
    helper = LayerHelper("add_position_encoding", name=name)
    return _single_out_layer(helper, "add_position_encoding",
                             {"X": [input]}, {"alpha": alpha, "beta": beta})
