"""Long-tail layers (counterpart of
``paddle_tpu/fluid/layers/nn_tail2.py``).  Ported so far:
``add_position_encoding``, which Transformer NMT's embeddings use, and
``sigmoid_focal_loss``, RetinaNet's classification loss."""

from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _single_out_layer

__all__ = ["add_position_encoding", "sigmoid_focal_loss"]


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    """alpha·input + beta·(the sinusoid position table) over [B, T, D]."""
    helper = LayerHelper("add_position_encoding", name=name)
    return _single_out_layer(helper, "add_position_encoding",
                             {"X": [input]}, {"alpha": alpha, "beta": beta})


def sigmoid_focal_loss(x, label, fg_num, gamma=2, alpha=0.25):
    helper = LayerHelper("sigmoid_focal_loss")
    return _single_out_layer(helper, "sigmoid_focal_loss",
                             {"X": [x], "Label": [label], "FgNum": [fg_num]},
                             {"gamma": gamma, "alpha": alpha})
