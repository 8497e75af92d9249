"""Recurrent layers: dynamic_lstm, dynamic_gru, gru_unit, lstm_unit
(counterpart of ``paddle_tpu/fluid/layers/rnn.py``).

A sequence batch is padded dense [B, T, hidden] with an optional
``length`` tensor [B] (ops/sequence_ops.py).  ``input`` is projected by
an fc first, as in the reference (dynamic_lstm: "this op does not
include x*W_x").
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru", "gru_unit", "lstm_unit"]


def _optional(inputs, **named):
    """``inputs`` with each given (not None) optional input added."""
    inputs.update({k: [v] for k, v in named.items() if v is not None})
    return inputs


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", cell_clip=0.0,
                 length=None, dtype="float32", name=None):
    """LSTM over time (the ``lstm`` op).

    input: [B, T, 4*D] pre-projected gates in chunk order {c~, i, f, o}.
    size = 4*D.  Returns (hidden [B,T,D], cell [B,T,D]).
    """
    helper = LayerHelper("dynamic_lstm", name=name)
    d = size // 4
    w = helper.create_parameter(param_attr, shape=[d, 4 * d], dtype=dtype)
    b = helper.create_parameter(bias_attr,
                                shape=[7 * d] if use_peepholes else [4 * d],
                                dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype=dtype)
    cell = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        "lstm",
        inputs=_optional({"Input": [input], "Weight": [w]}, Bias=b, H0=h_0,
                         C0=c_0, Length=length),
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "cell_clip": float(cell_clip)})
    return hidden, cell


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                length=None, dtype="float32", name=None):
    """GRU over time (the ``gru`` op).

    input: [B, T, 3*D] pre-projected {u, r, c~}; size = D.
    Returns hidden [B, T, D].
    """
    helper = LayerHelper("dynamic_gru", name=name)
    d = size
    w = helper.create_parameter(param_attr, shape=[d, 3 * d], dtype=dtype)
    b = helper.create_parameter(bias_attr, shape=[3 * d], dtype=dtype,
                                is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        "gru",
        inputs=_optional({"Input": [input], "Weight": [w]}, Bias=b, H0=h_0,
                         Length=length),
        outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse, "origin_mode": origin_mode,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid",
             origin_mode=False, name=None):
    """One GRU step (the ``gru_unit`` op).

    input: [B, 3*D] pre-projected; hidden: [B, D]; size = 3*D (the
    reference's convention).  Returns (new_hidden, reset_hidden_prev,
    gate).
    """
    helper = LayerHelper("gru_unit", name=name)
    d = size // 3
    dtype = input.dtype
    w = helper.create_parameter(param_attr, shape=[d, 3 * d], dtype=dtype)
    b = helper.create_parameter(bias_attr, shape=[3 * d], dtype=dtype,
                                is_bias=True)
    gate = helper.create_variable_for_type_inference(dtype=dtype)
    reset_h = helper.create_variable_for_type_inference(dtype=dtype)
    new_h = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        "gru_unit",
        inputs=_optional({"Input": [input], "HiddenPrev": [hidden],
                          "Weight": [w]}, Bias=b),
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_h],
                 "Hidden": [new_h]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return new_h, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: an fc over [x_t, h_prev] makes the 4*D gates
    {i, f, o, j}, then the ``lstm_unit`` op.  Returns (hidden, cell)."""
    from . import nn

    helper = LayerHelper("lstm_unit", name=name)
    d = cell_t_prev.shape[-1]
    concat = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    helper.append_op("concat", inputs={"X": [x_t, hidden_t_prev]},
                     outputs={"Out": [concat]}, attrs={"axis": -1})
    gates = nn.fc(concat, size=4 * d, param_attr=param_attr,
                  bias_attr=bias_attr)
    cell = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    hidden = helper.create_variable_for_type_inference(dtype=x_t.dtype)
    helper.append_op("lstm_unit",
                     inputs={"X": [gates], "C_prev": [cell_t_prev]},
                     outputs={"C": [cell], "H": [hidden]},
                     attrs={"forget_bias": float(forget_bias)})
    return hidden, cell
