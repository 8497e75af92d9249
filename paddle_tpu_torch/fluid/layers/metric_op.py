"""Metric layers (counterpart of ``paddle_tpu/fluid/layers/metric_op.py``):
``auc``, ``edit_distance`` and ``warpctc`` over the ops of
``ops/metric_ops.py``.  ``accuracy`` is in ``nn.py``."""

from __future__ import annotations

from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["auc", "edit_distance", "warpctc"]


def auc(input, label, curve="ROC", num_thresholds=4095, name=None):
    """Streaming AUC: persistable int64 ``stat_pos``/``stat_neg``
    histograms, zeroed by the startup program, which the op updates in
    place every run.  Returns (auc_value, [stat_pos, stat_neg])."""
    helper = LayerHelper("auc", name=name)
    stat_pos = helper.create_or_get_global_variable(
        name=helper.name + "_stat_pos", shape=[num_thresholds + 1],
        dtype="int64", persistable=True)
    stat_neg = helper.create_or_get_global_variable(
        name=helper.name + "_stat_neg", shape=[num_thresholds + 1],
        dtype="int64", persistable=True)
    for v in (stat_pos, stat_neg):
        helper.set_variable_initializer(v, Constant(0))
    auc_out = helper.create_variable_for_type_inference(dtype="float32",
                                                        stop_gradient=True)
    helper.append_op(
        "auc",
        inputs={"Predict": [input], "Label": [label],
                "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                 "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    return auc_out, [stat_pos, stat_neg]


def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance a row: input [B, T_hyp] and label [B, T_ref]
    int sequences with optional lengths.  Returns (distance [B, 1],
    sequence_num)."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32",
                                                    stop_gradient=True)
    seq_num = helper.create_variable_for_type_inference(dtype="int64",
                                                        stop_gradient=True)
    inputs = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        inputs["HypsLength"] = [input_length]
    if label_length is not None:
        inputs["RefsLength"] = [label_length]
    helper.append_op("edit_distance", inputs=inputs,
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None, name=None):
    """CTC loss over input [B, T, C] raw logits and label [B, L] padded
    with ``blank``.  Returns the loss [B, 1]."""
    helper = LayerHelper("warpctc", name=name)
    loss = helper.create_variable_for_type_inference(dtype=input.dtype)
    grad = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                     stop_gradient=True)
    inputs = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        inputs["LogitsLength"] = [input_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op("warpctc", inputs=inputs,
                     outputs={"WarpCTCGrad": [grad], "Loss": [loss]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return loss
