"""Layer functions the decode serving lane, BERT and GPT training, the
image models, Transformer NMT and the book programs build with
(counterpart of ``paddle_tpu/fluid/layers/nn.py``).  Each appends ops
to the default main program through LayerHelper; nothing touches a
device until the executor runs the block.  Op types, slots and attrs
are those of the JAX package, so both packages build the same
program."""

from __future__ import annotations

import numpy as np

from ..framework import convert_np_dtype_to_dtype_
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc", "embedding", "layer_norm", "log_softmax", "matmul",
    "elementwise_add", "reshape", "transpose", "gather", "argmax", "cast",
    "paged_attention", "kv_cache_write", "kv_cache_write_pages",
    "softmax", "dropout", "scale", "slice", "flash_attention",
    "softmax_with_cross_entropy", "mean", "accuracy", "reduce_mean",
    "ragged_attention", "paged_attention_quant", "kv_cache_write_quant",
    "kv_cache_write_pages_quant", "cross_entropy",
    "softmax_mask_fuse_upper_triangle", "elementwise_sub",
    "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow", "elementwise_mod",
    "elementwise_floordiv", "sqrt", "sign", "clip", "clip_by_norm",
    "conv2d", "conv3d", "conv2d_transpose", "pool2d", "adaptive_pool2d",
    "batch_norm", "square_error_cost", "relu", "sigmoid", "tanh", "square",
    "flatten", "concat", "reduce_sum", "equal", "expand_as",
    "expand", "squeeze", "unsqueeze", "l2_normalize", "cos_sim",
    "sequence_conv", "sequence_pool", "sequence_softmax", "sequence_expand",
    "sequence_reverse", "sequence_first_step", "sequence_last_step",
    "sequence_mask", "sequence_unpad", "sequence_concat",
    "sequence_expand_as", "sequence_slice", "sequence_enumerate",
    "not_equal", "less_than", "less_equal", "greater_than", "greater_equal",
    "logical_and", "logical_or", "logical_xor", "logical_not", "exp", "log",
    "pow", "floor", "ceil", "cos", "stack", "unstack", "one_hot",
    "moe_ffn", "mul", "split", "chunk_eval", "leaky_relu", "image_resize",
    "resize_bilinear", "resize_nearest",
]


def _single_out_layer(helper, op_type, inputs, attrs=None, dtype=None,
                      out=None):
    if out is None:
        out = helper.create_variable_for_type_inference(
            dtype=dtype or next(iter(inputs.values()))[0].dtype)
    helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs or {})
    return out


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected: mul (one a input, then their sum) +
    elementwise_add + activation."""
    helper = LayerHelper("fc", input=input, size=size, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = ParamAttr._to_attr(param_attr)
    if not isinstance(param_attrs, list):
        param_attrs = [param_attrs] * len(inputs)
    mul_results = []
    for inp, pa in zip(inputs, param_attrs):
        w_shape = [int(np.prod(inp.shape[num_flatten_dims:])), size]
        w = helper.create_parameter(pa, shape=w_shape, dtype=inp.dtype)
        out = helper.create_variable_for_type_inference(dtype=inp.dtype)
        helper.append_op("mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [out]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:  # several inputs: one product each, summed
        pre_bias = helper.create_variable_for_type_inference(
            dtype=inputs[0].dtype)
        helper.append_op("sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup_table over a [vocab, width] parameter."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    pad = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op("lookup_table", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": pad, "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", act=act, name=name)
    dtype = input.dtype
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, shape=norm_shape, dtype=dtype,
            default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, shape=norm_shape, dtype=dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype)
    mean = helper.create_variable_for_type_inference(dtype,
                                                     stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean],
                              "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    return _single_out_layer(helper, "log_softmax", {"X": [input]},
                             {"axis": axis})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0,
           name=None):
    helper = LayerHelper("matmul", name=name)
    return _single_out_layer(helper, "matmul", {"X": [x], "Y": [y]},
                             {"transpose_X": transpose_x,
                              "transpose_Y": transpose_y,
                              "alpha": float(alpha)})


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, act=act, name=name)
    out = _single_out_layer(helper, op_type, {"X": [x], "Y": [y]},
                            {"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mod", x, y, axis, act, name)


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_floordiv", x, y, axis, act, name)


def _act_layer(op_type, x, attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    return _single_out_layer(helper, op_type, {"X": [x]}, attrs or {})


def sqrt(x, name=None):
    return _act_layer("sqrt", x, name=name)


def relu(x, name=None):
    return _act_layer("relu", x, name=name)


def sigmoid(x, name=None):
    return _act_layer("sigmoid", x, name=name)


def tanh(x, name=None):
    return _act_layer("tanh", x, name=name)


def square(x, name=None):
    return _act_layer("square", x, name=name)


def leaky_relu(x, alpha=0.02, name=None):
    return _act_layer("leaky_relu", x, {"alpha": alpha}, name)


def sign(x, name=None):
    return _act_layer("sign", x, name=name)


def clip(x, min, max, name=None):
    return _act_layer("clip", x, {"min": float(min), "max": float(max)},
                      name)


def clip_by_norm(x, max_norm, name=None):
    return _act_layer("clip_by_norm", x, {"max_norm": float(max_norm)},
                      name)


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True, align_mode=1):
    """bilinear_interp or nearest_interp to ``out_shape`` (or the input's
    size times ``scale``); align_corners defaults to true, as in the
    reference."""
    op = ("bilinear_interp" if resample.upper() == "BILINEAR"
          else "nearest_interp")
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    helper = LayerHelper(op, name=name)
    return _single_out_layer(helper, op, {"X": [input]},
                             {"out_h": out_shape[0], "out_w": out_shape[1],
                              "align_corners": bool(align_corners),
                              "align_mode": int(align_mode)})


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True, align_mode=1, **kw):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners=align_corners, align_mode=align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True, **kw):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners=align_corners)


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op("transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    return _single_out_layer(helper, "gather",
                             {"X": [input], "Index": [index]})


def argmax(x, axis=0, name=None):
    helper = LayerHelper("arg_max", name=name)
    return _single_out_layer(helper, "arg_max", {"X": [x]}, {"axis": axis},
                             dtype="int64")


def cast(x, dtype):
    helper = LayerHelper("cast")
    dt = convert_np_dtype_to_dtype_(dtype)
    return _single_out_layer(helper, "cast", {"X": [x]}, {"out_dtype": dt},
                             dtype=dt)


def paged_attention(q, k_pages, v_pages, page_table, q_start,
                    sm_scale=None, force=None, name=None):
    """Attention of q [B, n_heads, T, d] against pool K/V read through a
    per-sequence page table (kernels/primitives/paged.py).  Query i of
    row b attends global key positions j <= q_start[b] + i."""
    helper = LayerHelper("paged_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    if force is not None:
        attrs["force"] = force
    helper.append_op("paged_attention",
                     inputs={"Q": [q], "KPages": [k_pages],
                             "VPages": [v_pages], "PageTable": [page_table],
                             "QStart": [q_start]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def kv_cache_write(pages, new, page_idx, offset, name=None):
    """Scatter one decode step's K or V rows (new [B, n, d]) into the
    pool at per-slot (page_idx[b], offset[b]); returns the pool var,
    which the op updates in place."""
    helper = LayerHelper("kv_cache_write", name=name)
    helper.append_op("kv_cache_write",
                     inputs={"Pages": [pages], "New": [new],
                             "PageIdx": [page_idx], "Offset": [offset]},
                     outputs={"PagesOut": [pages]})
    return pages


def kv_cache_write_pages(pages, new, page_idx, name=None):
    """Scatter a prefill chunk's K or V (new [C, n, d], C a multiple of
    the page size) into whole pool pages page_idx [C/page_size]."""
    helper = LayerHelper("kv_cache_write_pages", name=name)
    helper.append_op("kv_cache_write_pages",
                     inputs={"Pages": [pages], "New": [new],
                             "PageIdx": [page_idx]},
                     outputs={"PagesOut": [pages]})
    return pages


def ragged_attention(q, k, v, lengths, causal=False, sm_scale=None,
                     force=None, name=None):
    """Variable-length attention over [B, n_heads, S, d] driven by a
    per-row length vector (kernels/primitives/ragged.py, K6): row b
    attends key positions j < lengths[b] (and j <= i when causal), so
    one fixed S serves every mixed-length batch.  Inference-only."""
    helper = LayerHelper("ragged_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {"causal": causal}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    if force is not None:
        attrs["force"] = force
    helper.append_op("ragged_attention",
                     inputs={"Q": [q], "K": [k], "V": [v],
                             "Lengths": [lengths]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def paged_attention_quant(q, k_hi, k_lo, k_scale, v_hi, v_lo, v_scale,
                          page_table, q_start, sm_scale=None, force=None,
                          name=None):
    """paged_attention over the dual-int8 pool (hi/lo int8 + per-vector
    fp32 scale): the kernel (K7) dequantises in registers."""
    helper = LayerHelper("paged_attention_quant", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    attrs = {}
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    if force is not None:
        attrs["force"] = force
    helper.append_op("paged_attention_quant",
                     inputs={"Q": [q], "KHi": [k_hi], "KLo": [k_lo],
                             "KScale": [k_scale], "VHi": [v_hi],
                             "VLo": [v_lo], "VScale": [v_scale],
                             "PageTable": [page_table],
                             "QStart": [q_start]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def kv_cache_write_quant(hi, lo, scale, new, page_idx, offset, name=None):
    """kv_cache_write for the int8 pool: quantize one decode step's K or
    V rows (new [B, n, d]) and write hi/lo/scale at per-slot
    (page_idx[b], offset[b]); returns the pool vars, updated in place."""
    helper = LayerHelper("kv_cache_write_quant", name=name)
    helper.append_op("kv_cache_write_quant",
                     inputs={"Hi": [hi], "Lo": [lo], "Scale": [scale],
                             "New": [new], "PageIdx": [page_idx],
                             "Offset": [offset]},
                     outputs={"HiOut": [hi], "LoOut": [lo],
                              "ScaleOut": [scale]})
    return hi, lo, scale


def kv_cache_write_pages_quant(hi, lo, scale, new, page_idx, name=None):
    """kv_cache_write_pages for the int8 pool: quantize a prefill
    chunk's K or V (new [C, n, d]) and write whole pages of
    hi/lo/scale; returns the pool vars, updated in place."""
    helper = LayerHelper("kv_cache_write_pages_quant", name=name)
    helper.append_op("kv_cache_write_pages_quant",
                     inputs={"Hi": [hi], "Lo": [lo], "Scale": [scale],
                             "New": [new], "PageIdx": [page_idx]},
                     outputs={"HiOut": [hi], "LoOut": [lo],
                              "ScaleOut": [scale]})
    return hi, lo, scale


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    return _single_out_layer(helper, "softmax", {"X": [input]},
                             {"axis": axis})


def softmax_mask_fuse_upper_triangle(x, name=None):
    """Causal softmax of [..., S, S] scores: the positions above the
    diagonal (the future) are masked before the softmax."""
    helper = LayerHelper("softmax_mask_fuse_upper_triangle", name=name)
    return _single_out_layer(helper, "softmax_mask_fuse_upper_triangle",
                             {"X": [x]})


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Dropout with a saved uint8 Mask, which its grad op replays."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8",
                                                     stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0,
                            "dropout_implementation":
                                dropout_implementation})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = _single_out_layer(helper, "scale", {"X": [x]},
                            {"scale": float(scale), "bias": float(bias),
                             "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    return _single_out_layer(helper, "slice", {"Input": [input]},
                             {"axes": list(axes), "starts": list(starts),
                              "ends": list(ends), "decrease_axis": []})


def flash_attention(q, k, v, attn_bias=None, causal=False, sm_scale=None,
                    sequence_parallel=False, name=None):
    """Attention over [B, n_heads, S, d] without an S x S score tensor
    in memory (kernels/primitives/flash.py: K1 forward, K2/K3 backward).
    attn_bias: additive [B, 1, 1, S] key bias (the padding mask)."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        inputs["Bias"] = [attn_bias]
    attrs = {"causal": causal}
    if sequence_parallel:
        attrs["sequence_parallel"] = True
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    helper.append_op("flash_attention", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def moe_ffn(x, num_experts, d_ff, top_k=2, act="gelu", param_attr=None,
            name=None):
    """Mixture-of-experts feed-forward over [B, S, D] (ops/nn_ops.py
    ``moe_ffn``: top-k gating, dense dispatch).  Parameters
    ``<name>_moe_gate.w_0`` [D, E], ``_moe_w1.w_0`` [E, D, d_ff],
    ``_moe_w1.b_0`` [E, d_ff], ``_moe_w2.w_0`` [E, d_ff, D] and
    ``_moe_w2.b_0`` [E, D]; the weights drawn from ``param_attr``'s
    initializer (Normal(0, 0.02) by default), the biases 0."""
    helper = LayerHelper("moe_ffn", name=name)
    d = x.shape[-1]
    pname = name or helper.name
    init = (param_attr.initializer
            if param_attr is not None and param_attr.initializer else
            Normal(0.0, 0.02))
    gate = helper.create_parameter(
        ParamAttr(name=pname + "_moe_gate.w_0", initializer=init),
        shape=[d, num_experts])
    w1 = helper.create_parameter(
        ParamAttr(name=pname + "_moe_w1.w_0", initializer=init),
        shape=[num_experts, d, d_ff])
    b1 = helper.create_parameter(
        ParamAttr(name=pname + "_moe_w1.b_0", initializer=Constant(0.0)),
        shape=[num_experts, d_ff], is_bias=True)
    w2 = helper.create_parameter(
        ParamAttr(name=pname + "_moe_w2.w_0", initializer=init),
        shape=[num_experts, d_ff, d])
    b2 = helper.create_parameter(
        ParamAttr(name=pname + "_moe_w2.b_0", initializer=Constant(0.0)),
        shape=[num_experts, d], is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("moe_ffn",
                     inputs={"X": [x], "GateW": [gate], "W1": [w1],
                             "B1": [b1], "W2": [w2], "B2": [b2]},
                     outputs={"Out": [out]},
                     attrs={"top_k": int(top_k), "act": act})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    """Cross entropy of probabilities ``input`` against hard (int64
    [.., 1]) or soft labels; returns [.., 1]."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cross_entropy", inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    sm = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [sm], "Loss": [loss]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, sm
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    return _single_out_layer(helper, "mean", {"X": [x]})


def _reduce_layer(op_type, input, dim=None, keep_dim=False, name=None):
    """A reduction over ``dim`` (every dim when None)."""
    helper = LayerHelper(op_type, name=name)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        d = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(d), "keep_dim": keep_dim, "reduce_all": False}
    return _single_out_layer(helper, op_type, {"X": [input]}, attrs)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def _cmp_layer(op_type, x, y, name=None, out=None):
    helper = LayerHelper(op_type, name=name)
    return _single_out_layer(helper, op_type, {"X": [x], "Y": [y]},
                             dtype="bool", out=out)


def equal(x, y, cond=None):
    return _cmp_layer("equal", x, y, out=cond)


def not_equal(x, y, cond=None):
    return _cmp_layer("not_equal", x, y, out=cond)


def less_than(x, y, cond=None, force_cpu=None):
    """x < y; ``cond`` names an existing bool var to write (a While's
    condition, computed again at the end of its body)."""
    return _cmp_layer("less_than", x, y, out=cond)


def less_equal(x, y, cond=None):
    return _cmp_layer("less_equal", x, y, out=cond)


def greater_than(x, y, cond=None):
    return _cmp_layer("greater_than", x, y, out=cond)


def greater_equal(x, y, cond=None):
    return _cmp_layer("greater_equal", x, y, out=cond)


def logical_and(x, y, out=None, name=None):
    return _cmp_layer("logical_and", x, y, out=out)


def logical_or(x, y, out=None, name=None):
    return _cmp_layer("logical_or", x, y, out=out)


def logical_xor(x, y, out=None, name=None):
    return _cmp_layer("logical_xor", x, y, out=out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    return _single_out_layer(helper, "logical_not", {"X": [x]},
                             dtype="bool", out=out)


def exp(x, name=None):
    return _act_layer("exp", x, name=name)


def log(x, name=None):
    return _act_layer("log", x, name=name)


def pow(x, factor=1.0, name=None):
    return _act_layer("pow", x, {"factor": factor}, name)


def floor(x, name=None):
    return _act_layer("floor", x, name=name)


def ceil(x, name=None):
    return _act_layer("ceil", x, name=name)


def cos(x, name=None):
    return _act_layer("cos", x, name=name)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op("stack", inputs={"X": list(x)}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    n = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(n)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": n})
    return outs


def one_hot(input, depth, allow_out_of_range=False):
    """fp32 one-hot rows [..., depth]; a trailing dim of 1 on ``input``
    is squeezed first, and an id outside [0, depth) gives a zero row."""
    helper = LayerHelper("one_hot")
    return _single_out_layer(helper, "one_hot", {"X": [input]},
                             {"depth": depth}, dtype="float32")


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    return _single_out_layer(helper, "expand_as",
                             {"X": [x], "target_tensor": [target_tensor]})


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy: ``top_k`` then ``accuracy``."""
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    topk_idx = helper.create_variable_for_type_inference(
        "int64", stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [topk_out], "Indices": [topk_idx]},
                     attrs={"k": k})
    acc = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Out": [topk_out], "Indices": [topk_idx],
                             "Label": [label]},
                     outputs={"Accuracy": [acc], "Correct": [correct],
                              "Total": [total]})
    return acc


def _elementwise_binary_var(x, y, op_type):
    """``Variable``'s operators (the JAX package's math_op_patch
    subset): with a Python number on either side, the ``scale`` op the
    JAX package emits (n·1 + v, v·n, n − v, v − n, v·(1/n)) where one
    does, else a [1] ``fill_constant`` of the number and the
    elementwise op."""
    from . import tensor as _t

    if isinstance(x, (int, float)):
        if op_type == "elementwise_add":
            return scale(y, 1.0, float(x))
        if op_type == "elementwise_mul":
            return scale(y, float(x))
        if op_type == "elementwise_sub":
            return scale(y, -1.0, float(x))
        x = _t.fill_constant(shape=[1], dtype=y.dtype, value=float(x))
    if isinstance(y, (int, float)):
        if op_type == "elementwise_add":
            return scale(x, 1.0, float(y))
        if op_type == "elementwise_mul":
            return scale(x, float(y))
        if op_type == "elementwise_sub":
            return scale(x, 1.0, -float(y))
        if op_type == "elementwise_div":
            return scale(x, 1.0 / float(y))
        y = _t.fill_constant(shape=[1], dtype=x.dtype, value=float(y))
    return _elementwise(op_type, x, y)


# ---------------------------------------------------------------------------
# convolution, pooling, batch norm (the image models)
# ---------------------------------------------------------------------------


def _pair(v, n=2):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _conv_bias(helper, conv_out, bias_attr, num_filters, dtype):
    """The conv's bias as an ``elementwise_add`` at axis 1."""
    if bias_attr is False:
        return conv_out
    b = helper.create_parameter(ParamAttr._to_attr(bias_attr),
                                shape=[num_filters], dtype=dtype,
                                is_bias=True)
    if b is None:
        return conv_out
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op("elementwise_add", inputs={"X": [conv_out], "Y": [b]},
                     outputs={"Out": [out]}, attrs={"axis": 1})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """A fully grouped conv declined cuDNN (``use_cudnn=False``) emits
    ``depthwise_conv2d``, as era MobileNet code relies on; the filter's
    default initializer is Normal(0, sqrt(2 / fan_in))."""
    helper = LayerHelper("conv2d", input=input, size=num_filters,
                         bias_attr=bias_attr, act=act, name=name)
    chans = input.shape[1]
    op_type = ("depthwise_conv2d"
               if chans == groups and num_filters % max(chans, 1) == 0
               and not use_cudnn else "conv2d")
    fs = _pair(filter_size)
    fan_in = (chans // groups) * fs[0] * fs[1]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, chans // groups] + fs,
        dtype=input.dtype,
        default_initializer=Normal(0.0, float((2.0 / fan_in) ** 0.5)))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(op_type, inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups,
                            "data_format": data_format})
    return helper.append_activation(
        _conv_bias(helper, out, bias_attr, num_filters, input.dtype))


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None,
           **kw):
    helper = LayerHelper("conv3d", input=input, size=num_filters,
                         bias_attr=bias_attr, act=act, name=name)
    chans = input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, chans // groups]
        + _pair(filter_size, 3), dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("conv3d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _pair(stride, 3),
                            "paddings": _pair(padding, 3),
                            "dilations": _pair(dilation, 3),
                            "groups": groups})
    return helper.append_activation(
        _conv_bias(helper, out, bias_attr, num_filters, input.dtype))


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None, name=None,
                     **kw):
    """The filter is laid out (in, out/groups, kh, kw)."""
    helper = LayerHelper("conv2d_transpose", input=input, size=num_filters,
                         bias_attr=bias_attr, act=act, name=name)
    chans = input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[chans, num_filters // groups]
        + _pair(filter_size), dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("conv2d_transpose",
                     inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups})
    return helper.append_activation(
        _conv_bias(helper, out, bias_attr, num_filters, input.dtype))


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True, adaptive=False,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type,
                            "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive,
                            "adaptive": adaptive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    return pool2d(input, pool_size=pool_size, pool_type=pool_type,
                  adaptive=True, name=name)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """Scale (Constant(1)) and Bias parameters; the moving mean and
    variance are persistable globals (Constant(0) and Constant(1)),
    which the op updates in place."""
    helper = LayerHelper("batch_norm", act=act, name=name)
    dtype = input.dtype
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale_p = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                      default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype,
                                   is_bias=True)
    mean = helper.create_or_get_global_variable(
        moving_mean_name or f"{helper.name}.mean", shape=[c], dtype=dtype,
        persistable=True, stop_gradient=True)
    var = helper.create_or_get_global_variable(
        moving_variance_name or f"{helper.name}.var", shape=[c],
        dtype=dtype, persistable=True, stop_gradient=True)
    helper.set_variable_initializer(mean, Constant(0.0))
    helper.set_variable_initializer(var, Constant(1.0))
    saved_mean = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale_p], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(out)


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    return _single_out_layer(helper, "square_error_cost",
                             {"X": [input], "Y": [label]})


def flatten(x, axis=1, name=None):
    return _with_xshape("flatten2", x, {"axis": axis}, name)


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    return _single_out_layer(helper, "concat", {"X": list(input)},
                             {"axis": axis})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """The ``mul`` op: x and y flattened to 2-D at their col dims, then
    one product."""
    helper = LayerHelper("mul", name=name)
    return _single_out_layer(helper, "mul", {"X": [x], "Y": [y]},
                             {"x_num_col_dims": x_num_col_dims,
                              "y_num_col_dims": y_num_col_dims})


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal parts (an int) or parts of the given
    sizes (a list) along ``dim``: one ``split`` op, a var a part."""
    helper = LayerHelper("split", name=name)
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": axis}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def chunk_eval(input, label, chunk_scheme, num_chunk_types, length=None,
               name=None):
    """Chunking precision, recall and F1 (the ``chunk_eval`` op, IOB
    scheme).  Returns (precision, recall, f1, n_infer, n_label,
    n_correct), the counts int32."""
    helper = LayerHelper("chunk_eval", name=name)
    outs = {s: helper.create_variable_for_type_inference(
        dtype="float32" if i < 3 else "int32", stop_gradient=True)
        for i, s in enumerate(["Precision", "Recall", "F1-Score",
                               "NumInferChunks", "NumLabelChunks",
                               "NumCorrectChunks"])}
    inputs = {"Inference": [input], "Label": [label]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("chunk_eval", inputs=inputs,
                     outputs={k: [v] for k, v in outs.items()},
                     attrs={"chunk_scheme": chunk_scheme,
                            "num_chunk_types": num_chunk_types})
    return tuple(outs.values())


def _with_xshape(op_type, x, attrs, name):
    """A reshaping op's ``Out``, with its ``XShape`` output beside it."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype,
                                                       stop_gradient=True)
    helper.append_op(op_type, inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _with_xshape("squeeze2", input, {"axes": list(axes)}, name)


def unsqueeze(input, axes, name=None):
    return _with_xshape("unsqueeze2", input, {"axes": list(axes)}, name)


def expand(x, expand_times, name=None):
    return _act_layer("expand", x, {"expand_times": list(expand_times)},
                      name)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype,
                                                     stop_gradient=True)
    helper.append_op("l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def cos_sim(X, Y):
    """Row-wise cosine similarity [B, 1], as the JAX package's layer
    builds it: each side L2-normalized, then their ``dot``."""
    xn = l2_normalize(X, axis=-1)
    yn = l2_normalize(Y, axis=-1)
    helper = LayerHelper("cos_sim")
    return _single_out_layer(helper, "dot", {"X": [xn], "Y": [yn]})


# ---------------------------------------------------------------------------
# sequence layers: padded dense [B, T, D] with optional lengths [B]
# (ops/sequence_ops.py)
# ---------------------------------------------------------------------------


def _seq_inputs(inputs, length):
    if length is not None:
        inputs["Length"] = [length]
    return inputs


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, bias_attr=None, param_attr=None, act=None,
                  name=None, length=None):
    if filter_stride != 1:
        raise ValueError(
            "sequence_conv supports contextStride == 1 only (same "
            "restriction as the reference sequence_conv_op.cc)")
    helper = LayerHelper("sequence_conv", act=act, name=name,
                         size=num_filters, bias_attr=bias_attr)
    d = input.shape[-1]
    w = helper.create_parameter(param_attr,
                                shape=[filter_size * d, num_filters],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("sequence_conv",
                     inputs=_seq_inputs({"X": [input], "Filter": [w]},
                                        length),
                     outputs={"Out": [out]},
                     attrs={"contextLength": filter_size,
                            "contextStart": -((filter_size - 1) // 2),
                            "contextStride": filter_stride})
    out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)


def sequence_pool(input, pool_type="average", is_test=False, length=None):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    max_index = helper.create_variable_for_type_inference(
        "int32", stop_gradient=True)
    helper.append_op("sequence_pool",
                     inputs=_seq_inputs({"X": [input]}, length),
                     outputs={"Out": [out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    helper = LayerHelper("sequence_softmax", name=name)
    return _single_out_layer(helper, "sequence_softmax",
                             _seq_inputs({"X": [input]}, length))


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    return _single_out_layer(helper, "sequence_expand",
                             {"X": [x], "Y": [y]})


def sequence_reverse(x, name=None, length=None):
    helper = LayerHelper("sequence_reverse", name=name)
    return _single_out_layer(helper, "sequence_reverse",
                             _seq_inputs({"X": [x]}, length))


def sequence_first_step(input, length=None):
    return sequence_pool(input, pool_type="first", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, pool_type="last", length=length)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    if maxlen is None:
        # the reference's maxlen=None (the max of the lengths) is a
        # data-dependent extent, which a fixed-shape program cannot hold
        raise ValueError(
            "sequence_mask requires an explicit maxlen: the reference's "
            "maxlen=None (max of the lengths) is a data-dependent shape")
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype,
                                                    stop_gradient=True)
    helper.append_op("sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]},
                     attrs={"maxlen": int(maxlen), "out_dtype": dtype})
    return out


def sequence_unpad(x, length, name=None):
    """The padding tail zeroed (the dense counterpart of
    sequence_unpad)."""
    helper = LayerHelper("sequence_unpad", name=name)
    return _single_out_layer(helper, "sequence_unpad",
                             {"X": [x], "Length": [length]})


def sequence_concat(input, lengths=None, name=None):
    """Row-wise concat of valid prefixes; ``lengths``: an optional list
    matching ``input``.  Returns (out, out_lengths) when lengths are
    given, else out."""
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    out_len = helper.create_variable_for_type_inference("int32",
                                                        stop_gradient=True)
    inputs = {"X": list(input)}
    if lengths is not None:
        inputs["Length"] = list(lengths)
    helper.append_op("sequence_concat", inputs=inputs,
                     outputs={"Out": [out], "OutLength": [out_len]})
    return (out, out_len) if lengths is not None else out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    return _single_out_layer(helper, "sequence_expand_as",
                             {"X": [x], "Y": [y]})


def sequence_slice(input, offset, length, name=None):
    """Per-row time window, left-aligned and zero-padded."""
    helper = LayerHelper("sequence_slice", name=name)
    return _single_out_layer(helper, "sequence_slice",
                             {"X": [input], "Offset": [offset],
                              "Length": [length]})


def sequence_enumerate(input, win_size, pad_value=0, length=None,
                       name=None):
    """Sliding id windows [B, T] → [B, T, win]."""
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference("int64",
                                                    stop_gradient=True)
    helper.append_op("sequence_enumerate",
                     inputs=_seq_inputs({"X": [input]}, length),
                     outputs={"Out": [out]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out
