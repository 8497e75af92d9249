"""AMP op lists (counterpart of
``paddle_tpu/fluid/contrib/mixed_precision/fp16_lists.py``; the
reference's python/paddle/fluid/contrib/mixed_precision/fp16_lists.py
``AutoMixedPrecisionLists``).

white: inputs always cast to the low-precision dtype (the matrix
products and convolutions, which run on the tensor cores in bf16 or
fp16).
black: numerically sensitive; forced to fp32.
gray: run in whatever dtype arrives (torch promotes a mixed pair to the
wider type, as ``jnp`` does).
"""

from __future__ import annotations

__all__ = ["AutoMixedPrecisionLists", "white_list", "black_list",
           "gray_list"]

white_list = {
    "matmul", "matmul_v2", "mul", "conv2d", "depthwise_conv2d", "conv3d",
    "conv2d_transpose",
}

black_list = {
    "exp", "log", "square", "sqrt", "rsqrt", "mean", "sum", "cos_sim",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "cross_entropy2", "softmax", "log_softmax",
    "layer_norm", "batch_norm", "group_norm", "instance_norm",
    "reduce_sum", "reduce_mean", "squared_l2_norm", "frobenius_norm",
}

gray_list = None  # everything else


class AutoMixedPrecisionLists:
    """The default lists with ``custom_white_list`` moved to white and
    ``custom_black_list`` to black; an op in both custom lists raises
    ValueError.  ``custom_black_varnames`` names vars whose downcast to
    the low-precision dtype is vetoed."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.black_varnames = set(custom_black_varnames or ())
        overlap = set(custom_white_list or ()) & set(custom_black_list or ())
        if overlap:
            raise ValueError(
                f"ops in both custom white and black lists: {overlap}")
        for op in custom_white_list or ():
            self.white_list.add(op)
            self.black_list.discard(op)
        for op in custom_black_list or ():
            self.black_list.add(op)
            self.white_list.discard(op)
