"""Interop op lowerings: reference op types that appear in exported
programs (counterpart of ``paddle_tpu/ops/compat_ops.py``).

Ported so far: ``cos_sim`` and the aliases ``sync_batch_norm`` and
``depthwise_conv2d_transpose`` (with their ``_grad`` types).  Still to
come, the JAX module's 24 others:
``average_accumulates``, ``conv_shift``,
``fake_channel_wise_dequantize_max_abs``,
``fake_quantize_dequantize_moving_average_abs_max``, ``fill``,
``fill_zeros_like2``, ``l1_norm``, ``load``, ``load_combine``,
``lod_reset``, ``max_pool2d_with_index`` and ``max_pool3d_with_index``
(each with its grad), ``mine_hard_examples``, ``minus``,
``modified_huber_loss``, ``sampling_id``, ``save``, ``save_combine``,
``spp``, ``squared_l2_distance``, ``unfold`` and ``unpool``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.fluid.registry import (get_op, has_op, register_op,
                                             simple_op)

from . import nn_ops  # noqa: F401  (registers the aliases' base ops)


@simple_op("cos_sim", ["X", "Y"], ["Out", "XNorm", "YNorm"])
def _cos_sim(ctx, x, y, attrs):
    """Row-wise cosine similarity, 1e-12 added to the product of the two
    norms; Y may be one row, broadcast over X's rows (cos_sim_op.cc).
    Also the row norms, [B, 1] each."""
    xf = x.reshape(x.shape[0], -1)
    yf = y.reshape(y.shape[0], -1)
    xn = torch.sqrt((xf * xf).sum(dim=1, keepdim=True))
    yn = torch.sqrt((yf * yf).sum(dim=1, keepdim=True))
    dot = (xf * yf).sum(dim=1, keepdim=True)
    return dot / (xn * yn + 1e-12), xn, yn


def _register_aliases():
    """Op types whose lowering is exactly another op's.

    - depthwise_conv2d_transpose (conv_transpose_op.cc): the grouped
      conv2d_transpose lowering already handles groups == channels.
    - sync_batch_norm (sync_batch_norm_op.cu): on one device it is
      batch_norm.  The data-parallel transpile syncs the moving
      statistics of ``batch_norm`` ops only, as the JAX package's does,
      so an imported ``sync_batch_norm`` is not synced under dp.
    """
    for alias, base in (("depthwise_conv2d_transpose", "conv2d_transpose"),
                        ("sync_batch_norm", "batch_norm")):
        info = get_op(base)
        register_op(alias, list(info.input_slots), list(info.output_slots),
                    info.lower, grad=info.grad,
                    optional=tuple(info.optional),
                    no_grad_inputs=tuple(info.no_grad_inputs),
                    grad_maker=info.grad_maker, inplace=info.inplace)
        # imported training programs carry the serialized grad op type too
        if has_op(f"{base}_grad"):
            ginfo = get_op(f"{base}_grad")
            register_op(f"{alias}_grad", list(ginfo.input_slots),
                        list(ginfo.output_slots), ginfo.lower,
                        grad=ginfo.grad, optional=tuple(ginfo.optional),
                        no_grad_inputs=tuple(ginfo.no_grad_inputs),
                        inplace=ginfo.inplace)


_register_aliases()
