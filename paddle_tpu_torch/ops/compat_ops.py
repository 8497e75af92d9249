"""Interop op lowerings: reference op types that appear in exported
programs (counterpart of ``paddle_tpu/ops/compat_ops.py``).

Ported so far: ``cos_sim``.  Still to come, the JAX module's 24 others:
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

from paddle_tpu_torch.fluid.registry import simple_op


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
