"""Interop op lowerings: reference op types that appear in exported
programs (counterpart of ``paddle_tpu/ops/compat_ops.py``).

Ported so far: ``cos_sim``, SSD's ``mine_hard_examples`` and the aliases
``sync_batch_norm`` and ``depthwise_conv2d_transpose`` (with their
``_grad`` types).  Still to come, the JAX module's 23 others:
``average_accumulates``, ``conv_shift``,
``fake_channel_wise_dequantize_max_abs``,
``fake_quantize_dequantize_moving_average_abs_max``, ``fill``,
``fill_zeros_like2``, ``l1_norm``, ``load``, ``load_combine``,
``lod_reset``, ``max_pool2d_with_index`` and ``max_pool3d_with_index``
(each with its grad), ``minus``,
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


@simple_op("mine_hard_examples",
           ["ClsLoss", "LocLoss", "MatchIndices", "MatchDist"],
           ["NegIndices", "UpdatedMatchIndices"],
           optional=("LocLoss", "MatchDist"), grad=None)
def _mine_hard_examples(ctx, cls_loss, loc_loss, match_indices, match_dist,
                        attrs):
    """Select hard negatives per image (mine_hard_examples_op.cc):
    max_negative keeps the num_pos*ratio highest-loss unmatched priors
    under the distance threshold (every unmatched prior without
    MatchDist); hard_example ranks all priors by cls (+ loc) loss, keeps
    sample_size, and demotes unselected positives in
    UpdatedMatchIndices.  NegIndices is the dense form of the
    reference's ragged rows: ascending prior indices padded with -1.
    Ranks come from stable sorts, so equal losses keep prior order."""
    mining = attrs.get("mining_type", "max_negative")
    ratio = float(attrs.get("neg_pos_ratio", 1.0))
    thr = float(attrs.get("neg_dist_threshold", 0.5))
    sample = int(attrs.get("sample_size", 0))
    n, p = match_indices.shape
    loss = cls_loss.float()
    if mining == "hard_example" and loc_loss is not None:
        loss = loss + loc_loss.float()
    is_neg = match_indices == -1
    if mining == "max_negative":
        eligible = (is_neg if match_dist is None
                    else is_neg & (match_dist.float() < thr))
        neg_sel = torch.minimum(
            (torch.sum(~is_neg, dim=1, dtype=torch.int32).float()
             * ratio).to(torch.int32),
            torch.sum(eligible, dim=1, dtype=torch.int32))
    elif mining == "hard_example":
        if sample <= 0:
            raise ValueError(
                "mine_hard_examples: mining_type='hard_example' needs "
                f"sample_size > 0, got {sample}")
        eligible = torch.ones((n, p), dtype=torch.bool,
                              device=loss.device)
        neg_sel = torch.full((n,), min(sample, p), dtype=torch.int32,
                             device=loss.device)
    else:
        raise NotImplementedError(f"mining_type {mining!r}")
    masked = torch.where(eligible, loss, -torch.inf)
    order = torch.argsort(-masked, dim=1, stable=True)   # loss descending
    inv_rank = torch.argsort(order, dim=1, stable=True)  # prior -> rank
    selected = eligible & (inv_rank < neg_sel[:, None])
    # the selected negatives in ascending prior order, padded with -1
    neg_mask = selected & is_neg
    cols = torch.arange(p, device=loss.device)
    asc = torch.sort(torch.where(neg_mask, cols[None, :], p), dim=1).values
    neg_indices = torch.where(asc < p, asc, -1).to(torch.int64)
    if mining == "hard_example":
        updated = torch.where((match_indices > -1) & ~selected,
                              torch.full_like(match_indices, -1),
                              match_indices)
    else:
        updated = match_indices
    return neg_indices, updated


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
