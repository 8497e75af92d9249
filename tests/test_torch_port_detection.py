"""The detection family of the PyTorch port against the JAX package, on
the CPU.

- Every op the port adds for it (prior_box, density_prior_box,
  anchor_generator, iou_similarity, box_coder, box_clip,
  bipartite_match, yolo_box, multiclass_nms, roi_align, roi_pool,
  target_assign, mine_hard_examples, ssd_loss_op, generate_proposals,
  rpn_target_assign, retinanet_target_assign, generate_proposal_labels,
  generate_mask_labels, yolov3_loss, collect_fpn_proposals,
  distribute_fpn_proposals, box_decoder_and_assign,
  retinanet_detection_output, deformable_conv, psroi_pool,
  deformable_psroi_pooling, roi_perspective_transform,
  polygon_box_transform, cvm, leaky_relu, bilinear_interp,
  nearest_interp, sigmoid_focal_loss) against the JAX registry's
  lowering on the same seeded numpy inputs, and each derived grad
  (``<op>_grad``) against the JAX registry's ``jax.vjp``-derived one on
  a seeded cotangent; ``detection_map`` (a host op) through a program of
  each package.
- Programs built by the JAX package, serialized (``program_to_dict``)
  and run by the port from the JAX package's startup values:
  tests/test_ssd_workload.py's mini SSD (3 Adam steps, then its
  detection rows), a MobileNet-SSD at width 0.25 (2 RMSProp steps; the
  port's own build gives the same op list) and a narrow two-scale
  YOLOv3 head (2 Momentum steps); ``fluid.metrics.DetectionMAP`` of
  each package over the rows.

Tolerances: 0 for indices, labels and masks; 1e-6 of the reference's
largest magnitude for elementwise fp32 math; 1e-5 where a reduction sums
in another order (losses, means over samples, einsums, the grads that
scatter into repeated indices, the linear solve).  Program losses within
1e-5 relative, detection rows: labels equal, scores and boxes 1e-5.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import registry as jreg

import paddle_tpu_torch
import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.fluid import executor as texecutor
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.ops import detection_ops

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_detection_models as dm  # noqa: E402

ELEM, RED = 1e-6, 1e-5
LOSS_RTOL, ROW_TOL = 1e-5, 1e-5

# the 48 registry entries of the detection slice
NEW_OPS = (
    "prior_box", "density_prior_box", "anchor_generator", "iou_similarity",
    "box_coder", "box_clip", "bipartite_match", "yolo_box",
    "multiclass_nms", "roi_align", "roi_align_grad", "roi_pool",
    "roi_pool_grad", "target_assign", "generate_proposals",
    "rpn_target_assign", "retinanet_target_assign",
    "generate_proposal_labels", "generate_mask_labels", "ssd_loss_op",
    "ssd_loss_op_grad", "yolov3_loss", "yolov3_loss_grad",
    "collect_fpn_proposals", "distribute_fpn_proposals",
    "box_decoder_and_assign", "retinanet_detection_output",
    "deformable_conv", "deformable_conv_grad", "psroi_pool",
    "psroi_pool_grad", "deformable_psroi_pooling",
    "deformable_psroi_pooling_grad", "roi_perspective_transform",
    "roi_perspective_transform_grad", "polygon_box_transform", "cvm",
    "cvm_grad", "detection_map", "mine_hard_examples", "leaky_relu",
    "leaky_relu_grad", "bilinear_interp", "bilinear_interp_grad",
    "nearest_interp", "nearest_interp_grad", "sigmoid_focal_loss",
    "sigmoid_focal_loss_grad")


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _u(*shape, seed=0, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _boxes(*lead, seed=0, scale=1.0, lo=0.05, hi=0.4):
    """Corner boxes [*lead, 4] inside [0, scale]²."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(lo, hi, lead + (2,))
    xy = rng.uniform(0.0, 1.0, lead + (2,)) * (1.0 - wh)
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)


def _clustered(n, m, seed=0, scale=1.0):
    """[n, m, 4] boxes jittered around a few centres, so NMS suppresses."""
    rng = np.random.RandomState(seed)
    base = _boxes(n, 4, seed=seed + 1, lo=0.2, hi=0.4)
    pick = rng.randint(0, 4, (n, m))
    jit = rng.uniform(-0.03, 0.03, (n, m, 4))
    out = np.take_along_axis(base, pick[..., None], axis=1) + jit
    return (np.clip(out, 0.0, 1.0) * scale).astype(np.float32)


def _softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _flat(out, to_numpy):
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        for m in (o if isinstance(o, (list, tuple)) else [o]):
            flat.append(None if m is None else to_numpy(m))
    return flat


def _run_jax(op_type, inputs, attrs):
    """The JAX lowering under one jit (compiling it once is quicker than
    running its scans and vmaps op by op)."""
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    present = [i for i, a in enumerate(inputs) if a is not None]

    def fn(*vals):
        full = [None] * len(inputs)
        for i, v in zip(present, vals):
            full[i] = v
        return jreg.get_op(op_type).lower(ctx, *full, attrs=dict(attrs))

    vals = [[jnp.asarray(x) for x in inputs[i]]
            if isinstance(inputs[i], list) else jnp.asarray(inputs[i])
            for i in present]
    return _flat(jax.jit(fn)(*vals), np.asarray)


def _run_port(op_type, inputs, attrs, device="cpu"):
    ctx = treg.LowerContext(device)
    vals = [None if a is None else
            [torch.from_numpy(np.array(x)).to(device) for x in a]
            if isinstance(a, list)
            else torch.from_numpy(np.array(a)).to(device) for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return _flat(out, lambda t: t.detach().cpu().numpy())


def _close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "iub" or tol == 0:
        np.testing.assert_array_equal(got.astype(np.float64),
                                      want.astype(np.float64), err_msg=what)
        return
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _compare(op_type, inputs, attrs, tol):
    got = _run_port(op_type, inputs, attrs)
    want = _run_jax(op_type, inputs, attrs)
    assert len(got) == len(want), op_type
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (op_type, i)
        if g is not None:
            _close(g, w, tol, f"{op_type} output {i}")
    return got


# ---------------------------------------------------------------------------
# the op cases: name -> (op type, inputs, attrs, tolerance, grad tolerance
# or None where the op has no grad)
# ---------------------------------------------------------------------------

_PRIOR_ATTRS = {"min_sizes": [8.0, 16.0], "max_sizes": [12.0, 24.0],
                "aspect_ratios": [2.0, 3.0], "variances": [0.1, 0.1, 0.2,
                                                          0.2],
                "flip": True, "clip": True, "step_w": 0.0, "step_h": 0.0,
                "offset": 0.5, "min_max_aspect_ratios_order": False}
_feat = _f(2, 8, 5, 5)
_image = _f(2, 3, 40, 40, seed=1)
_priors = detection_ops._prior_boxes_np(5, 5, 40, 40, _PRIOR_ATTRS)
_P = _priors[0].reshape(-1, 4)                     # 300 priors
_PV = _priors[1].reshape(-1, 4)
_anch = detection_ops._anchors_np(4, 4, {"anchor_sizes": [16.0, 32.0],
                                         "aspect_ratios": [0.5, 1.0, 2.0],
                                         "stride": [8.0, 8.0]})
_gt = np.concatenate([_boxes(2, 3, seed=3, lo=0.1, hi=0.5),
                      np.zeros((2, 1, 4), np.float32)], axis=1)  # pad row
_gtl = np.array([[[1], [2], [3], [0]], [[2], [2], [1], [0]]], np.int32)
_rois = np.concatenate([_boxes(5, seed=4, scale=22.0, lo=0.2, hi=0.7)],
                       axis=0)
_rbi = np.array([0, 1, 1, 0, 1], np.int32)
_quads = np.array([[1, 1, 9, 2, 10, 8, 2, 9], [0, 0, 11, 0, 11, 11, 0, 11],
                   [3, 2, 8, 3, 7, 10, 2, 7]], np.float32)
_yolo_gt = np.zeros((2, 5, 4), np.float32)
_yolo_gt[:, :4] = np.concatenate(
    [_u(2, 4, 2, seed=5, lo=0.2, hi=0.8), _u(2, 4, 2, seed=6, lo=0.05,
                                             hi=0.6)], -1)
_yolo_gt[1, 3] = 0.0                                   # a padded row
_yolo_label = np.random.RandomState(7).randint(0, 3, (2, 5)).astype(np.int32)
_mhe_match = np.array([[0, -1, -1, 2, -1, -1, 1, -1, -1, -1],
                       [-1, -1, 0, -1, -1, -1, -1, -1, 3, -1]], np.int32)
_YOLO_ATTRS = {"anchors": dm.YOLO_ANCHORS, "anchor_mask": [3, 4, 5],
               "class_num": 3, "ignore_thresh": 0.5, "downsample_ratio": 16}

CASES = {
    "prior_box": ("prior_box", [_feat, _image], _PRIOR_ATTRS, 0, None),
    "prior_box_mm_order_steps": (
        "prior_box", [_feat, _image],
        dict(_PRIOR_ATTRS, min_max_aspect_ratios_order=True, clip=False,
             step_w=7.0, step_h=9.0, offset=0.3), 0, None),
    "prior_box_no_max": ("prior_box", [_feat, _image],
                         dict(_PRIOR_ATTRS, max_sizes=[], min_sizes=[10.0]),
                         0, None),
    "density_prior_box": (
        "density_prior_box", [_f(1, 4, 4, 4), _f(1, 3, 32, 32)],
        {"fixed_sizes": [8.0, 16.0], "fixed_ratios": [1.0, 2.0],
         "densities": [2, 1], "clip": True}, 0, None),
    "anchor_generator": (
        "anchor_generator", [_f(1, 4, 3, 4)],
        {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
         "stride": [16.0, 16.0]}, 0, None),
    "iou_similarity": ("iou_similarity", [_boxes(6), _boxes(5, seed=1)],
                       {"box_normalized": True}, ELEM, None),
    "iou_similarity_pixels": (
        "iou_similarity", [_boxes(6, scale=30.0), _boxes(5, seed=1,
                                                         scale=30.0)],
        {"box_normalized": False}, ELEM, None),
    "box_coder_encode": ("box_coder", [_P[:7], _PV[:7], _boxes(5, seed=2)],
                         {"code_type": "encode_center_size"}, ELEM, None),
    "box_coder_decode": (
        "box_coder", [_P[:7], _PV[:7], _f(3, 7, 4, seed=2, scale=0.5)],
        {"code_type": "decode_center_size"}, ELEM, None),
    "box_coder_decode_attr_variance_axis1": (
        "box_coder", [_P[:7], None, _f(7, 3, 4, seed=3, scale=0.5)],
        {"code_type": "decode_center_size", "axis": 1,
         "variance": [0.1, 0.1, 0.2, 0.2], "box_normalized": False},
        ELEM, None),
    "box_clip": ("box_clip", [_f(2, 5, 4, seed=3, scale=30.0),
                              np.array([[30, 40, 1.0], [20, 25, 2.0]],
                                       np.float32)], {}, 0, None),
    "bipartite_match": ("bipartite_match", [_u(2, 4, 6, seed=4)],
                        {"match_type": "bipartite"}, 0, None),
    "bipartite_match_per_prediction_2d": (
        "bipartite_match", [_u(3, 7, seed=5)],
        {"match_type": "per_prediction", "dist_threshold": 0.3}, 0, None),
    "yolo_box": ("yolo_box",
                 [_f(2, 3 * 9, 5, 5, seed=6, scale=2.0),
                  np.array([[320, 320], [416, 400]], np.int32)],
                 {"anchors": [10, 13, 16, 30, 33, 23], "class_num": 4,
                  "conf_thresh": 0.3, "downsample_ratio": 32}, ELEM, None),
    "multiclass_nms": (
        "multiclass_nms",
        [_clustered(2, 30, seed=7),
         _softmax(_f(2, 4, 30, seed=8, scale=2.0), 1)],
        {"score_threshold": 0.05, "nms_top_k": 20, "keep_top_k": 15,
         "nms_threshold": 0.3, "background_label": 0}, ELEM, None),
    "multiclass_nms_pixels_padded": (
        "multiclass_nms",
        [_clustered(2, 12, seed=9, scale=50.0),
         _softmax(_f(2, 3, 12, seed=10, scale=3.0), 1)],
        {"score_threshold": 0.1, "nms_top_k": 8, "keep_top_k": 40,
         "nms_threshold": 0.4, "normalized": False, "background_label": -1},
        ELEM, None),
    "roi_align": ("roi_align", [_f(2, 3, 10, 12, seed=11), _rois, _rbi],
                  {"pooled_height": 3, "pooled_width": 2,
                   "spatial_scale": 0.5, "sampling_ratio": 2}, RED, RED),
    "roi_pool": ("roi_pool", [_f(2, 3, 10, 12, seed=12), _rois, _rbi],
                 {"pooled_height": 2, "pooled_width": 3,
                  "spatial_scale": 0.5}, 0, RED),
    "target_assign": (
        "target_assign",
        [_f(2, 4, 3, seed=13),
         np.array([[0, -1, 2, -1, 3, -1], [-1, 1, -1, -1, 0, 2]], np.int32),
         np.array([[1, 5, -1], [0, -1, -1]], np.int32)],
        {"mismatch_value": -2.0}, 0, None),
    "mine_hard_examples_max_negative": (
        "mine_hard_examples",
        [_u(2, 10, seed=14), None, _mhe_match, _u(2, 10, seed=15)],
        {"mining_type": "max_negative", "neg_pos_ratio": 1.5,
         "neg_dist_threshold": 0.7}, 0, None),
    "mine_hard_examples_hard_example": (
        "mine_hard_examples",
        [_u(2, 10, seed=16), _u(2, 10, seed=17), _mhe_match, None],
        {"mining_type": "hard_example", "sample_size": 4}, 0, None),
    "ssd_loss_op": (
        "ssd_loss_op",
        [_f(2, 300, 4, seed=18, scale=0.3), _f(2, 300, 5, seed=19), _gt,
         _gtl, _P, _PV],
        {"overlap_threshold": 0.3, "neg_pos_ratio": 3.0}, RED, RED),
    "ssd_loss_op_unnormalized": (
        "ssd_loss_op",
        [_f(2, 300, 4, seed=20, scale=0.3), _f(2, 300, 5, seed=21), _gt,
         _gtl, _P, None],
        {"overlap_threshold": 0.5, "neg_pos_ratio": 2.0, "normalize": False,
         "loc_loss_weight": 0.5}, RED, None),
    "generate_proposals": (
        "generate_proposals",
        [_f(2, 6, 4, 4, seed=22), _f(2, 24, 4, 4, seed=23, scale=0.3),
         np.array([[32, 32, 1], [30, 25, 1]], np.float32), _anch[0],
         _anch[1]],
        {"pre_nms_topN": 40, "post_nms_topN": 12, "nms_thresh": 0.5,
         "min_size": 2.0}, ELEM, None),
    "rpn_target_assign": (
        "rpn_target_assign",
        [_anch[0].reshape(-1, 4), _gt * 32.0, None, None],
        {"rpn_batch_size_per_im": 16, "rpn_positive_overlap": 0.5,
         "rpn_negative_overlap": 0.3}, ELEM, None),
    "retinanet_target_assign": (
        "retinanet_target_assign",
        [_anch[0].reshape(-1, 4), _gt * 32.0, _gtl, None, None],
        {"positive_overlap": 0.4, "negative_overlap": 0.3}, ELEM, None),
    "generate_proposal_labels": (
        "generate_proposal_labels",
        [_boxes(2, 20, seed=24, scale=32.0), _gtl[..., 0], None, _gt * 32.0,
         None],
        {"batch_size_per_im": 8, "fg_thresh": 0.3, "bg_thresh_hi": 0.3},
        ELEM, None),
    "generate_mask_labels": (
        "generate_mask_labels",
        [None, _gtl[:, :2, 0],  None,
         (_u(2, 2, 16, 16, seed=25) > 0.4).astype(np.int32),
         _boxes(2, 5, seed=26, scale=15.0),
         np.array([[1, 0, 2, 1, 1], [0, 2, 2, 1, 0]], np.int32)],
        {"resolution": 7}, 0, None),
    "yolov3_loss": (
        "yolov3_loss",
        [_f(2, 3 * 8, 4, 4, seed=27), _yolo_gt, _yolo_label, None],
        _YOLO_ATTRS, RED, RED),
    "yolov3_loss_score_no_smooth": (
        "yolov3_loss",
        [_f(2, 3 * 8, 4, 4, seed=28), _yolo_gt, _yolo_label,
         _u(2, 5, seed=29, lo=0.5, hi=1.0)],
        dict(_YOLO_ATTRS, use_label_smooth=False, anchor_mask=[0, 1, 2]),
        RED, None),
    "collect_fpn_proposals": (
        "collect_fpn_proposals",
        [[_boxes(2, 6, seed=30, scale=64.0), _boxes(2, 5, seed=31,
                                                   scale=64.0)],
         [_u(2, 6, 1, seed=32), _u(2, 5, 1, seed=33)]],
        {"post_nms_topN": 14}, 0, None),
    "distribute_fpn_proposals": (
        "distribute_fpn_proposals",
        [_boxes(2, 10, seed=34, scale=600.0, lo=0.02, hi=0.9)],
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}, 0, None),
    "box_decoder_and_assign": (
        "box_decoder_and_assign",
        [_boxes(6, seed=35, scale=40.0), _PV[:6],
         _f(6, 12, seed=36, scale=0.5), _u(6, 3, seed=37)], {}, ELEM, None),
    "retinanet_detection_output": (
        "retinanet_detection_output",
        [[_f(2, 12, 4, seed=38, scale=0.2), _f(2, 6, 4, seed=39, scale=0.2)],
         [_u(2, 12, 3, seed=40), _u(2, 6, 3, seed=41)],
         [_clustered(1, 12, seed=42, scale=30.0)[0],
          _clustered(1, 6, seed=43, scale=30.0)[0]],
         np.array([[32, 32, 1], [28, 30, 1]], np.float32)],
        {"score_threshold": 0.2, "nms_top_k": 10, "keep_top_k": 8,
         "nms_threshold": 0.4}, ELEM, None),
    "deformable_conv": (
        "deformable_conv",
        [_f(2, 4, 7, 7, seed=44), _f(2, 18, 5, 5, seed=45),
         _u(2, 9, 5, 5, seed=46), _f(6, 4, 3, 3, seed=47)],
        {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1],
         "groups": 1}, RED, RED),
    "deformable_conv_groups_no_mask": (
        "deformable_conv",
        [_f(1, 4, 6, 6, seed=48), _f(1, 36, 6, 6, seed=49, scale=0.7),
         None, _f(6, 2, 3, 3, seed=50)],
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 2}, RED, None),
    "psroi_pool": ("psroi_pool", [_f(2, 18, 8, 8, seed=51),
                                  _boxes(4, seed=52, scale=14.0),
                                  np.array([0, 1, 0, 1], np.int32)],
                   {"output_channels": 2, "pooled_height": 3,
                    "pooled_width": 3, "spatial_scale": 0.5}, RED, RED),
    "deformable_psroi_pooling": (
        "deformable_psroi_pooling",
        [_f(2, 18, 8, 8, seed=53), _boxes(4, seed=54, scale=14.0),
         _f(4, 2, 3, 3, seed=55), np.array([1, 0, 0, 1], np.int32)],
        {"output_dim": 2, "pooled_height": 3, "pooled_width": 3,
         "spatial_scale": 0.5, "trans_std": 0.1}, RED, RED),
    "deformable_psroi_pooling_no_trans": (
        "deformable_psroi_pooling",
        [_f(1, 5, 8, 8, seed=56), _boxes(3, seed=57, scale=7.0), None,
         None],
        {"output_dim": 4, "pooled_height": 2, "pooled_width": 2,
         "no_trans": True}, RED, None),
    "roi_perspective_transform": (
        "roi_perspective_transform",
        [_f(2, 3, 12, 12, seed=58), _quads, np.array([0, 1, 1], np.int32)],
        {"transformed_height": 4, "transformed_width": 5}, RED, RED),
    "polygon_box_transform": ("polygon_box_transform",
                              [_f(2, 4, 3, 5, seed=59)], {}, ELEM, None),
    "cvm": ("cvm", [np.abs(_f(5, 6, seed=60)), _u(5, 2, seed=61)],
            {"use_cvm": True}, ELEM, ELEM),
    "cvm_strip": ("cvm", [np.abs(_f(5, 6, seed=62)), _u(5, 2, seed=63)],
                  {"use_cvm": False}, 0, None),
    "leaky_relu": ("leaky_relu", [_f(3, 7, seed=64)], {"alpha": 0.1}, 0,
                   ELEM),
    "bilinear_interp_align_corners": (
        "bilinear_interp", [_f(2, 3, 5, 4, seed=65), None],
        {"out_h": 8, "out_w": 7}, ELEM, RED),
    "bilinear_interp_half_pixel": (
        "bilinear_interp", [_f(1, 2, 4, 6, seed=66), None],
        {"out_h": 7, "out_w": 3, "align_corners": False, "align_mode": 0},
        ELEM, None),
    "bilinear_interp_mode1_scale": (
        "bilinear_interp", [_f(1, 2, 3, 5, seed=67), None],
        {"scale": 2.0, "align_corners": False, "align_mode": 1}, ELEM, None),
    "nearest_interp_align_corners": (
        "nearest_interp", [_f(2, 3, 4, 4, seed=68), None],
        {"out_h": 8, "out_w": 8}, 0, RED),
    "nearest_interp_floor": (
        "nearest_interp", [_f(1, 2, 5, 3, seed=69), None],
        {"out_h": 10, "out_w": 7, "align_corners": False}, 0, None),
    "sigmoid_focal_loss": (
        "sigmoid_focal_loss",
        [_f(6, 4, seed=70, scale=2.0),
         np.array([[0], [1], [4], [-1], [2], [3]], np.int32),
         np.array([3], np.int32)], {"gamma": 2.0, "alpha": 0.25}, ELEM,
        ELEM),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_matches_jax(case):
    op_type, inputs, attrs, tol, _ = CASES[case]
    _compare(op_type, inputs, attrs, tol)


# one derived-grad case an op (the variants hold the forward only)
GRAD_CASES = sorted(c for c, v in CASES.items() if v[4] is not None)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_derived_grad_matches_jax(case):
    """``<op>_grad`` on a seeded cotangent of each float output (none for
    the integer masks), against the JAX registry's vjp."""
    op_type, inputs, attrs, _, tol = CASES[case]
    outs = _run_port(op_type, inputs, attrs)  # the forward's shapes
    info = jreg.get_op(op_type)
    cots = []
    for k, (slot, o) in enumerate(zip(info.output_slots, outs)):
        cots.append(None if o is None or o.dtype.kind != "f"
                    else _f(*o.shape, seed=100 + k))
    _compare(op_type + "_grad", list(inputs) + cots, attrs, tol)


def test_registry_holds_the_slice_entries():
    """The 48 entries, each also one of the JAX registry's; nothing the
    JAX registry lacks."""
    assert len(NEW_OPS) == len(set(NEW_OPS)) == 48
    for name in NEW_OPS:
        assert treg.has_op(name) and name in treg._OP_REGISTRY, name
        assert name in jreg._OP_REGISTRY, name
    assert not set(treg._OP_REGISTRY) - set(jreg._OP_REGISTRY)


def test_layers_export_every_detection_name():
    from paddle_tpu.fluid.layers import detection as jdet

    for name in list(jdet.__all__) + ["leaky_relu", "image_resize",
                                      "resize_nearest", "resize_bilinear",
                                      "sigmoid_focal_loss"]:
        assert callable(getattr(tfluid.layers, name, None)), name
        assert name in tfluid.layers.__all__, name


def test_priors_are_kept_per_shape_attrs_and_device():
    """prior_box returns the same kept tensors for the same feature shape,
    image shape and attrs (a captured graph reads them in place), others
    for another shape."""
    ctx = treg.LowerContext("cpu")
    lower = treg.get_op("prior_box").lower
    a = lower(ctx, torch.zeros(2, 8, 5, 5), torch.zeros(2, 3, 40, 40),
              attrs=dict(_PRIOR_ATTRS))
    b = lower(ctx, torch.zeros(4, 8, 5, 5), torch.zeros(4, 3, 40, 40),
              attrs=dict(_PRIOR_ATTRS))
    c = lower(ctx, torch.zeros(2, 8, 4, 5), torch.zeros(2, 3, 40, 40),
              attrs=dict(_PRIOR_ATTRS))
    assert a[0] is b[0] and a[1] is b[1]
    assert c[0] is not a[0] and c[0].shape == (4, 5, 12, 4)


def test_nms_keeps_the_lower_index_among_equal_scores():
    """Equal scores keep their index order (``lax.top_k``'s rule), so a
    duplicated box suppresses its later copy, not the earlier one."""
    box = np.array([[[0.1, 0.1, 0.4, 0.4]] * 3 + [[0.6, 0.6, 0.9, 0.9]]],
                   np.float32)
    scores = np.array([[[0.0] * 4, [0.5, 0.5, 0.5, 0.5]]], np.float32)
    attrs = {"score_threshold": 0.1, "nms_top_k": 4, "keep_top_k": 4,
             "nms_threshold": 0.5}
    got = _compare("multiclass_nms", [box, scores], attrs, 0)[0]
    np.testing.assert_array_equal(got[0, :, 0], [1, 1, -1, -1])
    np.testing.assert_array_equal(got[0, :2, 2:], box[0, [0, 3]])


def test_detection_map_host_op_matches_jax_and_plans_eagerly():
    """fluid.layers.detection_map through a program of each package on
    the same detections and labels (difficult flags and padding rows
    included): the same mAP; in the port the plan runs the eager loop
    (HOST_OPS)."""
    rng = np.random.RandomState(3)
    det = np.full((2, 6, 6), -1.0, np.float32)
    lab = np.full((2, 4, 6), -1.0, np.float32)
    for b in range(2):
        g = _boxes(3, seed=80 + b)
        lab[b, :3, 0] = rng.randint(1, 4, 3)
        lab[b, :3, 1] = [0, 1, 0]
        lab[b, :3, 2:] = g
        d = g[[0, 1, 2, 0, 2]] + rng.uniform(-0.05, 0.05, (5, 4))
        det[b, :5, 0] = np.concatenate([lab[b, :3, 0], [2, 3]])
        det[b, :5, 1] = rng.uniform(0.2, 1.0, 5)
        det[b, :5, 2:] = d
    want = []
    for fl in (jfluid, tfluid):
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            d = fl.data("det", [2, 6, 6], False, dtype="float32")
            g = fl.data("lab", [2, 4, 6], False, dtype="float32")
            m = fl.layers.detection_map(d, g, class_num=4,
                                        overlap_threshold=0.5,
                                        ap_version="11point")
        exe = fl.Executor(fl.CPUPlace())
        want.append(float(np.asarray(exe.run(
            main, feed={"det": det, "lab": lab}, fetch_list=[m],
            scope=fl.Scope())[0]).reshape(-1)[0]))
        if fl is tfluid:
            plan = exe.compiled_for(main)[0].plan
            assert plan.host_ops == ["detection_map"] and plan.eager_only
    assert 0.0 < want[0] <= 1.0
    np.testing.assert_allclose(want[1], want[0], rtol=1e-6)


# ---------------------------------------------------------------------------
# programs built by the JAX package, run by the port
# ---------------------------------------------------------------------------


def _to_port(built, names=("main", "startup", "test")):
    return {k: tfluid.io.program_from_dict(
        jfluid.io.program_to_dict(built[k])) for k in names if k in built}


def _copy_state(jmain, jscope, tscope):
    """Every persistable the JAX startup made, into the port's scope."""
    for name, v in jmain.global_block().vars.items():
        if not v.persistable:
            continue
        val = jscope.get(name)
        if val is not None:
            tscope.set(name, torch.from_numpy(np.array(val)))


def _train_both(built, feeds, steps, fetch):
    """``steps`` runs of the JAX program and of its serialized copy in
    the port from the JAX startup's state: the two loss lists and both
    scopes."""
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(built["startup"], scope=jscope)
    ported = _to_port(built)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    _copy_state(built["main"], jscope, tscope)
    jl, tl = [], []
    for i in range(steps):
        feed = feeds(i)
        jl.append(float(np.asarray(jexe.run(
            built["main"], feed=feed, fetch_list=[fetch.name],
            scope=jscope)[0]).reshape(-1)[0]))
        tl.append(float(np.asarray(texe.run(
            ported["main"], feed=feed, fetch_list=[fetch.name],
            scope=tscope)[0]).reshape(-1)[0]))
    return dict(jax=np.asarray(jl), port=np.asarray(tl), jexe=jexe,
                jscope=jscope, texe=texe, tscope=tscope, ported=ported)


def _rows_close(got, want):
    """Detection rows: labels equal; scores and boxes within ROW_TOL
    where the reference's row is a detection."""
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    valid = want[..., 0] >= 0
    np.testing.assert_allclose(got[valid][:, 1:], want[valid][:, 1:],
                               rtol=ROW_TOL, atol=ROW_TOL)


@pytest.fixture(scope="module")
def mini_ssd():
    built = dm.build_mini_ssd(paddle_tpu)
    rng = np.random.RandomState(0)
    batches = [dm.mini_ssd_batch(rng) for _ in range(3)]
    run = _train_both(built, lambda i: batches[i], 3, built["loss"])
    feed = {"img": dm.mini_ssd_batch(np.random.RandomState(1), n=4)["img"]}
    run["rows_jax"] = np.asarray(run["jexe"].run(
        built["test"], feed=feed, fetch_list=[built["det"].name],
        scope=run["jscope"])[0])
    run["rows_port"] = np.asarray(run["texe"].run(
        run["ported"]["test"], feed=feed, fetch_list=[built["det"].name],
        scope=run["tscope"])[0])
    return run


def test_mini_ssd_from_jax_program_trains_and_detects(mini_ssd):
    np.testing.assert_allclose(mini_ssd["port"], mini_ssd["jax"],
                               rtol=LOSS_RTOL)
    assert np.all(np.isfinite(mini_ssd["port"]))
    _rows_close(mini_ssd["rows_port"], mini_ssd["rows_jax"])
    assert (mini_ssd["rows_port"][..., 0] >= 0).any()


def test_mini_ssd_port_build_matches_the_jax_program():
    jb = dm.build_mini_ssd(paddle_tpu)
    tb = dm.build_mini_ssd(paddle_tpu_torch)
    for key in ("main", "test"):
        assert [op.type for op in tb[key].global_block().ops] == \
            [op.type for op in jb[key].global_block().ops], key


def test_detection_map_metric_over_both_packages_rows(mini_ssd):
    """fluid.metrics.DetectionMAP of each package over the rows each
    package detected: equal mAP (11-point and integral)."""
    gts = dm.mini_ssd_batch(np.random.RandomState(1), n=4)
    vals = {}
    for key, metrics in (("rows_jax", jfluid.metrics),
                         ("rows_port", tfluid.metrics)):
        for ap in ("11point", "integral"):
            m = metrics.DetectionMAP(overlap_threshold=0.5)
            for i in range(4):
                rows = mini_ssd[key][i]
                m.update(rows[rows[:, 0] >= 0], gts["gt_box"][i],
                         gts["gt_lbl"][i, :, 0])
            vals[(key, ap)] = m.eval(ap)
    for ap in ("11point", "integral"):
        assert vals[("rows_port", ap)] == pytest.approx(
            vals[("rows_jax", ap)], rel=1e-6)


def _grad_rel(got, want):
    """||got − want|| over ||want|| across every gradient at once."""
    num = sum(float(np.sum((np.asarray(g, np.float64) - w) ** 2))
              for g, w in zip(got, want))
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want)
    return float(np.sqrt(num / den))


def test_mobilenet_ssd_narrow_op_list_and_steps():
    """MobileNet-SSD at width 0.25, 300², b2: the port's own build gives
    the JAX program's op list; the serialized JAX program runs 2 RMSProp
    steps in the port, each from the JAX package's state, losses within
    LOSS_RTOL.  The first step's gradients (every parameter at once)
    within 4x the JAX package's own reading from the input nudged by
    1e-6: the step is ill-conditioned (the nudge moves them ~0.7%:
    batch norm over 2 values a channel on the 1x1 map, and the
    hard-negative ranks), the port reads ~0.6%, a wrong backward O(1)."""
    jb = dm.build_mobilenet_ssd(paddle_tpu, scale=0.25, batch=2)
    tb = dm.build_mobilenet_ssd(paddle_tpu_torch, scale=0.25, batch=2)
    for key in ("main", "test"):
        assert [op.type for op in tb[key].global_block().ops] == \
            [op.type for op in jb[key].global_block().ops], key
    assert tuple(tb["locs"].shape) == (-1, 1917, 4)
    feed = dm.ssd_batch(2, seed=3)
    nudged = dict(feed, image=feed["image"] * np.float32(1 + 1e-6))
    fetch = [jb["loss"].name] + [p.name + "@GRAD"
                                 for p in jb["main"].all_parameters()]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jb["startup"], scope=jscope)
    control = jfluid.Scope()
    for name in list(jscope._vars):
        control.set(name, jnp.array(np.array(jscope.get(name))))
    ported = _to_port(jb)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    ctl = [np.asarray(v) for v in jexe.run(jb["main"], feed=nudged,
                                           fetch_list=fetch, scope=control)]
    losses = []
    for step in range(2):
        _copy_state(jb["main"], jscope, tscope)
        want = [np.asarray(v) for v in jexe.run(
            jb["main"], feed=feed, fetch_list=fetch, scope=jscope)]
        got = texe.run(ported["main"], feed=feed, fetch_list=fetch,
                       scope=tscope)
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
        losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
        if step == 0:
            port_rel = _grad_rel(got[1:], want[1:])
            ctl_rel = _grad_rel(ctl[1:], want[1:])
            assert port_rel <= 4 * ctl_rel, (port_rel, ctl_rel)
    assert losses[1] < losses[0]


def test_yolo_head_two_scales_steps():
    """The narrow two-scale YOLOv3 head: the port's build gives the JAX
    op list, and the serialized JAX program runs 2 Momentum steps in the
    port within LOSS_RTOL of the JAX package."""
    jb = dm.build_yolo_head(paddle_tpu)
    tb = dm.build_yolo_head(paddle_tpu_torch)
    ops = [op.type for op in jb["main"].global_block().ops]
    assert [op.type for op in tb["main"].global_block().ops] == ops
    for t in ("nearest_interp", "concat", "yolov3_loss", "leaky_relu",
              "yolov3_loss_grad", "nearest_interp_grad"):
        assert t in ops, t
    feed = dm.yolo_batch(2, seed=4)
    run = _train_both(jb, lambda i: feed, 2, jb["loss"])
    np.testing.assert_allclose(run["port"], run["jax"], rtol=LOSS_RTOL)


def test_host_ops_name_detection_map():
    assert "detection_map" in texecutor.HOST_OPS
