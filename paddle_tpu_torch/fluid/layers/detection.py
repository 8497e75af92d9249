"""Detection layers (counterpart of
``paddle_tpu/fluid/layers/detection.py``; reference
python/paddle/fluid/layers/detection.py): thin wrappers over the
detection op family (ops/detection_ops.py, ops/detection_extra_ops.py),
which keeps every output at a static shape.  Op types, slots and attrs
are the JAX package's, so both packages build the same program.
"""

from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper

__all__ = ["prior_box", "density_prior_box", "anchor_generator", "box_coder",
           "iou_similarity", "box_clip", "bipartite_match", "yolo_box",
           "multiclass_nms", "roi_align", "roi_pool", "target_assign",
           "detection_output"]


def _two_out(helper, op_type, inputs, attrs, out_slots,
             dtypes=("float32", "float32")):
    outs = [helper.create_variable_for_type_inference(dtype=d,
                                                      stop_gradient=True)
            for d in dtypes]
    helper.append_op(op_type, inputs=inputs,
                     outputs={s: [o] for s, o in zip(out_slots, outs)},
                     attrs=attrs)
    return tuple(outs)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    helper = LayerHelper("prior_box", name=name)
    attrs = {"min_sizes": list(min_sizes),
             "max_sizes": list(max_sizes or []),
             "aspect_ratios": list(aspect_ratios),
             "variances": list(variance), "flip": flip, "clip": clip,
             "step_w": steps[0], "step_h": steps[1], "offset": offset,
             "min_max_aspect_ratios_order": min_max_aspect_ratios_order}
    return _two_out(helper, "prior_box",
                    {"Input": [input], "Image": [image]}, attrs,
                    ["Boxes", "Variances"])


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    attrs = {"densities": list(densities), "fixed_sizes": list(fixed_sizes),
             "fixed_ratios": list(fixed_ratios), "variances": list(variance),
             "clip": clip, "step_w": steps[0], "step_h": steps[1],
             "offset": offset}
    return _two_out(helper, "density_prior_box",
                    {"Input": [input], "Image": [image]}, attrs,
                    ["Boxes", "Variances"])


def anchor_generator(input, anchor_sizes, aspect_ratios,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=(16.0, 16.0),
                     offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", name=name)
    attrs = {"anchor_sizes": list(anchor_sizes),
             "aspect_ratios": list(aspect_ratios),
             "variances": list(variance), "stride": list(stride),
             "offset": offset}
    return _two_out(helper, "anchor_generator", {"Input": [input]}, attrs,
                    ["Anchors", "Variances"])


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, axis=0,
              name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(dtype=target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized,
             "axis": axis}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["variance"] = [float(v) for v in prior_box_var]
    elif prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]}, attrs=attrs)
    return out


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op("iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"box_normalized": box_normalized})
    return out


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op("box_clip", inputs={"Input": [input],
                                         "ImInfo": [im_info]},
                     outputs={"Output": [out]}, attrs={})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = helper.create_variable_for_type_inference(dtype="int32",
                                                    stop_gradient=True)
    dist = helper.create_variable_for_type_inference(
        dtype=dist_matrix.dtype, stop_gradient=True)
    helper.append_op("bipartite_match", inputs={"DistMat": [dist_matrix]},
                     outputs={"ColToRowMatchIndices": [idx],
                              "ColToRowMatchDist": [dist]},
                     attrs={"match_type": match_type,
                            "dist_threshold": dist_threshold})
    return idx, dist


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None):
    helper = LayerHelper("yolo_box", name=name)
    attrs = {"anchors": list(anchors), "class_num": class_num,
             "conf_thresh": conf_thresh, "downsample_ratio": downsample_ratio,
             "clip_bbox": clip_bbox}
    return _two_out(helper, "yolo_box",
                    {"X": [x], "ImgSize": [img_size]}, attrs,
                    ["Boxes", "Scores"])


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_top_k=400,
                   keep_top_k=200, nms_threshold=0.3, normalized=True,
                   background_label=0, name=None):
    """Static-shape NMS: returns [N, keep_top_k, 6] rows of (label, score,
    x1, y1, x2, y2) padded with label = -1 (the reference returns LoD)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(dtype=bboxes.dtype,
                                                    stop_gradient=True)
    helper.append_op("multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out]},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold,
                            "normalized": normalized,
                            "background_label": background_label})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, name=None):
    """SSD post-processing (reference detection.py detection_output):
    decode loc vs priors, then multiclass NMS.  loc [N, M, 4];
    scores [N, M, C] (softmax-ed); prior_box [M, 4]."""
    from . import nn

    # loc [N, M, 4] with priors [M, 4]: priors broadcast over the batch
    # axis, which is decode axis=0 (prior matches the second-to-last dim)
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size", axis=0)
    scores_t = nn.transpose(scores, [0, 2, 1])  # [N, C, M]
    return multiclass_nms(decoded, scores_t,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_batch_idx=None,
              name=None):
    helper = LayerHelper("roi_align", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        inputs["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op("roi_align", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale,
                            "sampling_ratio": sampling_ratio})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_batch_idx=None, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    argmax = helper.create_variable_for_type_inference(dtype="int32",
                                                       stop_gradient=True)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        inputs["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op("roi_pool", inputs=inputs,
                     outputs={"Out": [out], "Argmax": [argmax]},
                     attrs={"pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "spatial_scale": spatial_scale})
    return out


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0.0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    weight = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op("target_assign", inputs=inputs,
                     outputs={"Out": [out], "OutWeight": [weight]},
                     attrs={"mismatch_value": mismatch_value})
    return out, weight


# ---------------------------------------------------------------------------
# detection long tail (reference layers/detection.py remainder)
# ---------------------------------------------------------------------------


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """Returns (rpn_rois [N,K,4], rpn_roi_probs [N,K,1]) with K =
    post_nms_top_n, zero-padded (reference emits LoD rois)."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference("float32")
    probs = helper.create_variable_for_type_inference("float32")
    helper.append_op("generate_proposals",
                     inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                             "ImInfo": [im_info], "Anchors": [anchors],
                             "Variances": [variances]},
                     outputs={"RpnRois": [rois], "RpnRoiProbs": [probs]},
                     attrs={"pre_nms_topN": pre_nms_top_n,
                            "post_nms_topN": post_nms_top_n,
                            "nms_thresh": nms_thresh, "min_size": min_size})
    rois.stop_gradient = True
    probs.stop_gradient = True
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """Returns (pred_loc, pred_cls, target_label, target_bbox,
    bbox_inside_weight) — dense [N,A,...] (reference gathers by index;
    masks/weights carry the selection here).  use_random is accepted but the
    subsample is deterministic top-iou."""
    helper = LayerHelper("rpn_target_assign")
    loc_idx = helper.create_variable_for_type_inference("int32")
    score_idx = helper.create_variable_for_type_inference("int32")
    tgt_lbl = helper.create_variable_for_type_inference("int32")
    tgt_bbox = helper.create_variable_for_type_inference("float32")
    inw = helper.create_variable_for_type_inference("float32")
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if im_info is not None:
        ins["ImInfo"] = [im_info]
    helper.append_op("rpn_target_assign", inputs=ins,
                     outputs={"LocationIndex": [loc_idx],
                              "ScoreIndex": [score_idx],
                              "TargetLabel": [tgt_lbl],
                              "TargetBBox": [tgt_bbox],
                              "BBoxInsideWeight": [inw]},
                     attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
                            "rpn_fg_fraction": rpn_fg_fraction,
                            "rpn_positive_overlap": rpn_positive_overlap,
                            "rpn_negative_overlap": rpn_negative_overlap})
    for v in (loc_idx, score_idx, tgt_lbl, tgt_bbox, inw):
        v.stop_gradient = True
    return bbox_pred, cls_logits, tgt_lbl, tgt_bbox, inw


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None, im_info=None,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    helper = LayerHelper("retinanet_target_assign")
    outs = [helper.create_variable_for_type_inference(dt)
            for dt in ("int32", "int32", "int32", "float32", "float32",
                       "int32")]
    ins = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
           "GtLabels": [gt_labels]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if im_info is not None:
        ins["ImInfo"] = [im_info]
    helper.append_op("retinanet_target_assign", inputs=ins,
                     outputs={"LocationIndex": [outs[0]],
                              "ScoreIndex": [outs[1]],
                              "TargetLabel": [outs[2]],
                              "TargetBBox": [outs[3]],
                              "BBoxInsideWeight": [outs[4]],
                              "ForegroundNumber": [outs[5]]},
                     attrs={"positive_overlap": positive_overlap,
                            "negative_overlap": negative_overlap})
    for v in outs:
        v.stop_gradient = True
    return (bbox_pred, cls_logits, outs[2], outs[3], outs[4], outs[5])


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False):
    helper = LayerHelper("generate_proposal_labels")
    outs = [helper.create_variable_for_type_inference(dt)
            for dt in ("float32", "int32", "float32", "float32", "float32")]
    ins = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
           "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    if im_info is not None:
        ins["ImInfo"] = [im_info]
    helper.append_op("generate_proposal_labels", inputs=ins,
                     outputs={"Rois": [outs[0]], "LabelsInt32": [outs[1]],
                              "BboxTargets": [outs[2]],
                              "BboxInsideWeights": [outs[3]],
                              "BboxOutsideWeights": [outs[4]]},
                     attrs={"batch_size_per_im": batch_size_per_im,
                            "fg_fraction": fg_fraction,
                            "fg_thresh": fg_thresh,
                            "bg_thresh_hi": bg_thresh_hi,
                            "bg_thresh_lo": bg_thresh_lo})
    for v in outs:
        v.stop_gradient = True
    return tuple(outs)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes=1, resolution=14):
    helper = LayerHelper("generate_mask_labels")
    mask_rois = helper.create_variable_for_type_inference("float32")
    has_mask = helper.create_variable_for_type_inference("int32")
    masks = helper.create_variable_for_type_inference("int32")
    ins = {"GtClasses": [gt_classes], "GtSegms": [gt_segms],
           "Rois": [rois], "LabelsInt32": [labels_int32]}
    if im_info is not None:
        ins["ImInfo"] = [im_info]
    if is_crowd is not None:
        ins["IsCrowd"] = [is_crowd]
    helper.append_op("generate_mask_labels", inputs=ins,
                     outputs={"MaskRois": [mask_rois],
                              "RoiHasMaskInt32": [has_mask],
                              "MaskInt32": [masks]},
                     attrs={"resolution": resolution})
    for v in (mask_rois, has_mask, masks):
        v.stop_gradient = True
    return mask_rois, has_mask, masks


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    helper = LayerHelper("ssd_loss")
    loss = helper.create_variable_for_type_inference("float32")
    ins = {"Location": [location], "Confidence": [confidence],
           "GtBox": [gt_box], "GtLabel": [gt_label],
           "PriorBox": [prior_box]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    helper.append_op("ssd_loss_op", inputs=ins, outputs={"Loss": [loss]},
                     attrs={"overlap_threshold": overlap_threshold,
                            "neg_pos_ratio": neg_pos_ratio,
                            "loc_loss_weight": loc_loss_weight,
                            "conf_loss_weight": conf_loss_weight,
                            "background_label": background_label,
                            "normalize": normalize})
    return loss


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    helper = LayerHelper("yolov3_loss", name=name)
    loss = helper.create_variable_for_type_inference("float32")
    objm = helper.create_variable_for_type_inference("int32")
    gtm = helper.create_variable_for_type_inference("int32")
    ins = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        ins["GTScore"] = [gt_score]
    helper.append_op("yolov3_loss", inputs=ins,
                     outputs={"Loss": [loss], "ObjectnessMask": [objm],
                              "GTMatchMask": [gtm]},
                     attrs={"anchors": list(anchors),
                            "anchor_mask": list(anchor_mask),
                            "class_num": class_num,
                            "ignore_thresh": ignore_thresh,
                            "downsample_ratio": downsample_ratio,
                            "use_label_smooth": use_label_smooth})
    return loss


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    helper = LayerHelper("collect_fpn_proposals", name=name)
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("collect_fpn_proposals",
                     inputs={"MultiLevelRois": list(multi_rois),
                             "MultiLevelScores": list(multi_scores)},
                     outputs={"FpnRois": [out]},
                     attrs={"post_nms_topN": post_nms_top_n})
    out.stop_gradient = True
    return out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    nlevels = max_level - min_level + 1
    outs = [helper.create_variable_for_type_inference("float32")
            for _ in range(nlevels)]
    restore = helper.create_variable_for_type_inference("int32")
    helper.append_op("distribute_fpn_proposals",
                     inputs={"FpnRois": [fpn_rois]},
                     outputs={"MultiFpnRois": outs,
                              "RestoreIndex": [restore]},
                     attrs={"min_level": min_level, "max_level": max_level,
                            "refer_level": refer_level,
                            "refer_scale": refer_scale})
    for v in outs + [restore]:
        v.stop_gradient = True
    return outs, restore


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=None, name=None):
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = helper.create_variable_for_type_inference("float32")
    assigned = helper.create_variable_for_type_inference("float32")
    ins = {"PriorBox": [prior_box], "TargetBox": [target_box],
           "BoxScore": [box_score]}
    if prior_box_var is not None:
        ins["PriorBoxVar"] = [prior_box_var]
    helper.append_op("box_decoder_and_assign", inputs=ins,
                     outputs={"DecodeBox": [decoded],
                              "OutputAssignBox": [assigned]}, attrs={})
    return decoded, assigned


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    helper = LayerHelper("retinanet_detection_output")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op("retinanet_detection_output",
                     inputs={"BBoxes": list(bboxes), "Scores": list(scores),
                             "Anchors": list(anchors), "ImInfo": [im_info]},
                     outputs={"Out": [out]},
                     attrs={"score_threshold": score_threshold,
                            "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                            "nms_threshold": nms_threshold})
    out.stop_gradient = True
    return out


def deformable_conv(input, offset, mask, num_filters, filter_size,
                    stride=1, padding=0, dilation=1, groups=None,
                    deformable_groups=1, im2col_step=1, param_attr=None,
                    bias_attr=None, modulated=True, name=None):
    helper = LayerHelper("deformable_conv", name=name)
    pair = (lambda v: [v, v] if isinstance(v, int) else list(v))
    fs = pair(filter_size)
    groups = groups or 1
    w = helper.create_parameter(
        attr=param_attr,
        shape=[num_filters, input.shape[1] // groups] + fs,
        dtype=input.dtype, default_initializer=None)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Input": [input], "Offset": [offset], "Filter": [w]}
    if modulated and mask is not None:
        ins["Mask"] = [mask]
    helper.append_op("deformable_conv", inputs=ins,
                     outputs={"Output": [out]},
                     attrs={"strides": pair(stride),
                            "paddings": pair(padding),
                            "dilations": pair(dilation),
                            "groups": groups,
                            "deformable_groups": deformable_groups})
    if bias_attr is not False:
        from ..initializer import Constant

        b = helper.create_parameter(attr=bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True,
                                    default_initializer=Constant(0.0))
        from . import nn as nn_mod

        out = nn_mod.elementwise_add(out, b, axis=1)
    return out


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_batch_idx=None, name=None):
    helper = LayerHelper("psroi_pool", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "ROIs": [rois]}
    if rois_batch_idx is not None:
        ins["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op("psroi_pool", inputs=ins, outputs={"Out": [out]},
                     attrs={"output_channels": output_channels,
                            "spatial_scale": spatial_scale,
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width})
    return out


def deformable_roi_pooling(input, rois, trans=None, no_trans=False,
                           spatial_scale=1.0, group_size=(1, 1),
                           pooled_height=1, pooled_width=1, part_size=None,
                           sample_per_part=1, trans_std=0.1,
                           position_sensitive=False, rois_batch_idx=None,
                           name=None):
    helper = LayerHelper("deformable_roi_pooling", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    cnt = helper.create_variable_for_type_inference("float32")
    ins = {"Input": [input], "ROIs": [rois]}
    if trans is not None and not no_trans:
        ins["Trans"] = [trans]
    if rois_batch_idx is not None:
        ins["RoisBatchIdx"] = [rois_batch_idx]
    helper.append_op("deformable_psroi_pooling", inputs=ins,
                     outputs={"Output": [out], "TopCount": [cnt]},
                     attrs={"no_trans": no_trans,
                            "spatial_scale": spatial_scale,
                            "output_dim": input.shape[1] //
                            (pooled_height * pooled_width)
                            if position_sensitive else input.shape[1],
                            "pooled_height": pooled_height,
                            "pooled_width": pooled_width,
                            "trans_std": trans_std})
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0):
    helper = LayerHelper("roi_perspective_transform")
    out = helper.create_variable_for_type_inference(input.dtype)
    mat = helper.create_variable_for_type_inference("float32")
    helper.append_op("roi_perspective_transform",
                     inputs={"X": [input], "ROIs": [rois]},
                     outputs={"Out": [out], "TransformMatrix": [mat]},
                     attrs={"transformed_height": transformed_height,
                            "transformed_width": transformed_width,
                            "spatial_scale": spatial_scale})
    return out


def polygon_box_transform(input, name=None):
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("polygon_box_transform", inputs={"Input": [input]},
                     outputs={"Output": [out]}, attrs={})
    return out


def continuous_value_model(input, cvm, use_cvm=True):
    helper = LayerHelper("cvm")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("cvm", inputs={"X": [input], "CVM": [cvm]},
                     outputs={"Y": [out]}, attrs={"use_cvm": use_cvm})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference detection.py multi_box_head): per-level
    conv for loc/conf + prior boxes, concatenated across levels.  Returns
    (mbox_locs [N,P,4], mbox_confs [N,P,C], boxes [P,4], variances [P,4])."""
    from . import nn as nn_mod

    n_layer = len(inputs)
    if min_sizes is None:
        # reference ratio schedule
        min_sizes, max_sizes = [], []
        step = int(np.floor((max_ratio - min_ratio) / (n_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes
    locs, confs, boxes_all, vars_all = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = (aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple))
              else [aspect_ratios[i]])
        if steps is not None:
            st = steps[i] if isinstance(steps[i], (list, tuple)) \
                else [steps[i], steps[i]]
        else:
            st = [step_w[i] if step_w else 0.0,
                  step_h[i] if step_h else 0.0]
        box, var = prior_box(
            x, image, min_sizes=[mins] if not isinstance(mins, list) else mins,
            max_sizes=[maxs] if maxs and not isinstance(maxs, list) else maxs,
            aspect_ratios=ar, variance=list(variance), flip=flip, clip=clip,
            steps=st, offset=offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        num_priors_per_loc = box.shape[2] if len(box.shape) == 4 else 1
        # flatten priors [H,W,P,4] -> [H*W*P, 4]
        box2 = nn_mod.reshape(box, [-1, 4])
        var2 = nn_mod.reshape(var, [-1, 4])
        num_loc_out = num_priors_per_loc * 4
        loc = nn_mod.conv2d(x, num_loc_out, kernel_size, padding=pad,
                            stride=stride)
        loc = nn_mod.transpose(loc, [0, 2, 3, 1])
        loc = nn_mod.reshape(loc, [0, -1, 4])
        conf = nn_mod.conv2d(x, num_priors_per_loc * num_classes,
                             kernel_size, padding=pad, stride=stride)
        conf = nn_mod.transpose(conf, [0, 2, 3, 1])
        conf = nn_mod.reshape(conf, [0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        boxes_all.append(box2)
        vars_all.append(var2)
    mbox_locs = nn_mod.concat(locs, axis=1)
    mbox_confs = nn_mod.concat(confs, axis=1)
    boxes = nn_mod.concat(boxes_all, axis=0)
    variances = nn_mod.concat(vars_all, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


__all__ += [
    "generate_proposals", "rpn_target_assign", "retinanet_target_assign",
    "generate_proposal_labels", "generate_mask_labels", "ssd_loss",
    "yolov3_loss", "collect_fpn_proposals", "distribute_fpn_proposals",
    "box_decoder_and_assign", "retinanet_detection_output",
    "deformable_conv", "psroi_pool", "deformable_roi_pooling",
    "roi_perspective_transform", "polygon_box_transform",
    "continuous_value_model", "multi_box_head",
]


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version="integral", detect_length=None,
                  label_length=None):
    """VOC mean average precision (reference detection.py:968 →
    detection_map_op.h, a CPU-only kernel there too; here a host op, so
    a program holding it runs eagerly).  Dense analog of the LoD inputs:
    detect_res [B, M, 6] (label, score, box), label [B, N, 6]
    (label, difficult, box) or [B, N, 5]; padded rows have label < 0, or
    pass detect_length/label_length.  Cross-batch accumulation states are
    host metrics here: use fluid.metrics.DetectionMAP."""
    if out_states is not None or input_states is not None \
            or has_state is not None:
        raise NotImplementedError(
            "detection_map accumulation states are host metrics here — use "
            "fluid.metrics.DetectionMAP for cross-batch accumulation")
    helper = LayerHelper("detection_map")
    out = helper.create_variable_for_type_inference("float32",
                                                    stop_gradient=True)
    out.shape = (1,)
    inputs = {"DetectRes": [detect_res], "Label": [label]}
    if detect_length is not None:
        inputs["DetectLength"] = [detect_length]
    if label_length is not None:
        inputs["LabelLength"] = [label_length]
    helper.append_op("detection_map", inputs=inputs,
                     outputs={"MAP": [out]},
                     attrs={"class_num": class_num,
                            "background_label": background_label,
                            "overlap_threshold": overlap_threshold,
                            "evaluate_difficult": evaluate_difficult,
                            "ap_type": ap_version})
    return out


__all__ += ["detection_map"]
