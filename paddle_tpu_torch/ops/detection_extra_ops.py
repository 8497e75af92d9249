"""Detection long tail (counterpart of
``paddle_tpu/ops/detection_extra_ops.py``): generate_proposals, the RPN
and RetinaNet target assigns, proposal and mask labels, ssd_loss,
yolov3_loss, FPN collect/distribute, box_decoder_and_assign,
retinanet_detection_output, the deformable conv and RoI poolings,
psroi_pool, roi_perspective_transform, polygon_box_transform, cvm and
the host op detection_map.

As in the JAX package, ops whose reference output is ragged (LoD)
return fixed-capacity tensors padded with sentinel rows, and the
subsampling the reference randomizes is a deterministic top-k by
matching quality.  The JAX package maps each op over the images
(``vmap``); here every op works on the whole batch at once.  Its grads
(ssd_loss, yolov3_loss, the deformable ops, psroi_pool,
roi_perspective_transform, cvm) are derived by the registry.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.fluid.registry import simple_op

from .detection_ops import (bilinear_sample, const_vector, iou_matrix,
                            nms_keep, nms_rows, roi_batch_index, take_rows,
                            top_k)

_NEG = -1e9


def _decode_deltas(anchors, deltas, variances=None):
    """anchors [..., 4] corner; deltas [..., 4] (dx,dy,dw,dh) → corner
    boxes (broadcast over the leading dims)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    if variances is not None:
        deltas = deltas * variances
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -10.0, 4.0)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10.0, 4.0)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w - 1.0, cy + 0.5 * h - 1.0], dim=-1)


def _encode_deltas(anchors, gt):
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * aw
    acy = anchors[..., 1] + 0.5 * ah
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(torch.clamp(gw / aw, min=1e-6)),
                        torch.log(torch.clamp(gh / ah, min=1e-6))], dim=-1)


def _clip_to_image(boxes, im_info):
    """boxes [N, M, 4] clipped to each image's (h, w) of im_info [N, >=2]."""
    ih = im_info[:, 0:1] - 1
    iw = im_info[:, 1:2] - 1
    return torch.stack([torch.minimum(torch.clamp(boxes[..., 0], min=0), iw),
                        torch.minimum(torch.clamp(boxes[..., 1], min=0), ih),
                        torch.minimum(torch.clamp(boxes[..., 2], min=0), iw),
                        torch.minimum(torch.clamp(boxes[..., 3], min=0), ih)],
                       dim=-1)


def _valid_gt(g):
    """[N, G] gt rows with x2 > x1 and y2 > y1 (padding rows are not)."""
    return (g[..., 2] > g[..., 0]) & (g[..., 3] > g[..., 1])


def _mark(shape, idx, like):
    """A [N, A] bool mask set at ``idx`` [N, k]."""
    return torch.zeros(shape, dtype=torch.bool, device=like.device).scatter(
        1, idx, True)


@simple_op("generate_proposals",
           ["Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances"],
           ["RpnRois", "RpnRoiProbs"], grad=None)
def _generate_proposals(ctx, scores, deltas, im_info, anchors, variances,
                        attrs):
    """RPN proposal generation (generate_proposals_op.cc): decode anchors,
    clip to image, drop tiny boxes, NMS.  Outputs are per-image fixed
    [N, post_nms_top_n, 4] / [N, post_nms_top_n, 1], zero-padded (the
    reference emits LoD)."""
    pre_n = int(attrs.get("pre_nms_topN", 1000))
    post_n = int(attrs.get("post_nms_topN", 100))
    nms_thresh = float(attrs.get("nms_thresh", 0.7))
    min_size = float(attrs.get("min_size", 0.0))
    n = scores.shape[0]
    a = anchors.reshape(-1, 4).float()
    var = variances.reshape(-1, 4).float() if variances is not None \
        else None
    s = scores.float().permute(0, 2, 3, 1).reshape(n, -1)        # [N, M]
    d = deltas.float().permute(0, 2, 3, 1).reshape(n, -1, 4)
    boxes = _clip_to_image(_decode_deltas(a, d, var), im_info.float())
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    ok = (ws >= min_size) & (hs >= min_size)
    s = torch.where(ok, s, _NEG)
    k = min(pre_n, s.shape[1])
    top_s, top_i = top_k(s, k)
    cand = take_rows(boxes, top_i)
    order, kept, kept_s = nms_keep(cand, top_s, nms_thresh, k,
                                   normalized=False)
    final_s = torch.where(kept, kept_s, _NEG)
    kk = min(post_n, k)
    sel_s, sel_i = top_k(final_s, kk)
    valid = sel_s > _NEG / 2
    rois = torch.where(valid[..., None],
                       take_rows(take_rows(cand, order), sel_i), 0.0)
    probs = torch.where(valid, sel_s, 0.0)[..., None]
    if kk < post_n:
        rois = torch.nn.functional.pad(rois, (0, 0, 0, post_n - kk))
        probs = torch.nn.functional.pad(probs, (0, 0, 0, post_n - kk))
    return rois, probs


def _subsample(fg, bg, best, n_fg, n_bg):
    """Deterministic subsample: the highest-IoU fg and the lowest-IoU
    bg (ties to the lower index).  Returns (fg_keep, bg_keep, fg_idx,
    bg_idx, fg_rank)."""
    a = fg.shape[1]
    fg_rank = torch.where(fg, best, _NEG)
    _, fg_idx = top_k(fg_rank, min(n_fg, a))
    fg_keep = _mark(fg.shape, fg_idx, fg) & fg
    bg_rank = torch.where(bg & ~fg_keep, -best, _NEG)
    _, bg_idx = top_k(bg_rank, min(n_bg, a))
    bg_keep = _mark(bg.shape, bg_idx, bg) & bg
    return fg_keep, bg_keep, fg_idx, bg_idx, fg_rank


def _inside(mask):
    """[N, A, 4] weights: 1 where ``mask``, else 0."""
    return torch.where(mask[..., None], 1.0, 0.0).expand(
        *mask.shape, 4).contiguous()


@simple_op("rpn_target_assign",
           ["Anchor", "GtBoxes", "IsCrowd", "ImInfo"],
           ["LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
            "BBoxInsideWeight"],
           optional=("IsCrowd", "ImInfo"), grad=None)
def _rpn_target_assign(ctx, anchors, gt, is_crowd, im_info, attrs):
    """Anchor→gt matching for RPN training (rpn_target_assign_op.cc).
    anchors [A,4]; gt [N,G,4] zero-padded.  Per-anchor labels: 1 fg, 0 bg,
    -1 ignore; the subsample keeps the best-IoU fg and lowest-IoU bg (the
    reference samples randomly).  Outputs are [N,A,...] dense."""
    pos_thresh = float(attrs.get("rpn_positive_overlap", 0.7))
    neg_thresh = float(attrs.get("rpn_negative_overlap", 0.3))
    batch_per_im = int(attrs.get("rpn_batch_size_per_im", 256))
    fg_frac = float(attrs.get("rpn_fg_fraction", 0.5))
    a = anchors.float()
    n_fg = int(batch_per_im * fg_frac)
    n_bg = batch_per_im - n_fg
    g = gt.float()
    iou = torch.where(_valid_gt(g)[:, None, :], iou_matrix(a, g, False),
                      0.0)                                       # [N,A,G]
    best = torch.amax(iou, dim=2)
    # anchors that are argmax for some gt are fg regardless of threshold
    gt_best = torch.amax(iou, dim=1, keepdim=True)
    is_gt_best = torch.any((iou >= gt_best - 1e-6) & (gt_best > 0), dim=2)
    fg = (best >= pos_thresh) | is_gt_best
    bg = best < neg_thresh
    fg_keep, bg_keep, *_ = _subsample(fg, bg, best, n_fg, n_bg)
    labels = torch.where(fg_keep, 1, torch.where(bg_keep, 0, -1)).to(
        torch.int32)
    match = torch.argmax(iou, dim=2)
    inw = _inside(fg_keep)
    tgt = _encode_deltas(a, take_rows(g, match)) * inw
    loc_index = torch.argsort(-labels, dim=1, stable=True)  # fg first
    score_index = torch.argsort(torch.where(labels >= 0, 0, 1), dim=1,
                                stable=True)
    return (loc_index.to(torch.int32), score_index.to(torch.int32), labels,
            tgt, inw)


@simple_op("retinanet_target_assign",
           ["Anchor", "GtBoxes", "GtLabels", "IsCrowd", "ImInfo"],
           ["LocationIndex", "ScoreIndex", "TargetLabel", "TargetBBox",
            "BBoxInsideWeight", "ForegroundNumber"],
           optional=("IsCrowd", "ImInfo"), grad=None)
def _retinanet_target_assign(ctx, anchors, gt, gt_labels, is_crowd, im_info,
                             attrs):
    """RetinaNet anchor assignment (retinanet_target_assign_op.cc): every
    anchor gets a class label (0 = background, -1 = ignore band); no
    subsampling (focal loss handles imbalance)."""
    pos_thresh = float(attrs.get("positive_overlap", 0.5))
    neg_thresh = float(attrs.get("negative_overlap", 0.4))
    a = anchors.float()
    g = gt.float()
    n = g.shape[0]
    iou = torch.where(_valid_gt(g)[:, None, :], iou_matrix(a, g, False),
                      0.0)
    best = torch.amax(iou, dim=2)
    match = torch.argmax(iou, dim=2)
    fg = best >= pos_thresh
    bg = best < neg_thresh
    gl = torch.gather(gt_labels.reshape(n, -1), 1, match).to(torch.int32)
    lbl = torch.where(fg, gl, torch.where(bg, 0, -1).to(torch.int32))
    inw = _inside(fg)
    tgt = _encode_deltas(a, take_rows(g, match)) * inw
    fgnum = torch.sum(fg.to(torch.int32), dim=1, keepdim=True).to(
        torch.int32)
    loc_index = torch.argsort(-(lbl > 0).to(torch.int32), dim=1, stable=True)
    score_index = torch.argsort((lbl < 0).to(torch.int32), dim=1,
                                stable=True)
    return (loc_index.to(torch.int32), score_index.to(torch.int32), lbl,
            tgt, inw, fgnum)


@simple_op("generate_proposal_labels",
           ["RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo"],
           ["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
            "BboxOutsideWeights"],
           optional=("IsCrowd", "ImInfo"), grad=None)
def _generate_proposal_labels(ctx, rois, gt_classes, is_crowd, gt_boxes,
                              im_info, attrs):
    """Sample RoIs for the RCNN head (generate_proposal_labels_op.cc).
    rois [N,R,4]; gt_boxes [N,G,4]; gt_classes [N,G].  Deterministic
    best-IoU sampling to batch_size_per_im rois an image; the bbox
    targets are class-agnostic, 4-dim."""
    batch_per_im = int(attrs.get("batch_size_per_im", 64))
    fg_frac = float(attrs.get("fg_fraction", 0.25))
    fg_thresh = float(attrs.get("fg_thresh", 0.5))
    bg_hi = float(attrs.get("bg_thresh_hi", 0.5))
    bg_lo = float(attrs.get("bg_thresh_lo", 0.0))
    n_fg = int(batch_per_im * fg_frac)
    n_bg = batch_per_im - n_fg
    n = rois.shape[0]
    g = gt_boxes.float()
    iou = torch.where(_valid_gt(g)[:, None, :],
                      iou_matrix(rois.float(), g, False), 0.0)
    best = torch.amax(iou, dim=2)
    match = torch.argmax(iou, dim=2)
    fg = best >= fg_thresh
    bg = (best < bg_hi) & (best >= bg_lo)
    fg_keep, _, fg_idx, bg_idx, fg_rank = _subsample(fg, bg, best, n_fg,
                                                     n_bg)
    sel = torch.cat([fg_idx, bg_idx], dim=1)            # [N, batch_per_im]
    sel_fg = torch.cat([torch.gather(fg_rank, 1, fg_idx) > _NEG / 2,
                        torch.zeros_like(bg_idx, dtype=torch.bool)], dim=1)
    out_rois = take_rows(rois, sel)
    msel = torch.gather(match, 1, sel)
    gc = torch.gather(gt_classes.reshape(n, -1), 1, msel).to(torch.int32)
    lbl = torch.where(sel_fg, gc, 0).to(torch.int32)
    inw = _inside(sel_fg)
    tgt = _encode_deltas(out_rois.float(), take_rows(g, msel)) * inw
    return out_rois, lbl, tgt, inw, inw


def _linspace01(res, device):
    """``jnp.linspace(0, 1, res)`` bit for bit: i / (res - 1), the last
    point 1 exactly."""
    if res == 1:
        return torch.zeros((1,), dtype=torch.float32, device=device)
    step = torch.arange(res - 1, dtype=torch.float32, device=device) \
        / float(res - 1)
    return torch.cat([step, torch.ones((1,), dtype=torch.float32,
                                       device=device)])


@simple_op("generate_mask_labels",
           ["ImInfo", "GtClasses", "IsCrowd", "GtSegms", "Rois",
            "LabelsInt32"],
           ["MaskRois", "RoiHasMaskInt32", "MaskInt32"],
           optional=("ImInfo", "IsCrowd"), grad=None)
def _generate_mask_labels(ctx, im_info, gt_classes, is_crowd, gt_segms,
                          rois, labels, attrs):
    """Crop and resize gt masks to fg rois (generate_mask_labels_op.cc).
    gt_segms are dense bitmaps [N, G, H, W] (the reference takes
    polygons; rasterize on the host first).  Each fg roi trains against
    the mask of its highest-IoU gt instance, the gt box taken as the
    mask's bounding extent.  Output masks [N, R, resolution²] int32."""
    res = int(attrs.get("resolution", 14))
    dev = gt_segms.device
    n, g_n, hh, ww = gt_segms.shape
    r_n = rois.shape[1]
    gm = gt_segms.float()
    ys = torch.arange(hh, dtype=torch.float32, device=dev)[None, None, :,
                                                             None]
    xs = torch.arange(ww, dtype=torch.float32, device=dev)[None, None, None,
                                                             :]
    present = gm > 0.5
    big = 1e9
    gboxes = torch.stack(
        [torch.amin(torch.where(present, xs, big), dim=(2, 3)),
         torch.amin(torch.where(present, ys, big), dim=(2, 3)),
         torch.amax(torch.where(present, xs, -big), dim=(2, 3)),
         torch.amax(torch.where(present, ys, -big), dim=(2, 3))], dim=-1)
    valid_g = torch.any(present, dim=(2, 3))
    r = rois.float()
    iou = torch.where(valid_g[:, None, :], iou_matrix(r, gboxes, False),
                      -1.0)                                    # [N, R, G]
    gi = torch.argmax(iou, dim=2)
    lin = _linspace01(res, dev)
    sy = lin * (r[..., 3:4] - r[..., 1:2]) + r[..., 1:2]       # [N, R, res]
    sx = lin * (r[..., 2:3] - r[..., 0:1]) + r[..., 0:1]
    yy = torch.clamp(torch.round(sy), 0, hh - 1).long()
    xx = torch.clamp(torch.round(sx), 0, ww - 1).long()
    bi = torch.arange(n, device=dev)[:, None, None, None]
    m = gm[bi, gi[:, :, None, None], yy[..., :, None], xx[..., None, :]]
    lbl = labels.reshape(n, r_n)
    m = torch.where((lbl > 0)[:, :, None, None], m, 0.0)
    masks = (m > 0.5).to(torch.int32).reshape(n, r_n, res * res)
    return rois, (lbl > 0).to(torch.int32), masks


@simple_op("ssd_loss_op", ["Location", "Confidence", "GtBox", "GtLabel",
                           "PriorBox", "PriorBoxVar"],
           ["Loss"], optional=("PriorBoxVar",),
           no_grad_inputs=("GtBox", "GtLabel", "PriorBox", "PriorBoxVar"))
def _ssd_loss(ctx, loc, conf, gt_box, gt_label, prior, prior_var, attrs):
    """SSD multibox loss (the reference composes it in python
    detection.py ssd_loss; fused here as in the JAX package): per-prior
    matching, smooth-L1 loc loss on positives, softmax conf loss with
    hard-negative mining at neg_pos_ratio.  loc [N,P,4], conf [N,P,C],
    gt [N,G,4], gt_label [N,G,1] → [N, 1], computed in fp32.  The
    mining threshold (the negatives' loss at rank neg_ratio·npos) is
    gathered on the device from a descending sort; it is a comparison
    only, so the sort sees the losses detached."""
    overlap_t = float(attrs.get("overlap_threshold", 0.5))
    neg_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    loc_w = float(attrs.get("loc_loss_weight", 1.0))
    conf_w = float(attrs.get("conf_loss_weight", 1.0))
    bg_label = int(attrs.get("background_label", 0))
    normalize = bool(attrs.get("normalize", True))
    p = prior.float()
    l, c, g = loc.float(), conf.float(), gt_box.float()
    n = g.shape[0]
    iou = torch.where(_valid_gt(g)[:, None, :], iou_matrix(p, g, True),
                      0.0)                                       # [N,P,G]
    best = torch.amax(iou, dim=2)
    match = torch.argmax(iou, dim=2)
    pos = best >= overlap_t
    npos = torch.clamp(torch.sum(pos, dim=1, dtype=torch.int32), min=1)
    tgt = _encode_deltas(p, take_rows(g, match))
    diff = l - tgt
    sl1 = torch.where(torch.abs(diff) < 1.0, 0.5 * torch.square(diff),
                      torch.abs(diff) - 0.5)
    loc_loss = torch.sum(torch.where(pos[..., None], sl1, 0.0), dim=(1, 2))
    gl = torch.gather(gt_label.reshape(n, -1).long(), 1, match)
    labels = torch.where(pos, gl, bg_label)
    logp = torch.log_softmax(c, dim=-1)
    ce = -torch.gather(logp, 2, labels[..., None])[..., 0]
    # hard negative mining: keep the neg_ratio*npos highest-loss negatives
    neg_rank = torch.where(pos, _NEG, ce.detach())
    k = neg_rank.shape[1]
    sorted_neg, _ = torch.sort(neg_rank, dim=1, descending=True)
    n_neg = torch.clamp((npos.float() * neg_ratio).to(torch.int32),
                        max=k - 1)
    thresh = torch.gather(sorted_neg, 1, n_neg[:, None].long())
    neg_keep = ~pos & (ce > thresh)
    conf_loss = torch.sum(torch.where(pos | neg_keep, ce, 0.0), dim=1)
    total = loc_w * loc_loss + conf_w * conf_loss
    if normalize:
        total = total / npos.float()
    return total[:, None]


@simple_op("yolov3_loss", ["X", "GTBox", "GTLabel", "GTScore"],
           ["Loss", "ObjectnessMask", "GTMatchMask"],
           optional=("GTScore",), no_grad_inputs=("GTBox", "GTLabel",
                                                  "GTScore"))
def _yolov3_loss(ctx, x, gt_box, gt_label, gt_score, attrs):
    """YOLOv3 training loss (yolov3_loss_op.h): coordinate (sigmoid/exp
    parametrization), objectness with ignore_thresh, and class losses.
    x [N, A*(5+C), H, W]; gt_box [N, B, 4] (cx,cy,w,h normalized),
    gt_label [N, B] → Loss [N], ObjectnessMask and GTMatchMask
    [N, A, H, W] int32.  Each gt's targets land in its cell of its best
    anchor by scatter (max for objectness, add for the rest), as the
    JAX package's ``.at[]`` updates do."""
    anchors = [int(v) for v in attrs["anchors"]]
    mask_idx = [int(v) for v in attrs.get("anchor_mask",
                                          list(range(len(anchors) // 2)))]
    class_num = int(attrs["class_num"])
    ignore_thresh = float(attrs.get("ignore_thresh", 0.7))
    downsample = int(attrs.get("downsample_ratio", 32))
    use_label_smooth = bool(attrs.get("use_label_smooth", True))
    na = len(mask_idx)
    n, _, h, w = x.shape
    dev = x.device
    in_w = downsample * w
    in_h = downsample * h
    x5 = x.reshape(n, na, 5 + class_num, h, w).float()
    aw = const_vector([anchors[2 * i] for i in mask_idx], dev)
    ah = const_vector([anchors[2 * i + 1] for i in mask_idx], dev)
    all_aw = const_vector(anchors[0::2], dev)
    all_ah = const_vector(anchors[1::2], dev)
    gb = gt_box.float()
    gl = gt_label.long()
    gs = gt_score.reshape(gl.shape).float() if gt_score is not None \
        else torch.ones(gl.shape, dtype=torch.float32, device=dev)

    # predicted boxes (normalized) for the objectness-ignore test
    gx = (torch.sigmoid(x5[:, :, 0])
          + torch.arange(w, dtype=torch.float32, device=dev)) / w
    gy = (torch.sigmoid(x5[:, :, 1])
          + torch.arange(h, dtype=torch.float32, device=dev)[:, None]) / h
    pw = torch.exp(torch.clamp(x5[:, :, 2], -10, 4)) \
        * aw[:, None, None] / in_w
    ph = torch.exp(torch.clamp(x5[:, :, 3], -10, 4)) \
        * ah[:, None, None] / in_h
    pred = torch.stack([gx - pw / 2, gy - ph / 2, gx + pw / 2, gy + ph / 2],
                       dim=-1)                                # [N,A,H,W,4]
    valid_gt = gb[..., 2] > 1e-6                              # [N, B]
    gbc = torch.stack([gb[..., 0] - gb[..., 2] / 2,
                       gb[..., 1] - gb[..., 3] / 2,
                       gb[..., 0] + gb[..., 2] / 2,
                       gb[..., 1] + gb[..., 3] / 2], dim=-1)
    # the ignore test is a comparison: no grad flows through it
    iou = iou_matrix(pred.detach().reshape(n, -1, 4), gbc,
                     True)                                    # [N,AHW,B]
    iou = torch.where(valid_gt[:, None, :], iou, 0.0)
    ignore = torch.amax(iou, dim=2).reshape(n, na, h, w) > ignore_thresh

    # responsibility: per gt, its best anchor by wh IoU over all anchors
    inter = (torch.minimum(gb[..., 2:3] * in_w, all_aw)
             * torch.minimum(gb[..., 3:4] * in_h, all_ah))
    union = (gb[..., 2:3] * in_w * gb[..., 3:4] * in_h
             + all_aw * all_ah - inter)
    best_a = torch.argmax(inter / torch.clamp(union, min=1e-6), dim=2)
    gi = torch.clamp((gb[..., 0] * w).to(torch.int32), 0, w - 1)
    gj = torch.clamp((gb[..., 1] * h).to(torch.int32), 0, h - 1)

    cells = na * h * w
    obj = torch.zeros((n, cells), dtype=torch.float32, device=dev)
    tx, ty, tw, th, box_scale = (torch.zeros_like(obj) for _ in range(5))
    tcls = torch.zeros((n, cells, class_num), dtype=torch.float32,
                       device=dev)
    classes = torch.arange(class_num, device=dev)
    for mi, global_a in enumerate(mask_idx):
        # gt_score weights each gt's contribution (mixup training)
        sel = (valid_gt & (best_a == global_a)).float() * gs
        idx = ((mi * h + gj) * w + gi).long()                   # [N, B]
        obj.scatter_reduce_(1, idx, sel, "amax")
        tx.scatter_add_(1, idx, sel * (gb[..., 0] * w - gi))
        ty.scatter_add_(1, idx, sel * (gb[..., 1] * h - gj))
        tw.scatter_add_(1, idx, sel * torch.log(torch.clamp(
            gb[..., 2] * in_w / anchors[2 * global_a], min=1e-6)))
        th.scatter_add_(1, idx, sel * torch.log(torch.clamp(
            gb[..., 3] * in_h / anchors[2 * global_a + 1], min=1e-6)))
        box_scale.scatter_add_(1, idx, sel * (2.0 - gb[..., 2] * gb[..., 3]))
        onehot = (gl[..., None] == classes).float() * sel[..., None]
        tcls.scatter_add_(1, idx[..., None].expand(-1, -1, class_num),
                          onehot)
    shape = (n, na, h, w)
    obj, tx, ty, tw, th, box_scale = (t.reshape(shape) for t in (
        obj, tx, ty, tw, th, box_scale))
    tcls = tcls.reshape(n, na, h, w, class_num)
    if use_label_smooth:
        delta = 1.0 / class_num
        tcls = torch.where(obj[..., None] > 0,
                           tcls * (1 - delta) + delta * 0.5 / class_num,
                           tcls)

    def bce(logit, target):
        return (torch.clamp(logit, min=0) - logit * target
                + torch.log1p(torch.exp(-torch.abs(logit))))

    on = obj > 0
    dims = (1, 2, 3)
    loss_xy = torch.sum(torch.where(on, box_scale * (
        bce(x5[:, :, 0], tx) + bce(x5[:, :, 1], ty)), 0.0), dim=dims)
    loss_wh = torch.sum(torch.where(on, box_scale * (
        torch.abs(x5[:, :, 2] - tw) + torch.abs(x5[:, :, 3] - th)), 0.0),
        dim=dims)
    obj_bce = bce(x5[:, :, 4], obj)
    loss_obj = (torch.sum(torch.where(on, obj_bce, 0.0), dim=dims)
                + torch.sum(torch.where(~on & ~ignore, obj_bce, 0.0),
                            dim=dims))
    loss_cls = torch.sum(torch.where(
        on[..., None], bce(x5[:, :, 5:].permute(0, 1, 3, 4, 2), tcls), 0.0),
        dim=(1, 2, 3, 4))
    return (loss_xy + loss_wh + loss_obj + loss_cls,
            (~ignore).to(torch.int32), on.to(torch.int32))


@simple_op("collect_fpn_proposals", ["MultiLevelRois*", "MultiLevelScores*"],
           ["FpnRois"], grad=None)
def _collect_fpn_proposals(ctx, rois_list, scores_list, attrs):
    """Concat per-level proposals, keep the global top post_nms_topN
    (collect_fpn_proposals_op.cc).  Inputs [N,Ri,4]/[N,Ri,1] → [N,K,4]."""
    post_n = int(attrs.get("post_nms_topN", 100))
    rois = torch.cat(list(rois_list), dim=1)
    scores = torch.cat([s.reshape(s.shape[0], -1) for s in scores_list],
                       dim=1)
    k = min(post_n, scores.shape[1])
    _, top_i = top_k(scores, k)
    out = take_rows(rois, top_i)
    if k < post_n:
        out = torch.nn.functional.pad(out, (0, 0, 0, post_n - k))
    return out


@simple_op("distribute_fpn_proposals", ["FpnRois"],
           ["MultiFpnRois*", "RestoreIndex"], grad=None)
def _distribute_fpn_proposals(ctx, rois, attrs):
    """Route each roi to its FPN level by scale
    (distribute_fpn_proposals_op.cc).  Static shape: every level output
    is [N, R, 4] with non-member rows zeroed; RestoreIndex [N, R] gives
    each roi's level."""
    min_level = int(attrs.get("min_level", 2))
    max_level = int(attrs.get("max_level", 5))
    refer_level = int(attrs.get("refer_level", 4))
    refer_scale = int(attrs.get("refer_scale", 224))
    nlevels = max_level - min_level + 1
    w = rois[..., 2] - rois[..., 0] + 1.0
    h = rois[..., 3] - rois[..., 1] + 1.0
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    outs = [torch.where((lvl == (min_level + i))[..., None], rois, 0.0)
            for i in range(nlevels)]
    return outs, lvl - min_level


@simple_op("box_decoder_and_assign",
           ["PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"],
           ["DecodeBox", "OutputAssignBox"],
           optional=("PriorBoxVar",), grad=None)
def _box_decoder_and_assign(ctx, prior, prior_var, target, score, attrs):
    """Decode per-class deltas and pick each roi's best-class box
    (box_decoder_and_assign_op.cc).  prior [M,4]; target [M, 4*C];
    score [M, C]."""
    m, c4 = target.shape
    c = c4 // 4
    p = prior.float()[:, None, :]
    t = target.float().reshape(m, c, 4)
    var = prior_var.float()[:, None, :] if prior_var is not None else None
    decoded = _decode_deltas(p, t, var)                   # [M, C, 4]
    best = torch.argmax(score, dim=1)
    assign = take_rows(decoded, best[:, None])[:, 0]
    return decoded.reshape(m, c4), assign


@simple_op("retinanet_detection_output",
           ["BBoxes*", "Scores*", "Anchors*", "ImInfo"],
           ["Out"], grad=None)
def _retinanet_detection_output(ctx, bboxes, scores, anchors, im_info,
                                attrs):
    """Multi-level decode + NMS (retinanet_detection_output_op.cc).
    Per level: bboxes [N,Mi,4] deltas, scores [N,Mi,C], anchors [Mi,4].
    Output [N, keep_top_k, 6] rows (label, score, box), label -1
    padding; labels count from 1."""
    score_thresh = float(attrs.get("score_threshold", 0.05))
    nms_top_k = int(attrs.get("nms_top_k", 100))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    deltas = torch.cat(list(bboxes), dim=1).float()
    scr = torch.cat(list(scores), dim=1).float()
    anch = torch.cat([a.reshape(-1, 4) for a in anchors], dim=0).float()
    c = scr.shape[2]
    boxes = _clip_to_image(_decode_deltas(anch, deltas), im_info.float())
    s = scr.transpose(1, 2)                                   # [N, C, M]
    s = torch.where(s > score_thresh, s, _NEG)
    labels = torch.arange(c, device=s.device).float() + 1
    return nms_rows(boxes, s, labels, nms_thresh, nms_top_k, keep_top_k,
                    False, neg=_NEG)


# ---------------------------------------------------------------------------
# deformable ops / position-sensitive pooling / perspective transform
# ---------------------------------------------------------------------------


@simple_op("deformable_conv", ["Input", "Offset", "Mask", "Filter"],
           ["Output"], optional=("Mask",))
def _deformable_conv(ctx, x, offset, mask, w, attrs):
    """Deformable conv v1/v2 (deformable_conv_op.cc): per-position learned
    sampling offsets (+ modulation mask in v2), bilinear sampling, then the
    weighted sum.  x [N,C,H,W]; offset [N, 2*G*kh*kw, Ho, Wo];
    mask [N, G*kh*kw, Ho, Wo]; w [Co, C/groups, kh, kw].  The offset
    groups are averaged, as in the JAX package."""
    strides = attrs.get("strides", [1, 1])
    paddings = attrs.get("paddings", [0, 0])
    dilations = attrs.get("dilations", [1, 1])
    groups = int(attrs.get("groups", 1))
    n, cin, hh, ww = x.shape
    co, _, kh, kw = w.shape
    dev = x.device
    ho = (hh + 2 * paddings[0] - dilations[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (ww + 2 * paddings[1] - dilations[1] * (kw - 1) - 1) // strides[1] + 1
    xp = torch.nn.functional.pad(x.float(), (paddings[1], paddings[1],
                                             paddings[0], paddings[0]))

    base_y = (torch.arange(ho, device=dev) * strides[0])[:, None, None, None]
    base_x = (torch.arange(wo, device=dev) * strides[1])[None, :, None, None]
    ky = (torch.arange(kh, device=dev) * dilations[0])[None, None, :, None]
    kx = (torch.arange(kw, device=dev) * dilations[1])[None, None, None, :]

    off = offset.float().reshape(n, -1, kh, kw, 2, ho, wo)
    off = off[:, 0] if off.shape[1] == 1 else torch.mean(off, dim=1)
    oy = off[:, :, :, 0].permute(0, 3, 4, 1, 2)          # [N,Ho,Wo,kh,kw]
    ox = off[:, :, :, 1].permute(0, 3, 4, 1, 2)
    ys = base_y + ky + oy
    xs = base_x + kx + ox
    bi = torch.arange(n, device=dev)[:, None, None, None, None]
    samp = bilinear_sample(xp, bi, ys, xs)                # [N,Ho,Wo,kh,kw,C]
    if mask is not None:
        m = mask.float().reshape(n, -1, kh, kw, ho, wo)
        m = m[:, 0] if m.shape[1] == 1 else torch.mean(m, dim=1)
        samp = samp * m.permute(0, 3, 4, 1, 2)[..., None]
    wf = w.float()
    if groups == 1:
        out = torch.einsum("nhwyxc,ocyx->nohw", samp, wf)
    else:
        cg = cin // groups
        samp_g = samp.reshape(*samp.shape[:-1], groups, cg)
        w_g = wf.reshape(groups, co // groups, cg, kh, kw)
        out = torch.einsum("nhwyxgc,gocyx->ngohw", samp_g, w_g).reshape(
            n, co, ho, wo)
    return out.to(x.dtype)


def _ps_coords(rois, scale, ph, pw, samples, dev):
    """Each RoI's scaled corners and its bins' sample coordinates:
    ys [R, ph, s] and xs [R, pw, s] (bin (i, j) at
    y1 + (i + (t + 0.5) / s) · bin_h), and the RoI heights and widths."""
    x1, y1, x2, y2 = (rois[:, i] * scale for i in range(4))
    rh = torch.clamp(y2 - y1, min=0.1) / ph
    rw = torch.clamp(x2 - x1, min=0.1) / pw
    iy = (torch.arange(samples, device=dev) + 0.5) / samples
    ys = y1[:, None, None] + (torch.arange(ph, dtype=torch.float32,
                                           device=dev)[:, None]
                              + iy) * rh[:, None, None]
    xs = x1[:, None, None] + (torch.arange(pw, dtype=torch.float32,
                                           device=dev)[:, None]
                              + iy) * rw[:, None, None]
    return ys, xs, y2 - y1, x2 - x1


@simple_op("psroi_pool", ["X", "ROIs", "RoisBatchIdx"], ["Out"],
           optional=("RoisBatchIdx",),
           no_grad_inputs=("ROIs", "RoisBatchIdx"))
def _psroi_pool(ctx, x, rois, batch_idx, attrs):
    """Position-sensitive RoI average pooling (psroi_pool_op.cc):
    input channels C = out_c * ph * pw; bin (i,j) pools its own channel
    group, 2×2 bilinear samples a bin.  rois [R, 4]."""
    out_c = int(attrs["output_channels"])
    ph = int(attrs.get("pooled_height", 7))
    pw = int(attrs.get("pooled_width", 7))
    scale = float(attrs.get("spatial_scale", 1.0))
    dev = x.device
    r = rois.shape[0]
    bi = roi_batch_index(batch_idx, r, dev)
    ys, xs, _, _ = _ps_coords(rois.float(), scale, ph, pw, 2, dev)
    # bin (i, j) reads channels (i * pw + j) * out_c + [0, out_c)
    ci = ((torch.arange(ph, device=dev)[:, None] * pw
           + torch.arange(pw, device=dev)) * out_c)[..., None] \
        + torch.arange(out_c, device=dev)                  # [ph, pw, out_c]
    v = bilinear_sample(x.float(), bi[:, None, None, None, None, None],
                        ys[:, :, None, None, :, None],
                        xs[:, None, :, None, None, :],
                        ci[None, :, :, :, None, None])  # [R,ph,pw,oc,s,s]
    out = torch.mean(v, dim=(4, 5)).permute(0, 3, 1, 2)
    return out.to(x.dtype)


@simple_op("deformable_psroi_pooling", ["Input", "ROIs", "Trans",
                                        "RoisBatchIdx"],
           ["Output", "TopCount"],
           optional=("Trans", "RoisBatchIdx"),
           no_grad_inputs=("ROIs", "RoisBatchIdx"))
def _deformable_psroi_pooling(ctx, x, rois, trans, batch_idx, attrs):
    """Deformable PS-RoI pooling (deformable_psroi_pooling_op.cc): each bin
    shifts by a learned normalized offset before sampling; without the
    position-sensitive channel count every bin reads the first out_c
    channels."""
    out_c = int(attrs.get("output_dim", attrs.get("output_channels", 1)))
    ph = int(attrs.get("pooled_height", 7))
    pw = int(attrs.get("pooled_width", 7))
    scale = float(attrs.get("spatial_scale", 1.0))
    trans_std = float(attrs.get("trans_std", 0.1))
    no_trans = bool(attrs.get("no_trans", trans is None))
    dev = x.device
    r = rois.shape[0]
    bi = roi_batch_index(batch_idx, r, dev)
    ys, xs, rh, rw = _ps_coords(rois.float(), scale, ph, pw, 2, dev)
    if no_trans or trans is None:  # no offsets: each bin where it lies
        ys = ys[:, :, None, :] + 0.0                     # [R, ph, 1, s]
        xs = xs[:, None, :, :] + 0.0                     # [R, 1, pw, s]
    else:
        part = trans.shape[2]
        tr = trans.float()
        pi = torch.clamp(torch.arange(ph, device=dev) * part // ph,
                         max=part - 1)
        pj = torch.clamp(torch.arange(pw, device=dev) * part // pw,
                         max=part - 1)
        t_y = tr[:, 0][:, pi][:, :, pj]                  # [R, ph, pw]
        t_x = tr[:, 1][:, pi][:, :, pj]
        dy = t_y * trans_std * rh[:, None, None]
        dx = t_x * trans_std * rw[:, None, None]
        ys = ys[:, :, None, :] + dy[..., None]           # [R, ph, pw, s]
        xs = xs[:, None, :, :] + dx[..., None]
    feat = x.float()
    oc = torch.arange(out_c, device=dev)
    if out_c * ph * pw == x.shape[1]:
        ci = ((torch.arange(ph, device=dev)[:, None] * pw
               + torch.arange(pw, device=dev)) * out_c)[..., None] + oc
    else:
        ci = oc.expand(ph, pw, out_c)
    v = bilinear_sample(feat, bi[:, None, None, None, None, None],
                        ys[:, :, :, None, :, None],
                        xs[:, :, :, None, None, :],
                        ci[None, :, :, :, None, None])
    out = torch.mean(v, dim=(4, 5)).permute(0, 3, 1, 2)
    cnt = torch.full((r, out_c, ph, pw), 4.0, dtype=torch.float32,
                     device=dev)
    return out.to(x.dtype), cnt


@simple_op("roi_perspective_transform", ["X", "ROIs", "RoisBatchIdx"],
           ["Out", "TransformMatrix"],
           optional=("RoisBatchIdx",),
           no_grad_inputs=("ROIs", "RoisBatchIdx"))
def _roi_perspective_transform(ctx, x, rois, batch_idx, attrs):
    """Warp quadrilateral rois to a fixed rectangle
    (roi_perspective_transform_op.cc).  rois [R, 8] four corners
    (x1..y4); RoisBatchIdx [R] maps each roi to its image (absent: image
    0); output [R, C, H, W] and each RoI's homography [R, 3, 3], solved
    from the 8x8 system (a + 1e-6·I) h = b."""
    oh = int(attrs.get("transformed_height", 8))
    ow = int(attrs.get("transformed_width", 8))
    scale = float(attrs.get("spatial_scale", 1.0))
    dev = x.device
    r = rois.shape[0]
    bi = roi_batch_index(batch_idx, r, dev)
    dst = rois.float().reshape(r, 4, 2) * scale
    src = ((0.0, 0.0), (ow - 1.0, 0.0), (ow - 1.0, oh - 1.0),
           (0.0, oh - 1.0))
    zero = torch.zeros((r,), dtype=torch.float32, device=dev)
    rows = []
    for k, (sx, sy) in enumerate(src):
        dx, dy = dst[:, k, 0], dst[:, k, 1]
        sx32, sy32 = float(np.float32(sx)), float(np.float32(sy))
        rows.append(torch.stack([zero + sx32, zero + sy32, zero + 1.0, zero,
                                 zero, zero, -sx32 * dx, -sy32 * dx], -1))
        rows.append(torch.stack([zero, zero, zero, zero + sx32, zero + sy32,
                                 zero + 1.0, -sx32 * dy, -sy32 * dy], -1))
    a = torch.stack(rows, dim=1)                              # [R, 8, 8]
    b = dst.reshape(r, 8)
    eye = torch.eye(8, dtype=torch.float32, device=dev)
    hvec = torch.linalg.solve(a + 1e-6 * eye, b)
    hmat = torch.cat([hvec, torch.ones((r, 1), dtype=torch.float32,
                                       device=dev)], dim=1).reshape(r, 3, 3)
    ys = torch.arange(oh, dtype=torch.float32, device=dev)[:, None].expand(
        oh, ow)
    xs = torch.arange(ow, dtype=torch.float32, device=dev)[None, :].expand(
        oh, ow)
    pts = torch.stack([xs, ys, torch.ones_like(xs)], dim=0).reshape(3, -1)
    warped = hmat @ pts                                       # [R, 3, oh*ow]
    den = torch.clamp(warped[:, 2], min=1e-6)
    wx = (warped[:, 0] / den).reshape(r, oh, ow)
    wy = (warped[:, 1] / den).reshape(r, oh, ow)
    out = bilinear_sample(x.float(), bi[:, None, None], wy, wx)
    return out.permute(0, 3, 1, 2).to(x.dtype), hmat


@simple_op("polygon_box_transform", ["Input"], ["Output"], grad=None)
def _polygon_box_transform(ctx, x, attrs):
    """EAST geometry head transform (polygon_box_transform_op.cc):
    activated offsets become absolute corner coords: even channels get
    4*col - v, odd channels 4*row - v; inactive (v<=0) positions pass 0."""
    n, c, h, w = x.shape
    col = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, None, :]
    row = torch.arange(h, dtype=x.dtype, device=x.device)[None, None, :, None]
    even = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    base = torch.where(even, 4 * col, 4 * row)
    return torch.where(x > 0, base - x, 0.0)


@simple_op("cvm", ["X", "CVM"], ["Y"], no_grad_inputs=("CVM",))
def _cvm(ctx, x, cvm, attrs):
    """Continuous-value model op for CTR features (cvm_op.cc): the first
    two columns are show/click counters; use_cvm keeps them
    log-transformed, otherwise they are stripped."""
    if bool(attrs.get("use_cvm", True)):
        show = torch.log(x[:, 0:1] + 1.0)
        click = torch.log(x[:, 1:2] + 1.0) - show
        return torch.cat([show, click, x[:, 2:]], dim=1)
    return x[:, 2:]


@simple_op("detection_map",
           ["DetectRes", "Label", "DetectLength", "LabelLength", "HasState",
            "PosCount", "TruePos", "FalsePos"],
           ["MAP", "AccumPosCount", "AccumTruePos", "AccumFalsePos"],
           grad=None,
           optional=("DetectLength", "LabelLength", "HasState", "PosCount",
                     "TruePos", "FalsePos"))
def _detection_map(ctx, det, lab, det_len, lab_len, has_state, pos_count,
                   true_pos, false_pos, attrs):
    """VOC mean average precision over one batch (detection_map_op.h, a
    CPU-only kernel in the reference; a host op in the JAX package).  It
    reads its inputs on the host, so it is in the executor's HOST_OPS
    and a plan holding it runs eagerly.  DetectRes [B, M, 6] (label,
    score, box); Label [B, N, 6] (label, difficult, box) or [B, N, 5];
    padded rows have label < 0, or pass the length inputs.  Cross-batch
    accumulation is ``fluid.metrics.DetectionMAP``'s: the state inputs
    raise."""
    if has_state is not None or pos_count is not None:
        raise NotImplementedError(
            "detection_map accumulation states are host metrics here — use "
            "fluid.metrics.DetectionMAP for cross-batch accumulation")
    if det.device.type == "meta":
        return torch.empty((1,), dtype=torch.float32, device="meta"), \
            None, None, None
    from paddle_tpu_torch.fluid.metrics import DetectionMAP

    d_all = det.detach().cpu().numpy()
    g_all = lab.detach().cpu().numpy()
    dl = det_len.detach().cpu().numpy() if det_len is not None else None
    gll = lab_len.detach().cpu().numpy() if lab_len is not None else None
    if d_all.ndim == 2:  # single-image convenience
        d_all, g_all = d_all[None], g_all[None]
    ap_version = attrs.get("ap_type", attrs.get("ap_version", "integral"))
    m = DetectionMAP(
        overlap_threshold=float(attrs.get("overlap_threshold", 0.3)),
        evaluate_difficult=bool(attrs.get("evaluate_difficult", True)),
        class_num=int(attrs["class_num"]) if "class_num" in attrs else None)
    has_difficult = g_all.shape[-1] == 6
    bg = attrs.get("background_label", 0)
    for b in range(d_all.shape[0]):
        d = d_all[b][:int(dl[b])] if dl is not None else d_all[b]
        g = g_all[b][:int(gll[b])] if gll is not None else g_all[b]
        d = d[d[:, 0] >= 0]
        g = g[g[:, 0] >= 0]
        if bg >= 0:  # the reference excludes the background class
            d = d[d[:, 0] != bg]
            g = g[g[:, 0] != bg]
        if has_difficult:
            m.update(d, g[:, 2:6], g[:, 0], difficult=g[:, 1] > 0.5)
        else:
            m.update(d, g[:, 1:5], g[:, 0])
    value = np.array([m.eval(ap_version)], dtype=np.float32)
    return torch.from_numpy(value).to(det.device), None, None, None
