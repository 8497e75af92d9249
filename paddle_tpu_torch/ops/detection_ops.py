"""Detection op lowerings (counterpart of ``paddle_tpu/ops/detection_ops.py``):
prior_box, density_prior_box, anchor_generator, box_coder, iou_similarity,
box_clip, bipartite_match, yolo_box, multiclass_nms, roi_align, roi_pool,
target_assign.

As in the JAX package, every output has a static shape: multiclass_nms
returns [N, keep_top_k, 6] rows padded with label -1 where the reference
emits a LoD tensor.

- Priors and anchors depend only on attrs and static shapes.  They are
  computed with numpy once per (feature shape, image shape, attrs,
  device) and kept (:func:`host_constant`): the first (eager) run makes
  them, and a captured CUDA graph only reads the kept tensor, so a
  replay makes no host-to-device copy.
- The JAX package's sequential scans (``_nms_keep``, bipartite_match)
  are Python loops over the positions, each step a few tensor ops over
  every image and class at once.  Nothing here reads a device value on
  the host or makes a shape from data, so the ops capture.
- ``lax.top_k`` puts the lower index first among equal scores; the
  port takes a stable descending sort (:func:`top_k`), which does the
  same on either device.  ``argmax`` takes the first of a tie in both.
- ROI ops gather from an NHWC view with advanced indexing; their derived
  grads scatter with atomics on CUDA where indices repeat, so those
  grads are not bit-reproducible on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.fluid.registry import simple_op

_NEG = -1e30

# host-made constants on a device, made on first use and kept:
# {(what, key..., device): tensors}
_CONSTANTS: dict = {}


def host_constant(key, device, make):
    """The tensors ``make()`` returns (numpy float32 arrays), on
    ``device``, made once a (``key``, device) and kept, so a captured
    graph reads them in place and a replay copies nothing from the
    host.  On the meta device (graph-build shape inference) only their
    shapes."""
    full = tuple(key) + (str(device),)
    got = _CONSTANTS.get(full)
    if got is None:
        arrays = make()
        if torch.device(device).type == "meta":
            got = tuple(torch.empty(a.shape, dtype=torch.float32,
                                    device="meta") for a in arrays)
        else:
            got = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in arrays)
        _CONSTANTS[full] = got
    return got


def const_vector(values, device):
    """A kept float32 vector of ``values`` on ``device``."""
    vals = tuple(float(v) for v in values)
    return host_constant(("vector", vals), device,
                         lambda: (np.asarray(vals, np.float32),))[0]


def top_k(x, k, dim=-1):
    """``lax.top_k`` along ``dim``: the k largest, the lower index first
    among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)


def take_rows(x, idx):
    """``x`` [..., M, D] at rows ``idx`` [..., k] → [..., k, D] (the
    leading dims of ``x`` broadcast to those of ``idx``)."""
    lead = idx.shape[:-1]
    src = x.expand(*lead, *x.shape[-2:])
    return torch.gather(src, -2, idx.unsqueeze(-1).expand(
        *idx.shape, x.shape[-1]))


def _expand_aspect_ratios(ars, flip):
    """prior_box_op.h:28 ExpandAspectRatios: prepend 1.0, dedupe, add 1/ar
    when flip."""
    out = [1.0]
    for ar in ars:
        if any(abs(ar - o) < 1e-6 for o in out):
            continue
        out.append(float(ar))
        if flip:
            out.append(1.0 / float(ar))
    return out


def _prior_boxes_np(fh, fw, img_h, img_w, attrs):
    """Host numpy generation (prior_box_op.h:100-164)."""
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = _expand_aspect_ratios(attrs.get("aspect_ratios", [1.0]),
                                bool(attrs.get("flip", False)))
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or img_w / fw
    step_h = float(attrs.get("step_h", 0.0)) or img_h / fh
    offset = float(attrs.get("offset", 0.5))
    clip = bool(attrs.get("clip", False))
    mm_order = bool(attrs.get("min_max_aspect_ratios_order", False))

    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h

            def emit(bw, bh):
                boxes.append([(cx - bw) / img_w, (cy - bh) / img_h,
                              (cx + bw) / img_w, (cy + bh) / img_h])

            for s, mn in enumerate(min_sizes):
                if mm_order:
                    emit(mn / 2.0, mn / 2.0)
                    if max_sizes:
                        sq = np.sqrt(mn * max_sizes[s]) / 2.0
                        emit(sq, sq)
                    for ar in ars:
                        if abs(ar - 1.0) < 1e-6:
                            continue
                        emit(mn * np.sqrt(ar) / 2.0, mn / np.sqrt(ar) / 2.0)
                else:
                    for ar in ars:
                        emit(mn * np.sqrt(ar) / 2.0, mn / np.sqrt(ar) / 2.0)
                    if max_sizes:
                        sq = np.sqrt(mn * max_sizes[s]) / 2.0
                        emit(sq, sq)
    num_priors = len(ars) * len(min_sizes) + len(max_sizes)
    arr = np.asarray(boxes, np.float32).reshape(fh, fw, num_priors, 4)
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          (fh, fw, num_priors, 4)).copy()
    return arr, var


def _attr_key(attrs, names):
    def one(v):
        return tuple(one(x) for x in v) if isinstance(v, (list, tuple)) \
            else v
    return tuple((n, one(attrs.get(n))) for n in names)


_PRIOR_ATTRS = ("min_sizes", "max_sizes", "aspect_ratios", "variances",
                "flip", "step_w", "step_h", "offset", "clip",
                "min_max_aspect_ratios_order")


@simple_op("prior_box", ["Input", "Image"], ["Boxes", "Variances"], grad=None)
def _prior_box(ctx, feat, image, attrs):
    """SSD prior boxes [H, W, num_priors, 4] (normalized corners) and
    their variances, kept on the device (:func:`host_constant`)."""
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    return host_constant(
        ("prior_box", fh, fw, img_h, img_w, _attr_key(attrs, _PRIOR_ATTRS)),
        feat.device, lambda: _prior_boxes_np(fh, fw, img_h, img_w, attrs))


def _density_priors_np(fh, fw, img_h, img_w, attrs):
    fixed_sizes = [float(s) for s in attrs.get("fixed_sizes", [])]
    fixed_ratios = [float(r) for r in attrs.get("fixed_ratios", [1.0])]
    densities = [int(d) for d in attrs.get("densities",
                                           [1] * len(fixed_sizes))]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or img_w / fw
    step_h = float(attrs.get("step_h", 0.0)) or img_h / fh
    offset = float(attrs.get("offset", 0.5))
    clip = bool(attrs.get("clip", False))

    boxes = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * step_w
            cy = (h + offset) * step_h
            for size, density in zip(fixed_sizes, densities):
                for ratio in fixed_ratios:
                    bw = size * np.sqrt(ratio)
                    bh = size / np.sqrt(ratio)
                    shift = size / density
                    for di in range(density):
                        for dj in range(density):
                            c_x = cx - size / 2.0 + shift / 2.0 + dj * shift
                            c_y = cy - size / 2.0 + shift / 2.0 + di * shift
                            boxes.append([(c_x - bw / 2.0) / img_w,
                                          (c_y - bh / 2.0) / img_h,
                                          (c_x + bw / 2.0) / img_w,
                                          (c_y + bh / 2.0) / img_h])
    n_pr = sum(d * d for d in densities) * len(fixed_ratios)
    arr = np.asarray(boxes, np.float32).reshape(fh, fw, n_pr, 4)
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          (fh, fw, n_pr, 4)).copy()
    return arr, var


@simple_op("density_prior_box", ["Input", "Image"], ["Boxes", "Variances"],
           grad=None)
def _density_prior_box(ctx, feat, image, attrs):
    """Densified priors (density_prior_box_op.h): for each fixed_size with
    density d, a d×d shifted grid of boxes per cell, scaled by
    fixed_ratios; kept on the device."""
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    img_h, img_w = int(image.shape[2]), int(image.shape[3])
    key = _attr_key(attrs, ("fixed_sizes", "fixed_ratios", "densities",
                            "variances", "step_w", "step_h", "offset",
                            "clip"))
    return host_constant(
        ("density_prior_box", fh, fw, img_h, img_w, key), feat.device,
        lambda: _density_priors_np(fh, fw, img_h, img_w, attrs))


def _anchors_np(fh, fw, attrs):
    sizes = [float(s) for s in attrs.get("anchor_sizes",
                                         [64.0, 128.0, 256.0])]
    ars = [float(r) for r in attrs.get("aspect_ratios", [0.5, 1.0, 2.0])]
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    stride = [float(s) for s in attrs.get("stride", [16.0, 16.0])]
    offset = float(attrs.get("offset", 0.5))

    anchors = []
    for h in range(fh):
        for w in range(fw):
            cx = (w + offset) * stride[0]
            cy = (h + offset) * stride[1]
            for ar in ars:
                for size in sizes:
                    area = stride[0] * stride[1]
                    area_ratios = area / ar
                    base_w = np.round(np.sqrt(area_ratios))
                    base_h = np.round(base_w * ar)
                    scale_w = size / stride[0]
                    scale_h = size / stride[1]
                    half_w = 0.5 * scale_w * base_w
                    half_h = 0.5 * scale_h * base_h
                    anchors.append([cx - half_w, cy - half_h,
                                    cx + half_w, cy + half_h])
    n_anchors = len(sizes) * len(ars)
    arr = np.asarray(anchors, np.float32).reshape(fh, fw, n_anchors, 4)
    var = np.broadcast_to(np.asarray(variances, np.float32),
                          (fh, fw, n_anchors, 4)).copy()
    return arr, var


@simple_op("anchor_generator", ["Input"], ["Anchors", "Variances"],
           grad=None)
def _anchor_generator(ctx, feat, attrs):
    """RPN anchors (anchor_generator_op.h): per cell, len(sizes) *
    len(aspect_ratios) anchors in unnormalized corner coords; kept on
    the device."""
    fh, fw = int(feat.shape[2]), int(feat.shape[3])
    key = _attr_key(attrs, ("anchor_sizes", "aspect_ratios", "variances",
                            "stride", "offset"))
    return host_constant(("anchor_generator", fh, fw, key), feat.device,
                         lambda: _anchors_np(fh, fw, attrs))


def iou_matrix(x, y, normalized=True):
    """x [..., N, 4], y [..., M, 4] corner boxes → IoU [..., N, M]
    (iou_similarity_op.h), leading dims broadcast.  Each corner's
    overlap is taken on its own and the [..., N, M] temporaries are
    updated in place, so an NMS over [N, C, k, k] holds few of them.
    Not for inputs that need a grad (the in-place updates)."""
    eps = 0.0 if normalized else 1.0
    area_x = torch.clamp(x[..., 2] - x[..., 0] + eps, min=0) * \
        torch.clamp(x[..., 3] - x[..., 1] + eps, min=0)
    area_y = torch.clamp(y[..., 2] - y[..., 0] + eps, min=0) * \
        torch.clamp(y[..., 3] - y[..., 1] + eps, min=0)

    def overlap(hi, lo):
        t = torch.minimum(x[..., :, None, hi], y[..., None, :, hi])
        t.sub_(torch.maximum(x[..., :, None, lo], y[..., None, :, lo]))
        if eps:
            t.add_(eps)
        return t.clamp_(min=0)

    inter = overlap(2, 0).mul_(overlap(3, 1))
    union = (area_x[..., :, None] + area_y[..., None, :]).sub_(inter)
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10), 0.0)


@simple_op("iou_similarity", ["X", "Y"], ["Out"], grad=None)
def _iou_similarity(ctx, x, y, attrs):
    return iou_matrix(x.reshape(-1, 4), y.reshape(-1, 4),
                      bool(attrs.get("box_normalized", True)))


@simple_op("box_coder", ["PriorBox", "PriorBoxVar", "TargetBox"],
           ["OutputBox"], optional=("PriorBoxVar",), grad=None)
def _box_coder(ctx, prior, prior_var, target, attrs):
    """encode/decode_center_size (box_coder_op.h).  prior [M,4] corners;
    encode: target [N,4] → [N,M,4]; decode: target [N,M,4] → [N,M,4]
    (axis=0; axis=1 swaps the broadcast side)."""
    code_type = attrs.get("code_type", "encode_center_size")
    normalized = bool(attrs.get("box_normalized", True))
    axis = int(attrs.get("axis", 0))
    variance_attr = attrs.get("variance", [])
    eps = 0.0 if normalized else 1.0

    pw = prior[:, 2] - prior[:, 0] + eps
    ph = prior[:, 3] - prior[:, 1] + eps
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if prior_var is not None:
        var = prior_var  # [M,4]
    elif variance_attr:
        var = const_vector(variance_attr, prior.device).to(
            prior.dtype).expand(prior.shape)
    else:
        var = torch.ones_like(prior)

    if code_type.startswith("encode"):
        tw = target[:, 2] - target[:, 0] + eps
        th = target[:, 3] - target[:, 1] + eps
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / var[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / var[None, :, 1]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :])) / var[None, :, 2]
        oh = torch.log(torch.abs(th[:, None] / ph[None, :])) / var[None, :, 3]
        return torch.stack([ox, oy, ow, oh], dim=-1)

    if axis == 0:
        pw_, ph_, pcx_, pcy_, var_ = (pw[None, :], ph[None, :], pcx[None, :],
                                      pcy[None, :], var[None, :, :])
    else:
        pw_, ph_, pcx_, pcy_, var_ = (pw[:, None], ph[:, None], pcx[:, None],
                                      pcy[:, None], var[:, None, :])
    tcx = var_[..., 0] * target[..., 0] * pw_ + pcx_
    tcy = var_[..., 1] * target[..., 1] * ph_ + pcy_
    tw = torch.exp(var_[..., 2] * target[..., 2]) * pw_
    th = torch.exp(var_[..., 3] * target[..., 3]) * ph_
    return torch.stack([tcx - tw * 0.5, tcy - th * 0.5,
                        tcx + tw * 0.5 - eps, tcy + th * 0.5 - eps], dim=-1)


@simple_op("box_clip", ["Input", "ImInfo"], ["Output"], grad=None)
def _box_clip(ctx, boxes, im_info, attrs):
    """Clip boxes to image bounds (box_clip_op.h).  ImInfo [B, 3] =
    (h, w, scale); boxes [B, M, 4]."""
    shape = (-1,) + (1,) * (boxes.dim() - 2)
    h = (im_info[:, 0] / im_info[:, 2] - 1.0).reshape(shape)
    w = (im_info[:, 1] / im_info[:, 2] - 1.0).reshape(shape)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


@simple_op("bipartite_match", ["DistMat"], ["ColToRowMatchIndices",
                                            "ColToRowMatchDist"], grad=None)
def _bipartite_match(ctx, dist, attrs):
    """Greedy bipartite matching (bipartite_match_op.cc): min(N, M)
    rounds, each taking the global max of the [N, M] distance matrix,
    matching that (row, col) and nulling its row and col; then
    'per_prediction' matches leftover columns to their argmax row where
    dist > dist_threshold.  dist [B, N, M] (or [N, M]) → [B, M]."""
    match_type = attrs.get("match_type", "bipartite")
    thresh = float(attrs.get("dist_threshold", 0.5))
    squeeze = dist.dim() == 2
    if squeeze:
        dist = dist[None]
    b, n, m = dist.shape
    dev = dist.device
    d0 = dist.float()
    d = d0.clone()
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    match_idx = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    match_dist = torch.zeros((b, m), dtype=torch.float32, device=dev)
    for _ in range(min(n, m)):
        flat = d.reshape(b, n * m)
        best = torch.argmax(flat, dim=1)
        best_val = torch.gather(flat, 1, best[:, None])[:, 0]
        r = best // m
        c = best % m
        do = best_val > _NEG / 2
        hit = do[:, None] & (cols[None, :] == c[:, None])
        match_idx = torch.where(hit, r[:, None].to(torch.int32), match_idx)
        match_dist = torch.where(hit, best_val[:, None], match_dist)
        d = torch.where(do[:, None, None]
                        & ((rows[None, :, None] == r[:, None, None])
                           | (cols[None, None, :] == c[:, None, None])),
                        _NEG, d)
    if match_type == "per_prediction":
        row_best = torch.argmax(d0, dim=1).to(torch.int32)
        row_val = torch.amax(d0, dim=1)
        fill = (match_idx < 0) & (row_val > thresh)
        match_idx = torch.where(fill, row_best, match_idx)
        match_dist = torch.where(fill, row_val, match_dist)
    if squeeze:
        return match_idx[0], match_dist[0]
    return match_idx, match_dist


@simple_op("yolo_box", ["X", "ImgSize"], ["Boxes", "Scores"], grad=None)
def _yolo_box(ctx, x, img_size, attrs):
    """Decode YOLOv3 head (yolo_box_op.h): X [N, A*(5+C), H, W] →
    Boxes [N, A*H*W, 4] (corner, image scale), Scores [N, A*H*W, C].
    One input size, downsample * H, scales both box dims, and the grid
    size is H for both coordinates, as in the reference kernel."""
    anchors = [int(a) for a in attrs["anchors"]]
    class_num = int(attrs["class_num"])
    conf_thresh = float(attrs.get("conf_thresh", 0.01))
    downsample = int(attrs.get("downsample_ratio", 32))
    clip_bbox = bool(attrs.get("clip_bbox", True))
    na = len(anchors) // 2
    n, _, h, w = x.shape
    input_size = downsample * h
    dev = x.device

    x = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    aw = const_vector(anchors[0::2], dev)[None, :, None, None]
    ah = const_vector(anchors[1::2], dev)[None, :, None, None]

    bx = (torch.sigmoid(x[:, :, 0]) + gx) / h
    by = (torch.sigmoid(x[:, :, 1]) + gy) / h
    bw = torch.exp(x[:, :, 2]) * aw / input_size
    bh = torch.exp(x[:, :, 3]) * ah / input_size
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    # below conf_thresh the reference keeps both box and scores at zero;
    # its `if (conf < conf_thresh) continue` keeps equality
    keep = conf >= conf_thresh
    probs = torch.where(keep[:, :, None], probs, 0.0)

    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    x1 = (bx - bw / 2.0) * img_w
    y1 = (by - bh / 2.0) * img_h
    x2 = (bx + bw / 2.0) * img_w
    y2 = (by + bh / 2.0) * img_h
    if clip_bbox:
        x1 = torch.clamp(x1, min=0.0)
        y1 = torch.clamp(y1, min=0.0)
        x2 = torch.minimum(x2, img_w - 1.0)
        y2 = torch.minimum(y2, img_h - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)  # [N, A, H, W, 4]
    boxes = torch.where(keep[..., None], boxes, 0.0)
    boxes = boxes.reshape(n, na * h * w, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(n, na * h * w, class_num)
    return boxes.float(), scores.float()


def nms_keep(boxes, scores, iou_thresh, top_k_, normalized=True):
    """Greedy NMS over score-sorted candidates, batched over the leading
    dims: boxes [..., M, 4] (leading dims broadcast), scores [..., M] →
    (order [..., k] into the M boxes, kept [..., k] bool, the sorted
    scores [..., k]), k = min(top_k_, M).  The JAX package scans the k
    candidates; here a Python loop over them, four tensor ops a position
    over every leading index at once, so a captured run holds 4·k
    kernels for it."""
    m = boxes.shape[-2]
    k = min(top_k_, m)
    top_scores, order = top_k(scores, k)
    cand = take_rows(boxes, order)                      # [..., k, 4]
    # a candidate is suppressed by a kept higher-scoring one overlapping
    # it by more than iou_thresh; kept[j] for j >= i is False at step i
    over_t = (iou_matrix(cand, cand, normalized) > iou_thresh) \
        .movedim(-2, 0)                                 # [k, ..., k]
    valid_t = (top_scores > _NEG / 2).movedim(-1, 0).contiguous()
    kept_t = torch.zeros_like(valid_t)                  # [k, ...]
    kept = kept_t.movedim(0, -1)                        # a view of it
    for i in range(k):
        hit = torch.any(over_t[i] & kept, dim=-1)
        torch.logical_and(valid_t[i], hit.logical_not_(), out=kept_t[i])
    return order, kept, top_scores


def nms_rows(boxes, scores_c, labels, nms_thresh, nms_top_k, keep_top_k,
             normalized, neg=_NEG):
    """Per-class NMS and the cross-class top-k, batched over images:
    boxes [N, M, 4], scores_c [N, C, M] (already thresholded to ``neg``),
    labels [C] float → [N, keep_top_k, 6] rows (label, score, x1, y1,
    x2, y2), padded with label -1.  ``neg`` is the caller's sentinel
    score (the JAX modules differ: -1e30 here, -1e9 in the extra ops);
    the NMS loop itself tests against this module's."""
    n, c, m = scores_c.shape
    order, kept, top_s = nms_keep(boxes[:, None], scores_c, nms_thresh,
                                  nms_top_k, normalized)
    k = order.shape[-1]
    final_s = torch.where(kept & (top_s > neg / 2), top_s, neg)
    cat_s = final_s.reshape(n, c * k)
    cat_l = labels[None, :, None].expand(n, c, k).reshape(n, c * k)
    cat_b = take_rows(boxes[:, None], order).reshape(n, c * k, 4)
    kk = min(keep_top_k, c * k)
    sel_s, sel_i = top_k(cat_s, kk)
    valid = sel_s > neg / 2
    row = torch.cat(
        [torch.where(valid, torch.gather(cat_l, 1, sel_i), -1.0)[..., None],
         torch.where(valid, sel_s, 0.0)[..., None],
         torch.where(valid[..., None], take_rows(cat_b, sel_i), 0.0)],
        dim=-1)
    if kk < keep_top_k:
        pad = torch.zeros((n, keep_top_k - kk, 6), dtype=row.dtype,
                          device=row.device)
        pad[..., 0] = -1.0
        row = torch.cat([row, pad], dim=1)
    return row


@simple_op("multiclass_nms", ["BBoxes", "Scores"], ["Out"], grad=None)
def _multiclass_nms(ctx, bboxes, scores, attrs):
    """Per-class NMS + cross-class top-k (multiclass_nms_op.cc).

    bboxes [N, M, 4]; scores [N, C, M].  Static-shape output
    [N, keep_top_k, 6] rows (label, score, x1, y1, x2, y2), padded with
    label = -1 (the reference emits variable-length LoD instead).  Every
    image and class runs one NMS loop together; the IoU of each class's
    candidates is [N, C, k, k]."""
    bg = int(attrs.get("background_label", 0))
    score_thresh = float(attrs.get("score_threshold", 0.01))
    nms_top_k = int(attrs.get("nms_top_k", 400))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    keep_top_k = int(attrs.get("keep_top_k", 200))
    normalized = bool(attrs.get("normalized", True))
    n, c, m = scores.shape
    if keep_top_k < 0:
        keep_top_k = c * min(nms_top_k, m)
    s = scores.float()
    cls = torch.arange(c, device=s.device)
    s = torch.where((s > score_thresh) & (cls[None, :, None] != bg), s, _NEG)
    return nms_rows(bboxes.float(), s, cls.float(), nms_thresh, nms_top_k,
                    keep_top_k, normalized)


def bilinear_sample(x, bi, ys, xs, ci=None):
    """Bilinear samples of x [N, C, H, W] at image ``bi`` and float
    coords ``ys``, ``xs`` (all broadcastable to one shape S) → [*S, C]
    (the JAX package's ``_bilinear_sample`` over one image's [C, H, W],
    batched: one gather a corner from the NHWC view); with channel
    indices ``ci`` (broadcastable too) only those: → [*S]."""
    h, w = x.shape[2], x.shape[3]
    shape = torch.broadcast_shapes(
        bi.shape, ys.shape, xs.shape, *(() if ci is None else (ci.shape,)))
    ys, xs = ys.expand(shape), xs.expand(shape)
    bi = bi.expand(shape)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    ly = torch.clamp(ys - y0, 0.0, 1.0)
    lx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    if ci is None:
        nhwc = x.permute(0, 2, 3, 1)
        ly, lx = ly[..., None], lx[..., None]

        def at(yi, xi):
            return nhwc[bi, yi, xi]
    else:
        ci = ci.expand(shape)

        def at(yi, xi):
            return x[bi, ci, yi, xi]
    v00, v01 = at(y0i, x0i), at(y0i, x1i)
    v10, v11 = at(y1i, x0i), at(y1i, x1i)
    return (v00 * (1 - ly) * (1 - lx) + v01 * (1 - ly) * lx +
            v10 * ly * (1 - lx) + v11 * ly * lx)


def roi_batch_index(batch_idx, r, device):
    """RoisBatchIdx as an int64 [R] (absent: every RoI on image 0)."""
    if batch_idx is None:
        return torch.zeros((r,), dtype=torch.long, device=device)
    return batch_idx.reshape(-1).long()


@simple_op("roi_align", ["X", "ROIs", "RoisBatchIdx"], ["Out"],
           optional=("RoisBatchIdx",), no_grad_inputs=("ROIs", "RoisBatchIdx"))
def _roi_align(ctx, x, rois, batch_idx, attrs):
    """RoIAlign (roi_align_op.h): X [N,C,H,W], ROIs [R,4] (x1,y1,x2,y2 in
    image scale) → [R, C, ph, pw].  Average of sampling_ratio² bilinear
    samples per bin."""
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    ratio = int(attrs.get("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    r = rois.shape[0]
    dev = x.device
    bi = roi_batch_index(batch_idx, r, dev)
    rois = rois.float()
    x1, y1 = rois[:, 0] * scale, rois[:, 1] * scale
    x2, y2 = rois[:, 2] * scale, rois[:, 3] * scale
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w = rw / pw
    bin_h = rh / ph
    iy = (torch.arange(ratio, dtype=torch.float32, device=dev) + 0.5) / ratio
    gys = y1[:, None, None] + (torch.arange(
        ph, dtype=torch.float32, device=dev)[:, None] + iy[None, :]) \
        * bin_h[:, None, None]                         # [R, ph, ratio]
    gxs = x1[:, None, None] + (torch.arange(
        pw, dtype=torch.float32, device=dev)[:, None] + iy[None, :]) \
        * bin_w[:, None, None]                         # [R, pw, ratio]
    ys = gys[:, :, None, :, None]
    xs = gxs[:, None, :, None, :]
    vals = bilinear_sample(x, bi[:, None, None, None, None], ys, xs)
    out = torch.mean(vals, dim=(3, 4))                 # [R, ph, pw, C]
    return out.permute(0, 3, 1, 2).to(x.dtype)


@simple_op("roi_pool", ["X", "ROIs", "RoisBatchIdx"], ["Out", "Argmax"],
           optional=("RoisBatchIdx",), no_grad_inputs=("ROIs", "RoisBatchIdx"))
def _roi_pool(ctx, x, rois, batch_idx, attrs):
    """RoI max pooling (roi_pool_op.h) over a fixed 4×4 nearest-neighbour
    sample grid per bin (the JAX package's static-shape form of the
    quantized bin max)."""
    ph = int(attrs.get("pooled_height", 1))
    pw = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    samples = 4
    r = rois.shape[0]
    h, w = x.shape[2], x.shape[3]
    dev = x.device
    bi = roi_batch_index(batch_idx, r, dev)
    rois = rois.float()
    x1 = torch.round(rois[:, 0] * scale)
    y1 = torch.round(rois[:, 1] * scale)
    x2 = torch.round(rois[:, 2] * scale)
    y2 = torch.round(rois[:, 3] * scale)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    iy = (torch.arange(samples, dtype=torch.float32, device=dev) + 0.5) \
        / samples
    gys = y1[:, None, None] + (torch.arange(
        ph, dtype=torch.float32, device=dev)[:, None] + iy[None, :]) \
        * (rh / ph)[:, None, None]
    gxs = x1[:, None, None] + (torch.arange(
        pw, dtype=torch.float32, device=dev)[:, None] + iy[None, :]) \
        * (rw / pw)[:, None, None]
    ysi = torch.clamp(gys, 0, h - 1).long()[:, :, None, :, None]
    xsi = torch.clamp(gxs, 0, w - 1).long()[:, None, :, None, :]
    shape = (r, ph, pw, samples, samples)
    vals = x.permute(0, 2, 3, 1)[bi[:, None, None, None, None].expand(shape),
                                 ysi.expand(shape), xsi.expand(shape)]
    out = torch.amax(vals, dim=(3, 4))                 # [R, ph, pw, C]
    return out.permute(0, 3, 1, 2).to(x.dtype), None


@simple_op("target_assign", ["X", "MatchIndices", "NegIndices"],
           ["Out", "OutWeight"], optional=("NegIndices",), grad=None)
def _target_assign(ctx, x, match_indices, neg_indices, attrs):
    """Scatter per-row targets by match indices (target_assign_op.h):
    X [B, N, K], MatchIndices [B, M] → Out [B, M, K] with
    Out[b,m] = X[b, MatchIndices[b,m]] and weight 1 where matched,
    ``mismatch_value`` and weight 0 where unmatched.  NegIndices [B, P]
    (column indices padded with -1) marks hard negatives: those columns
    get Out = mismatch_value but weight 1."""
    mismatch = float(attrs.get("mismatch_value", 0.0))
    idx = match_indices.long()
    m = idx.shape[1]
    safe = torch.clamp(idx, min=0)
    out = torch.gather(x, 1, safe[:, :, None].expand(-1, -1, x.shape[2]))
    matched = (idx >= 0)[:, :, None]
    out = torch.where(matched, out, mismatch)
    weight = matched.float()
    if neg_indices is not None:
        ni = neg_indices.long()
        if ni.dim() == 1:
            ni = ni[None]
        cols = torch.arange(m, device=x.device)
        neg_mask = torch.any((ni[:, None, :] == cols[None, :, None])
                             & (ni[:, None, :] >= 0), dim=2)
        out = torch.where(neg_mask[:, :, None] & ~matched, mismatch, out)
        weight = torch.maximum(weight, neg_mask[:, :, None].float())
    return out, weight.expand(out.shape).to(x.dtype)
