"""The detection programs, written once for either package.

``paddle`` is the package a program is built with: ``paddle_tpu`` (the
JAX package) or ``paddle_tpu_torch`` (the port); this module imports
neither, so the port's tests and chip_smoke.py (phase 35) use it
without jax.

- :func:`build_mobilenet_ssd`: MobileNet-v1 SSD as the Paddle models
  repo's PaddleCV/ssd builds and trains it (``mobilenet_ssd.py``,
  ``train.py``): the backbone from the package's own
  ``models/mobilenet.py`` (``conv_bn``, ``depthwise_separable``, V1's
  schedule), the 19² (block 11, 512 channels) and 10² (block 13, 1024)
  maps and four extra blocks (1x1 then 3x3 stride 2) of (256, 512),
  (128, 256), (128, 256) and (64, 128) channels; ``multi_box_head``
  over the six maps with the published priors (1917 at 300²), the
  ``ssd_loss`` summed, RMSProp on ``piecewise_decay`` from 1e-3 with
  L2Decay(5e-5); the test program is ``clone(for_test=True)`` plus
  ``detection_output`` (NMS 0.45, top 400, keep 200).
- :func:`build_mini_ssd`: tests/test_ssd_workload.py's mini SSD.
- :func:`build_yolo_head`: a narrow two-scale YOLOv3 head (conv, batch
  norm and leaky ReLU 0.1 blocks as PaddleCV/yolov3 builds them, a
  ``resize_nearest`` x2 route concatenated with the stride-16 map,
  ``yolov3_loss`` at both scales).
"""

from __future__ import annotations

import importlib

import numpy as np

__all__ = ["SSD_MIN_SIZES", "SSD_MAX_SIZES", "SSD_ASPECT_RATIOS",
           "SSD_EXTRA_BLOCKS", "VOC_CLASSES", "SSD_MAX_BOXES",
           "YOLO_ANCHORS", "build_mobilenet_ssd", "ssd_batch",
           "build_mini_ssd", "mini_ssd_batch", "build_yolo_head",
           "yolo_batch", "ssd_lr_schedule", "YOLO_HEADS", "YOLO_NMS_ATTRS",
           "yolo_head_cases", "yolo_nms_inputs", "other_op_cases",
           "flatten_outputs", "run_lowering", "cotangents",
           "outputs_close"]

VOC_CLASSES = 21        # 20 VOC classes and the background
SSD_MAX_BOXES = 8       # ground-truth rows a synthetic image, padded
SSD_MIN_SIZES = [60.0, 105.0, 150.0, 195.0, 240.0, 285.0]
SSD_MAX_SIZES = [[], 150.0, 195.0, 240.0, 285.0, 300.0]
SSD_ASPECT_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                     [2.0, 3.0]]
# the extra blocks after block 13: (1x1 channels, 3x3 stride-2 channels)
SSD_EXTRA_BLOCKS = ((256, 512), (128, 256), (128, 256), (64, 128))
# PaddleCV/ssd train.py on VOC: 16551 images at b64 an epoch, the LR
# times 1, 0.5, 0.25, 0.1, 0.01 past epochs 40, 60, 80, 100
SSD_TRAIN_IMAGES, SSD_LR_EPOCHS = 16551, (40, 60, 80, 100)
SSD_LR_DECAY = (1.0, 0.5, 0.25, 0.1, 0.01)
# YOLOv3's nine COCO anchors (darknet yolov3.cfg)
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                156, 198, 373, 326]


def _mobilenet(paddle):
    return importlib.import_module(paddle.__name__ + ".models.mobilenet")


def ssd_lr_schedule(batch, lr=1e-3):
    """PaddleCV/ssd's piecewise boundaries (steps) and values."""
    iters = SSD_TRAIN_IMAGES // batch
    return ([e * iters for e in SSD_LR_EPOCHS],
            [lr * d for d in SSD_LR_DECAY])


def mobilenet_ssd_head(paddle, img, num_classes, scale=1.0):
    """The MobileNet-SSD network over ``img``: returns multi_box_head's
    (locs, confs, boxes, variances)."""
    fluid = paddle.fluid
    mob = _mobilenet(paddle)
    tower = mob.conv_bn(img, max(1, int(32 * scale)), 3, 2, 1)
    maps = []
    for i, (filters, stride) in enumerate(mob.V1_CFG):
        tower = mob.depthwise_separable(tower, filters, stride, scale=scale)
        if i in (10, 12):  # block 11 (19²) and block 13 (10²)
            maps.append(tower)
    for f1, f2 in SSD_EXTRA_BLOCKS:
        tower = mob.conv_bn(tower, max(1, int(f1 * scale)), 1, 1, 0)
        tower = mob.conv_bn(tower, max(1, int(f2 * scale)), 3, 2, 1)
        maps.append(tower)
    return fluid.layers.multi_box_head(
        inputs=maps, image=img, base_size=int(img.shape[2]),
        num_classes=num_classes, min_sizes=list(SSD_MIN_SIZES),
        max_sizes=list(SSD_MAX_SIZES),
        aspect_ratios=[list(a) for a in SSD_ASPECT_RATIOS], offset=0.5,
        flip=True)


def build_mobilenet_ssd(paddle, scale=1.0, image=300,
                        num_classes=VOC_CLASSES, batch=64, lr=1e-3,
                        max_boxes=SSD_MAX_BOXES):
    """MobileNet-SSD's training program and its test program.

    Returns dict(main, startup, test, loss, locs, confs, boxes,
    variances, det): ``det`` the test program's detection rows
    [N, 200, 6]."""
    fluid = paddle.fluid
    main, startup = fluid.Program(), fluid.Program()
    # one name scope for both programs: the test program's ops take
    # names the training program has not used
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            img = fluid.data("image", [-1, 3, image, image], False,
                             "float32")
            gt_box = fluid.data("gt_box", [-1, max_boxes, 4], False,
                                "float32")
            gt_label = fluid.data("gt_label", [-1, max_boxes, 1], False,
                                  "int32")
            locs, confs, boxes, variances = mobilenet_ssd_head(
                paddle, img, num_classes, scale)
            loss = fluid.layers.reduce_sum(fluid.layers.ssd_loss(
                locs, confs, gt_box, gt_label, boxes, variances))
            bounds, values = ssd_lr_schedule(batch, lr)
            fluid.optimizer.RMSProp(
                learning_rate=fluid.layers.piecewise_decay(bounds, values),
                regularization=fluid.regularizer.L2Decay(5e-5)).minimize(
                    loss)
        test = main.clone(for_test=True)
        with fluid.program_guard(test, fluid.Program()):
            det = fluid.layers.detection_output(
                locs, fluid.layers.softmax(confs), boxes, variances,
                nms_threshold=0.45, nms_top_k=400, keep_top_k=200)
    return dict(main=main, startup=startup, test=test, loss=loss,
                locs=locs, confs=confs, boxes=boxes, variances=variances,
                det=det)


def ssd_batch(batch, image=300, num_classes=VOC_CLASSES,
              max_boxes=SSD_MAX_BOXES, seed=0):
    """A synthetic seeded batch: images in [0, 1), 1 to max_boxes
    ground-truth boxes an image (normalized corners, 0.1-0.5 a side) of
    classes 1 to num_classes - 1, the padded rows zero (invalid: x2 is
    not above x1)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(batch, 3, image, image).astype(np.float32)
    box = np.zeros((batch, max_boxes, 4), np.float32)
    label = np.zeros((batch, max_boxes, 1), np.int32)
    for b in range(batch):
        k = rng.randint(1, max_boxes + 1)
        wh = rng.uniform(0.1, 0.5, (k, 2))
        xy = rng.uniform(0.0, 1.0, (k, 2)) * (1.0 - wh)
        box[b, :k] = np.concatenate([xy, xy + wh], axis=1)
        label[b, :k, 0] = rng.randint(1, num_classes, k)
    return {"image": img, "gt_box": box, "gt_label": label}


def build_mini_ssd(paddle, size=32):
    """tests/test_ssd_workload.py's mini SSD: three convs, a two-level
    multi_box_head, the ssd_loss's mean, Adam(2e-3); the test program
    the clone plus detection_output (score 0.1, NMS 0.45, keep 4)."""
    fluid = paddle.fluid
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard():  # one name scope for both programs
        with fluid.program_guard(main, startup):
            img = fluid.data("img", [-1, 1, size, size], False,
                             dtype="float32")
            gt_box = fluid.data("gt_box", [-1, 1, 4], False,
                                dtype="float32")
            gt_lbl = fluid.data("gt_lbl", [-1, 1, 1], False, dtype="int32")
            c1 = L.conv2d(img, 8, 3, stride=2, padding=1, act="relu")
            c2 = L.conv2d(c1, 16, 3, stride=2, padding=1, act="relu")
            c3 = L.conv2d(c2, 16, 3, stride=2, padding=1, act="relu")
            locs, confs, boxes, variances = L.multi_box_head(
                inputs=[c2, c3], image=img, base_size=size, num_classes=2,
                aspect_ratios=[[1.0], [1.0]], min_sizes=[8.0, 16.0],
                max_sizes=[16.0, 24.0], flip=False, clip=True, offset=0.5)
            loss = L.reduce_mean(L.ssd_loss(locs, confs, gt_box, gt_lbl,
                                            boxes, variances))
            fluid.optimizer.Adam(learning_rate=2e-3).minimize(loss)
        test = main.clone(for_test=True)
        with fluid.program_guard(test, fluid.Program()):
            det = L.detection_output(
                locs, L.softmax(confs), boxes, variances,
                nms_threshold=0.45, score_threshold=0.1, keep_top_k=4)
    return dict(main=main, startup=startup, test=test, loss=loss, det=det)


def mini_ssd_batch(rng, n=8, size=32):
    """tests/test_ssd_workload.py's batch: a bright 8x8 square in one of
    four quadrants, its 12x12 box, class 1."""
    imgs = np.zeros((n, 1, size, size), dtype="float32")
    gts = np.zeros((n, 1, 4), dtype="float32")
    labels = np.ones((n, 1, 1), dtype="int32")
    for i in range(n):
        q = rng.randint(0, 4)
        cy, cx = (8 if q < 2 else 24), (8 if q % 2 == 0 else 24)
        imgs[i, 0, cy - 4:cy + 4, cx - 4:cx + 4] = 1.0
        gts[i, 0] = [(cx - 6) / size, (cy - 6) / size,
                     (cx + 6) / size, (cy + 6) / size]
    return {"img": imgs, "gt_box": gts, "gt_lbl": labels}


def _conv_bn_leaky(fluid, x, filters, size, stride):
    """PaddleCV/yolov3's conv block: conv (no bias), batch norm, leaky
    ReLU 0.1."""
    conv = fluid.layers.conv2d(x, filters, size, stride=stride,
                               padding=(size - 1) // 2, bias_attr=False)
    return fluid.layers.leaky_relu(fluid.layers.batch_norm(conv), alpha=0.1)


def build_yolo_head(paddle, image=64, num_classes=3, max_boxes=6,
                    lr=1e-3):
    """A narrow two-scale YOLOv3: five stride-2 blocks (stride 32 at the
    last), the stride-32 head with anchor mask [6, 7, 8], a 1x1 route
    upsampled x2 by resize_nearest and concatenated with the stride-16
    map, the stride-16 head with mask [3, 4, 5]; the two yolov3_loss
    means summed, Momentum(lr, 0.9)."""
    fluid = paddle.fluid
    main, startup = fluid.Program(), fluid.Program()
    per = 3 * (5 + num_classes)
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.data("image", [-1, 3, image, image], False, "float32")
        gt_box = fluid.data("gt_box", [-1, max_boxes, 4], False, "float32")
        gt_label = fluid.data("gt_label", [-1, max_boxes], False, "int32")
        x = img
        maps = []
        for filters in (8, 16, 16, 32, 32):
            x = _conv_bn_leaky(fluid, x, filters, 3, 2)
            maps.append(x)
        losses = []
        head = fluid.layers.conv2d(x, per, 1)
        losses.append(fluid.layers.yolov3_loss(
            head, gt_box, gt_label, YOLO_ANCHORS, [6, 7, 8], num_classes,
            0.7, 32))
        route = _conv_bn_leaky(fluid, x, 16, 1, 1)
        up = fluid.layers.resize_nearest(route, scale=2)
        x2 = fluid.layers.concat([up, maps[3]], axis=1)
        x2 = _conv_bn_leaky(fluid, x2, 32, 3, 1)
        head2 = fluid.layers.conv2d(x2, per, 1)
        losses.append(fluid.layers.yolov3_loss(
            head2, gt_box, gt_label, YOLO_ANCHORS, [3, 4, 5], num_classes,
            0.7, 16))
        loss = fluid.layers.elementwise_add(
            fluid.layers.reduce_mean(losses[0]),
            fluid.layers.reduce_mean(losses[1]))
        fluid.optimizer.Momentum(learning_rate=lr,
                                 momentum=0.9).minimize(loss)
    return dict(main=main, startup=startup, loss=loss)


def yolo_batch(batch, image=64, num_classes=3, max_boxes=6, seed=0):
    """Synthetic seeded YOLO data: images in [0, 1), ground-truth boxes
    as (cx, cy, w, h) normalized, 1 to max_boxes an image (the padded
    rows zero), labels in [0, num_classes)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(batch, 3, image, image).astype(np.float32)
    box = np.zeros((batch, max_boxes, 4), np.float32)
    label = np.zeros((batch, max_boxes), np.int32)
    for b in range(batch):
        k = rng.randint(1, max_boxes + 1)
        wh = rng.uniform(0.05, 0.6, (k, 2))
        c = wh / 2 + rng.uniform(0.0, 1.0, (k, 2)) * (1.0 - wh)
        box[b, :k] = np.concatenate([c, wh], axis=1)
        label[b, :k] = rng.randint(0, num_classes, k)
    return {"image": img, "gt_box": box, "gt_label": label}


# ---------------------------------------------------------------------------
# the detection ops off the SSD path, each at one realistic shape, for
# chip_smoke.py phase 35's card-against-CPU checks (and the cuda tests)
# ---------------------------------------------------------------------------

# YOLOv3-608's three heads (darknet yolov3.cfg): (grid, anchor mask,
# downsample ratio, the channels of the upsampled route into the head)
YOLO_HEADS = ((19, [6, 7, 8], 32, 256), (38, [3, 4, 5], 16, 128),
              (76, [0, 1, 2], 8, None))
YOLO_BATCH, YOLO_IMAGE, YOLO_GT, COCO_CLASSES = 8, 608, 50, 80
# tolerances: 0 for indices, labels and masks; elementwise fp32 math
# 1e-6 of the reference's largest magnitude; 1e-5 where a reduction sums
# in another order or a grad scatters into repeated indices (atomics on
# the card)
ELEM_TOL, RED_TOL = 1e-6, 1e-5


def _rng(seed):
    return np.random.RandomState(seed)


def _corner_boxes(rng, lead, w, h, lo=0.05, hi=0.5):
    """Corner boxes [*lead, 4] in a w x h image, sides lo-hi of it."""
    wh = rng.uniform(lo, hi, tuple(lead) + (2,))
    xy = rng.uniform(0.0, 1.0, tuple(lead) + (2,)) * (1.0 - wh)
    box = np.concatenate([xy, xy + wh], -1) * np.array([w, h, w, h])
    return box.astype(np.float32)


def _yolo_gt(rng, batch, n_gt):
    """YOLOv3 ground truth: (cx, cy, w, h) normalized, n_gt an image of
    which a random tail is padding (zero rows), labels in [0, 80)."""
    box = np.zeros((batch, n_gt, 4), np.float32)
    for b in range(batch):
        k = rng.randint(n_gt // 2, n_gt + 1)
        wh = rng.uniform(0.02, 0.6, (k, 2))
        c = wh / 2 + rng.uniform(0.0, 1.0, (k, 2)) * (1.0 - wh)
        box[b, :k] = np.concatenate([c, wh], 1)
    label = rng.randint(0, COCO_CLASSES, (batch, n_gt)).astype(np.int32)
    return box, label


def yolo_head_cases(seed=11):
    """YOLOv3-608's head at b8 (the YOLOv3 paper's 608² input, darknet's
    anchors and masks, ignore_thresh 0.7, 50 ground-truth rows an
    image): yolov3_loss (with its grad) and yolo_box (80 classes) at
    each grid, and resize_nearest x2 (with its grad) of each route."""
    rng = _rng(seed)
    gt_box, gt_label = _yolo_gt(rng, YOLO_BATCH, YOLO_GT)
    cases = {}
    for grid, mask, down, route in YOLO_HEADS:
        x = (rng.randn(YOLO_BATCH, 3 * (5 + COCO_CLASSES), grid, grid)
             .astype(np.float32))
        cases[f"yolov3_loss_{grid}"] = (
            "yolov3_loss", [x, gt_box, gt_label, None],
            {"anchors": YOLO_ANCHORS, "anchor_mask": mask,
             "class_num": COCO_CLASSES, "ignore_thresh": 0.7,
             "downsample_ratio": down}, RED_TOL, RED_TOL)
        cases[f"yolo_box_{grid}"] = (
            "yolo_box", [x, np.full((YOLO_BATCH, 2), YOLO_IMAGE, np.int32)],
            {"anchors": [YOLO_ANCHORS[2 * i + j] for i in mask
                         for j in (0, 1)],
             "class_num": COCO_CLASSES, "conf_thresh": 0.005,
             "downsample_ratio": down}, ELEM_TOL, None)
        if route is not None:
            cases[f"resize_nearest_{grid}"] = (
                "nearest_interp",
                [rng.randn(YOLO_BATCH, route, grid, grid).astype(np.float32),
                 None], {"out_h": 2 * grid, "out_w": 2 * grid}, 0,
                ELEM_TOL)
    return cases


# YOLOv3's NMS (PaddleCV/yolov3 infer: valid_thresh 0.005, nms_topk 1000,
# keep_topk 100, nms_thresh 0.45, no background class), over the three
# heads' yolo_box outputs
YOLO_NMS_ATTRS = {"score_threshold": 0.005, "nms_top_k": 1000,
                  "keep_top_k": 100, "nms_threshold": 0.45,
                  "normalized": False, "background_label": -1}


def yolo_nms_inputs(box_outputs):
    """multiclass_nms's inputs from the three heads' yolo_box outputs
    [(boxes [N, Mi, 4], scores [N, Mi, C]), ...]: all boxes and the
    scores as [N, C, M]."""
    boxes = np.concatenate([b for b, _ in box_outputs], axis=1)
    scores = np.concatenate([s for _, s in box_outputs], axis=1)
    return [boxes, np.ascontiguousarray(scores.transpose(0, 2, 1))]


def _grid_anchors(fh, fw, sizes, ratios, stride):
    """anchor_generator's anchors [fh, fw, A, 4] (as numpy)."""
    from itertools import product

    out = []
    for h, w in product(range(fh), range(fw)):
        cx, cy = (w + 0.5) * stride, (h + 0.5) * stride
        for ar in ratios:
            for size in sizes:
                base_w = np.round(np.sqrt(stride * stride / ar))
                base_h = np.round(base_w * ar)
                hw = 0.5 * size / stride * base_w
                hh = 0.5 * size / stride * base_h
                out.append([cx - hw, cy - hh, cx + hw, cy + hh])
    return np.asarray(out, np.float32).reshape(fh, fw, -1, 4)


def other_op_cases(seed=12):
    """The two-stage, RetinaNet, deformable and long-tail ops, and the
    SSD ops off the training path, each at a shape its model gives it:
    Faster R-CNN's RPN and RCNN head on a 608x800 image (stride-16 map
    38x50, 15 anchors a cell), Mask R-CNN's mask labels, FPN's levels,
    RetinaNet's five levels on a 640² image (9 anchors a cell, 80
    classes), ResNet-50's DCNv2 stage-5 conv, R-FCN's position-sensitive
    pooling (7x7 bins, 81 classes), an OCR RoI warp, EAST's geometry
    map, a CTR model's CVM, and SSD-300's matching ops (b64, 1917
    priors, 8 ground-truth rows)."""
    rng = _rng(seed)
    cases = {}
    img_h, img_w = 608, 800
    fh, fw = img_h // 16, img_w // 16
    anchors = _grid_anchors(fh, fw, [32.0, 64.0, 128.0, 256.0, 512.0],
                            [0.5, 1.0, 2.0], 16.0)
    a_var = np.broadcast_to(np.float32([0.1, 0.1, 0.2, 0.2]),
                            anchors.shape).copy()
    n_a = anchors.shape[2]
    cases["anchor_generator"] = (
        "anchor_generator", [rng.randn(1, 8, fh, fw).astype(np.float32)],
        {"anchor_sizes": [32.0, 64.0, 128.0, 256.0, 512.0],
         "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0]}, 0,
        None)
    im_info = np.array([[img_h, img_w, 1.0]] * 2, np.float32)
    cases["generate_proposals"] = (
        "generate_proposals",
        [rng.randn(2, n_a, fh, fw).astype(np.float32),
         (rng.randn(2, 4 * n_a, fh, fw) * 0.2).astype(np.float32), im_info,
         anchors, a_var],
        {"pre_nms_topN": 6000, "post_nms_topN": 1000, "nms_thresh": 0.7,
         "min_size": 0.0}, ELEM_TOL, None)
    gt = _corner_boxes(rng, (2, 20), img_w, img_h, 0.05, 0.6)
    gt[:, 16:] = 0.0                          # padded rows
    gt_cls = rng.randint(1, 81, (2, 20)).astype(np.int32)
    cases["rpn_target_assign"] = (
        "rpn_target_assign", [anchors.reshape(-1, 4), gt, None, None],
        {"rpn_batch_size_per_im": 256, "rpn_fg_fraction": 0.5,
         "rpn_positive_overlap": 0.7, "rpn_negative_overlap": 0.3},
        ELEM_TOL, None)
    rois = _corner_boxes(rng, (2, 2000), img_w, img_h, 0.02, 0.5)
    cases["generate_proposal_labels"] = (
        "generate_proposal_labels", [rois, gt_cls, None, gt, None],
        {"batch_size_per_im": 512, "fg_fraction": 0.25, "fg_thresh": 0.5,
         "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0}, ELEM_TOL, None)
    seg = np.zeros((2, 8, img_h // 2, img_w // 2), np.int32)
    for b in range(2):
        for g in range(8):
            x1, y1, x2, y2 = (_corner_boxes(rng, (), img_w // 2, img_h // 2,
                                            0.1, 0.5)).astype(int)
            seg[b, g, y1:y2, x1:x2] = rng.rand(y2 - y1, x2 - x1) > 0.3
    cases["generate_mask_labels"] = (
        "generate_mask_labels",
        [None, gt_cls[:, :8], None, seg,
         _corner_boxes(rng, (2, 128), img_w // 2, img_h // 2, 0.05, 0.5),
         rng.randint(0, 81, (2, 128)).astype(np.int32)],
        {"resolution": 14}, 0, None)
    x16 = rng.randn(2, 256, 50, 50).astype(np.float32)
    rois16 = _corner_boxes(rng, (512,), 800, 800, 0.02, 0.6)
    rbi = rng.randint(0, 2, 512).astype(np.int32)
    cases["roi_align"] = (
        "roi_align", [x16, rois16, rbi],
        {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 1 / 16.0,
         "sampling_ratio": 2}, RED_TOL, RED_TOL)
    cases["roi_pool"] = (
        "roi_pool", [x16, rois16, rbi],
        {"pooled_height": 7, "pooled_width": 7,
         "spatial_scale": 1 / 16.0}, 0, RED_TOL)
    levels = [_corner_boxes(rng, (2, 2000), img_w, img_h, 0.01, 0.7)
              for _ in range(5)]
    cases["collect_fpn_proposals"] = (
        "collect_fpn_proposals",
        [levels, [rng.rand(2, 2000, 1).astype(np.float32)
                  for _ in range(5)]], {"post_nms_topN": 2000}, 0, None)
    cases["distribute_fpn_proposals"] = (
        "distribute_fpn_proposals", [levels[0]],
        {"min_level": 2, "max_level": 5, "refer_level": 4,
         "refer_scale": 224}, 0, None)
    cases["box_decoder_and_assign"] = (
        "box_decoder_and_assign",
        [rois[0, :1000], np.broadcast_to(np.float32([0.1, 0.1, 0.2, 0.2]),
                                         (1000, 4)).copy(),
         (rng.randn(1000, 81 * 4) * 0.3).astype(np.float32),
         rng.rand(1000, 81).astype(np.float32)], {}, ELEM_TOL, None)
    # RetinaNet on 640²: P3-P7 (strides 8-128), 9 anchors a cell
    r_levels = [(80, 8), (40, 16), (20, 32), (10, 64), (5, 128)]
    r_anchors = [_grid_anchors(s, s, [4.0 * st * 2 ** (i / 3.0)
                                      for i in range(3)],
                               [0.5, 1.0, 2.0], float(st)).reshape(-1, 4)
                 for s, st in r_levels]
    cases["retinanet_detection_output"] = (
        "retinanet_detection_output",
        [[(rng.randn(1, a.shape[0], 4) * 0.2).astype(np.float32)
          for a in r_anchors],
         [(rng.rand(1, a.shape[0], 80) ** 4).astype(np.float32)
          for a in r_anchors],
         r_anchors, np.array([[640, 640, 1.0]], np.float32)],
        {"score_threshold": 0.05, "nms_top_k": 1000, "keep_top_k": 100,
         "nms_threshold": 0.5}, ELEM_TOL, None)
    gt_r = _corner_boxes(rng, (2, 20), 640, 640, 0.05, 0.6)
    cases["retinanet_target_assign"] = (
        "retinanet_target_assign",
        [r_anchors[0], gt_r, rng.randint(1, 81, (2, 20, 1)).astype(np.int32),
         None, None], {"positive_overlap": 0.5, "negative_overlap": 0.4},
        ELEM_TOL, None)
    n_fl = r_anchors[0].shape[0]
    cases["sigmoid_focal_loss"] = (
        "sigmoid_focal_loss",
        [(rng.randn(n_fl, 80) * 2).astype(np.float32),
         rng.randint(-1, 81, (n_fl, 1)).astype(np.int32),
         np.array([1000], np.int32)], {"gamma": 2.0, "alpha": 0.25},
        ELEM_TOL, ELEM_TOL)
    cases["deformable_conv"] = (
        "deformable_conv",
        [rng.randn(2, 512, 19, 25).astype(np.float32),
         (rng.randn(2, 18, 19, 25) * 2).astype(np.float32),
         rng.rand(2, 9, 19, 25).astype(np.float32),
         (rng.randn(512, 512, 3, 3) * 0.02).astype(np.float32)],
        {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
         "groups": 1}, RED_TOL, RED_TOL)
    x_ps = rng.randn(1, 7 * 7 * 21, fh, fw).astype(np.float32)
    rois_ps = _corner_boxes(rng, (300,), img_w, img_h, 0.05, 0.6)
    cases["psroi_pool"] = (
        "psroi_pool", [x_ps, rois_ps, None],
        {"output_channels": 21, "pooled_height": 7, "pooled_width": 7,
         "spatial_scale": 1 / 16.0}, RED_TOL, RED_TOL)
    cases["deformable_psroi_pooling"] = (
        "deformable_psroi_pooling",
        [x_ps, rois_ps, (rng.randn(300, 2, 7, 7) * 0.5).astype(np.float32),
         None],
        {"output_dim": 21, "pooled_height": 7, "pooled_width": 7,
         "spatial_scale": 1 / 16.0, "trans_std": 0.1}, RED_TOL, RED_TOL)
    quads = np.concatenate([_corner_boxes(rng, (64,), 300, 300, 0.1, 0.4)
                            [:, [0, 1, 2, 1, 2, 3, 0, 3]]
                            + rng.uniform(-3, 3, (64, 8)).astype(
                                np.float32)], 0).astype(np.float32)
    cases["roi_perspective_transform"] = (
        "roi_perspective_transform",
        [rng.randn(2, 128, 75, 75).astype(np.float32), quads,
         rng.randint(0, 2, 64).astype(np.int32)],
        {"transformed_height": 8, "transformed_width": 32,
         "spatial_scale": 0.25}, RED_TOL, RED_TOL)
    cases["polygon_box_transform"] = (
        "polygon_box_transform", [rng.randn(4, 8, 128, 128).astype(
            np.float32)], {}, ELEM_TOL, None)
    cases["cvm"] = (
        "cvm", [np.abs(rng.randn(4096, 11)).astype(np.float32),
                rng.rand(4096, 2).astype(np.float32)], {"use_cvm": True},
        ELEM_TOL, ELEM_TOL)
    cases["leaky_relu"] = (
        "leaky_relu", [rng.randn(8, 512, 19, 19).astype(np.float32)],
        {"alpha": 0.1}, 0, ELEM_TOL)
    cases["bilinear_interp"] = (
        "bilinear_interp", [rng.randn(2, 256, 38, 50).astype(np.float32),
                            None], {"out_h": 76, "out_w": 100}, ELEM_TOL,
        RED_TOL)
    # SSD-300's matching ops at b64 (1917 priors, 8 ground-truth rows)
    priors = _corner_boxes(rng, (1917,), 1.0, 1.0, 0.05, 0.6)
    gt_s = _corner_boxes(rng, (64, 8), 1.0, 1.0, 0.1, 0.5)
    cases["iou_similarity"] = ("iou_similarity", [gt_s[0], priors],
                               {"box_normalized": True}, ELEM_TOL, None)
    dist = rng.rand(64, 8, 1917).astype(np.float32)
    cases["bipartite_match"] = ("bipartite_match", [dist],
                                {"match_type": "per_prediction",
                                 "dist_threshold": 0.5}, 0, None)
    match = rng.randint(-1, 8, (64, 1917)).astype(np.int32)
    cases["target_assign"] = (
        "target_assign", [gt_s, match, rng.randint(-1, 1917, (64, 64))
                          .astype(np.int32)], {"mismatch_value": 0.0}, 0,
        None)
    cases["mine_hard_examples"] = (
        "mine_hard_examples",
        [rng.rand(64, 1917).astype(np.float32), None, match,
         rng.rand(64, 1917).astype(np.float32)],
        {"mining_type": "max_negative", "neg_pos_ratio": 3.0,
         "neg_dist_threshold": 0.5}, 0, None)
    cases["box_coder_encode"] = (
        "box_coder", [priors, None, gt_s[0]],
        {"code_type": "encode_center_size", "variance": [0.1, 0.1, 0.2,
                                                         0.2]},
        ELEM_TOL, None)
    cases["box_clip"] = (
        "box_clip", [_corner_boxes(rng, (2, 1000), 900, 700, 0.05, 0.6),
                     np.array([[600, 800, 1.0], [500, 750, 1.25]],
                              np.float32)], {}, 0, None)
    cases["density_prior_box"] = (
        "density_prior_box",
        [rng.randn(1, 8, 38, 38).astype(np.float32),
         rng.randn(1, 3, 300, 300).astype(np.float32)],
        {"fixed_sizes": [30.0, 60.0], "fixed_ratios": [1.0, 2.0],
         "densities": [4, 2], "clip": True}, 0, None)
    return cases


def flatten_outputs(out):
    """An op lowering's outputs as a flat list (variadic slots opened)."""
    flat = []
    for o in (out if isinstance(out, tuple) else (out,)):
        flat.extend(o if isinstance(o, (list, tuple)) else [o])
    return flat


def run_lowering(registry, op_type, inputs, attrs, device):
    """The lowering of ``op_type`` in ``registry`` (the port's registry
    module) on numpy ``inputs`` (lists for a variadic slot) moved to
    ``device``: its outputs, flat, as numpy arrays (None kept)."""
    import torch

    ctx = registry.LowerContext(device)
    vals = [None if a is None else
            [torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in a] if isinstance(a, list)
            else torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in inputs]
    out = registry.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return [None if t is None else t.detach().cpu().numpy()
            for t in flatten_outputs(out)]


def cotangents(outs):
    """A seeded cotangent of each float output (None for the masks and
    indices): a derived grad check's incoming grads, the same on every
    device."""
    return [None if o is None or o.dtype.kind != "f" else
            np.random.RandomState(100 + k).randn(*o.shape).astype(
                np.float32) for k, o in enumerate(outs)]


def outputs_close(got, want, tol):
    """Worst error of ``got`` against ``want`` (numpy lists): integer and
    tol-0 outputs must be equal (else inf); the others are read against
    tol x the reference's largest magnitude (at least 1).  Returns
    (worst ratio of error to its limit, worst absolute error)."""
    worst, worst_abs = 0.0, 0.0
    for g, w in zip(got, want):
        if g is None or w is None:
            if (g is None) != (w is None):
                return float("inf"), float("inf")
            continue
        if g.shape != w.shape:
            return float("inf"), float("inf")
        err = float(np.abs(g.astype(np.float64) - w).max()) if g.size \
            else 0.0
        if w.dtype.kind in "iub" or tol == 0:
            if err:
                return float("inf"), err
            continue
        worst_abs = max(worst_abs, err)
        worst = max(worst, err / (tol * max(float(np.abs(w).max()), 1.0)))
    return worst, worst_abs
