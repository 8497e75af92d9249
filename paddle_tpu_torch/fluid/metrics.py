"""Host-side streaming metrics (counterpart of
``paddle_tpu/fluid/metrics.py``, which follows the reference's
python/paddle/fluid/metrics.py).

Numpy accumulators fed with fetched batch results, as in the reference:
m = fluid.metrics.Accuracy(); m.update(value=acc, weight=bs); m.eval().
The port keeps its own copy of the JAX package's module.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "Accuracy", "Precision", "Recall", "Auc",
           "EditDistance", "CompositeMetric"]


class MetricBase:
    def __init__(self, name=None):
        self._name = name or type(self).__name__

    def reset(self):
        raise NotImplementedError

    def update(self, *a, **kw):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError

    def get_config(self):
        return {"name": self._name}


class Accuracy(MetricBase):
    """Weighted mean of per-batch accuracies."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if weight < 0:
            raise ValueError("weight must be nonnegative")
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated: call update() first")
        return self.value / self.weight


class Precision(MetricBase):
    """Binary-classification precision over streamed (pred, label) batches."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = (np.asarray(preds).reshape(-1) > 0.5).astype("int64")
        labels = np.asarray(labels).reshape(-1).astype("int64")
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = (np.asarray(preds).reshape(-1) > 0.5).astype("int64")
        labels = np.asarray(labels).reshape(-1).astype("int64")
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0


class Auc(MetricBase):
    """Streaming ROC AUC via fixed histogram buckets (reference metrics.py Auc
    / operators/metrics/auc_op.cc use the same bucketed estimator)."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self._num_thresholds + 1, dtype="int64")
        self._stat_neg = np.zeros(self._num_thresholds + 1, dtype="int64")

    def update(self, preds, labels):
        preds = np.asarray(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = np.asarray(labels).reshape(-1)
        idx = np.clip((preds * self._num_thresholds).astype("int64"), 0,
                      self._num_thresholds)
        np.add.at(self._stat_pos, idx[labels == 1], 1)
        np.add.at(self._stat_neg, idx[labels == 0], 1)

    def eval(self):
        tot_pos = np.cumsum(self._stat_pos[::-1])
        tot_neg = np.cumsum(self._stat_neg[::-1])
        tp = tot_pos.astype("float64")
        fp = tot_neg.astype("float64")
        P = tp[-1]
        N = fp[-1]
        if P == 0 or N == 0:
            return 0.0
        # anchor the curve at the (0,0) origin: without it the sliver below
        # the first occupied bucket is dropped (e.g. all preds in one bucket)
        tpr = np.concatenate([[0.0], tp / P])
        fpr = np.concatenate([[0.0], fp / N])
        return float(np.trapezoid(tpr, fpr))


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num=None):
        d = np.asarray(distances).reshape(-1)
        self.total += float(d.sum())
        self.count += d.size
        self.seq_num += seq_num if seq_num is not None else d.size
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.count == 0:
            raise ValueError("no batches accumulated")
        return self.total / self.count, self.instance_error / max(1, self.seq_num)


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def reset(self):
        for m in self._metrics:
            m.reset()

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class ChunkEvaluator(MetricBase):
    """Streaming chunking precision/recall/F1 (reference metrics.py:410):
    feed per-batch chunk counts from layers.chunk_eval."""

    def __init__(self, name=None):
        super().__init__(name)
        self.reset()

    def reset(self):
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        def _to_int(v):
            return int(np.asarray(v).reshape(-1)[0])

        self.num_infer_chunks += _to_int(num_infer_chunks)
        self.num_label_chunks += _to_int(num_label_chunks)
        self.num_correct_chunks += _to_int(num_correct_chunks)

    def eval(self):
        precision = (self.num_correct_chunks / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (self.num_correct_chunks / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference metrics.py:695 — a
    graph helper over the detection_map op).  Accumulated on the host, as
    in the JAX package: detections and ground truth are numpy after the
    fetch, and VOC mAP is a sort-heavy reduction with data-dependent
    shapes.

    update() per image:
      detections: [M, 6] (label, score, xmin, ymin, xmax, ymax)
      gt_boxes:   [N, 4]
      gt_labels:  [N]
      difficult:  optional [N] bool (difficult GT is excluded, VOC-style)
    eval(map_type): 'integral' (VOC2010 AUC) or '11point'.
    """

    def __init__(self, name=None, overlap_threshold=0.5,
                 evaluate_difficult=False, class_num=None):
        """class_num (optional): when given, update() validates every
        label against [0, class_num) — mAP still averages over classes
        with ground truth, the VOC convention."""
        super().__init__(name)
        self.overlap_threshold = float(overlap_threshold)
        self.evaluate_difficult = bool(evaluate_difficult)
        self.class_num = int(class_num) if class_num is not None else None
        self.reset()

    def reset(self):
        self._dets = []   # (img_id, label, score, box)
        self._gts = []    # (img_id, label, box, difficult)
        self._img = 0

    def update(self, detections, gt_boxes, gt_labels, difficult=None):
        detections = np.asarray(detections, "float64").reshape(-1, 6)
        gt_boxes = np.asarray(gt_boxes, "float64").reshape(-1, 4)
        gt_labels = np.asarray(gt_labels).reshape(-1).astype(int)
        if difficult is None:
            difficult = np.zeros(len(gt_labels), bool)
        else:
            difficult = np.asarray(difficult).reshape(-1).astype(bool)
        if not (len(gt_boxes) == len(gt_labels) == len(difficult)):
            raise ValueError(
                f"gt_boxes({len(gt_boxes)}) / gt_labels({len(gt_labels)}) / "
                f"difficult({len(difficult)}) lengths disagree")
        if self.class_num is not None:
            bad = gt_labels[(gt_labels < 0) | (gt_labels >= self.class_num)]
            if bad.size or (detections.size and (
                    (detections[:, 0] < 0)
                    | (detections[:, 0] >= self.class_num)).any()):
                raise ValueError(
                    f"label outside [0, {self.class_num}) in update()")
        for d in detections:
            self._dets.append((self._img, int(d[0]), float(d[1]), d[2:6]))
        for box, lbl, diff in zip(gt_boxes, gt_labels, difficult):
            self._gts.append((self._img, int(lbl), box, bool(diff)))
        self._img += 1

    @staticmethod
    def _iou(a, b):
        ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
        iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        inter = ix * iy
        ua = ((a[2] - a[0]) * (a[3] - a[1])
              + (b[2] - b[0]) * (b[3] - b[1]) - inter)
        return inter / ua if ua > 0 else 0.0

    def _ap(self, recalls, precisions, map_type):
        if map_type == "11point":
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precisions[recalls >= t]
                ap += (p.max() if p.size else 0.0) / 11.0
            return ap
        # integral (VOC2010): area under the monotone precision envelope
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def eval(self, map_type="integral"):
        if map_type not in ("integral", "11point"):
            raise ValueError("map_type must be 'integral' or '11point'")
        labels = sorted({g[1] for g in self._gts}
                        | {d[1] for d in self._dets})
        aps = []
        for lbl in labels:
            gts = [g for g in self._gts if g[1] == lbl]
            npos = sum(1 for g in gts
                       if self.evaluate_difficult or not g[3])
            dets = sorted((d for d in self._dets if d[1] == lbl),
                          key=lambda d: -d[2])
            matched = set()
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, (img, _, _score, box) in enumerate(dets):
                cands = [(j, g) for j, g in enumerate(gts) if g[0] == img]
                best, best_iou = None, self.overlap_threshold
                for j, g in cands:
                    iou = self._iou(box, g[2])
                    if iou >= best_iou:
                        best, best_iou = j, iou
                if best is None:
                    fp[i] = 1
                elif not self.evaluate_difficult and gts[best][3]:
                    pass  # difficult GT: ignore the detection entirely
                elif best in matched:
                    fp[i] = 1
                else:
                    matched.add(best)
                    tp[i] = 1
            if npos == 0:
                continue
            ctp, cfp = np.cumsum(tp), np.cumsum(fp)
            recalls = ctp / npos
            precisions = ctp / np.maximum(ctp + cfp, 1e-12)
            aps.append(self._ap(recalls, precisions, map_type))
        return float(np.mean(aps)) if aps else 0.0
