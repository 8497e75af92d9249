"""VOC2012-shaped synthetic segmentation dataset (reference
python/paddle/dataset/voc2012.py).

Samples: (image: float32[3, H, W], label: int32[H, W] class per pixel) with
H = W = 64 (downscaled for test speed; the reference serves full-size VOC
images).  Labels are simple geometric regions so a small FCN can learn
them."""

from __future__ import annotations

import numpy as np

from . import common

N_CLASSES = 21
_HW = 64


def _make(n, seed):
    r = common.rng(seed)
    out = []
    for _ in range(n):
        img = r.uniform(0, 1, (3, _HW, _HW)).astype("float32")
        label = np.zeros((_HW, _HW), dtype="int32")
        # a colored rectangle per sample: pixels inside get the class,
        # image channels get shifted by it (learnable correspondence)
        cls = int(r.randint(1, N_CLASSES))
        x0, y0 = r.randint(0, _HW // 2, 2)
        w, h = r.randint(8, _HW // 2, 2)
        label[y0:y0 + h, x0:x0 + w] = cls
        img[:, y0:y0 + h, x0:x0 + w] += cls / N_CLASSES
        out.append((np.clip(img, 0, 2.0), label))
    return out


def train():
    return common.make_reader(_make(128, seed=90))


def test():
    return common.make_reader(_make(32, seed=91))


def val():
    return common.make_reader(_make(32, seed=92))
