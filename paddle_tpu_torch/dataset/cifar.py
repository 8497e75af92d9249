"""CIFAR-shaped synthetic dataset (reference python/paddle/dataset/cifar.py).

Samples: (image: float32[3072] in [0,1], label: int64).
"""

from __future__ import annotations

import numpy as np

from . import common


def _make(n, n_classes, seed):
    feats, labels = common.class_blobs(n, n_classes, 3 * 32 * 32, seed,
                                       spread=0.4, noise=0.25)
    feats = (np.tanh(feats) + 1.0) / 2.0
    return [(feats[i].astype("float32"), int(labels[i])) for i in range(n)]


def train10():
    return common.make_reader(_make(1024, 10, seed=10))


def test10():
    return common.make_reader(_make(256, 10, seed=11))


def train100():
    return common.make_reader(_make(1024, 100, seed=12))


def test100():
    return common.make_reader(_make(256, 100, seed=13))
